"""Whole-image codestream encoder; counterpart of
grok_tpu/codestream/compress.py (build_siz, build_tcp, write_main_header,
encode_tile_to_blob, compress) for the ported slices: Part-1 (MQ) and
HTJ2K cleanup-only (``ht=True``), reversible 5/3 + RCT or irreversible
9/7 + ICT (``irreversible=True``, quantization style 2 or 1), any number
of quality layers with rate (``layer_rates``) or quality
(``layer_psnrs``) targets, allocated per tile by PCRD, the Part-2 array
MCT (``mct_matrix``: 9/7, Rsiz 0x8100, MCT/MCC/MCO markers) and the ROI
maxshift of one component (``roi_comp``/``roi_shift``: RGN).

Host-side orchestration: the main header, one TileProcessor per tile
(each drives the device work of its tile), tiles one after another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.errors import ParameterError, UnsupportedFeatureError
from ..core.image import Image
from ..core.params import CBLK_HT, CompressParams, QuantStyle
from ..core.rect import ceil_div
from ..core.timing import StageClock
from ..kernels import on_device
from ..ops.transform import MCT_MAX_COMPS, ROI_MAX_SHIFT
from ..tile.tile_processor import TileProcessor
from . import markers as mk
from .quantizer import compute_signalled_quant
from .structs import Siz, SizComponent, Tcp, TccpStyle


def check_supported(params: CompressParams) -> None:
    """Refuse every option outside the ported slices by name. ``custom_mct``
    is carried and never read, as in grok_tpu (its core/params.py:116);
    ``roi_shift`` acts only with ``roi_comp`` >= 0 and above 0."""
    roi = params.roi_comp >= 0 and params.roi_shift > 0
    n_mct = 0 if params.mct_matrix is None else len(params.mct_matrix)
    off = {
        "ht_refine (HT refinement passes)": params.ht and params.ht_refine,
        f"roi_shift above {ROI_MAX_SHIFT}": roi and params.roi_shift > ROI_MAX_SHIFT,
        f"mct_matrix of more than {MCT_MAX_COMPS} components": n_mct > MCT_MAX_COMPS,
        "precinct_sizes": params.precinct_sizes is not None,
        "progression_changes (POC)": bool(params.progression_changes),
        "tp_divider": params.tp_divider is not None,
        "use_sop": params.use_sop,
        "use_eph": params.use_eph,
        "write_tlm": params.write_tlm,
        "write_plt": params.write_plt,
        "write_plm": params.write_plm,
        "write_ppt": params.write_ppt,
        "write_ppm": params.write_ppm,
        "profile": params.profile != 0,
        "quant_style with the reversible transform": (
            not params.irreversible and params.quant_style not in (None, QuantStyle.NO_QUANT)),
        "quant_style 0 with the irreversible transform": (
            params.irreversible and params.quant_style == QuantStyle.NO_QUANT),
        "cblk_style bits above 0x3F": (params.cblk_style & ~0x3F) != 0,
    }
    bad = [k for k, v in off.items() if v]
    if bad:
        raise UnsupportedFeatureError(
            f"outside the ported slices: {', '.join(bad)}")


def build_siz(image: Image, params: CompressParams) -> Siz:
    siz = Siz()
    siz.rsiz = params.profile
    siz.x0, siz.y0 = image.x0, image.y0
    siz.x1, siz.y1 = image.x1, image.y1
    if params.tile_size is None:
        # single tile anchored at the grid origin, spanning the canvas
        siz.tile_x0, siz.tile_y0 = 0, 0
        siz.tile_w = image.x1
        siz.tile_h = image.y1
    else:
        siz.tile_x0, siz.tile_y0 = params.tile_offset
        siz.tile_w, siz.tile_h = params.tile_size
    for c in image.components:
        siz.comps.append(SizComponent(dx=c.dx, dy=c.dy, prec=c.prec, signed=c.signed))
    if siz.num_tiles > 65535:
        raise ParameterError(
            f"tile grid {siz.num_tiles_x}x{siz.num_tiles_y} exceeds the "
            "65535-tile limit (T.800: SOT's Isot is 16-bit)")
    return siz


def build_tcp(image: Image, params: CompressParams) -> Tcp:
    tcp = Tcp()
    tcp.progression = params.progression
    tcp.num_layers = params.num_layers
    cs = image.components
    equal = len(cs) >= 3 and all((c.dx, c.dy) == (cs[0].dx, cs[0].dy) for c in cs[:3])
    if params.mct_matrix is not None:
        # the Part-2 array MCT (grok_tpu/codestream/compress.py:61-71): the
        # stream carries the inverse of the user's matrix and each
        # component's DC level as its offset
        tcp.mct = 2
        tcp.mct_enc_matrix = np.asarray(params.mct_matrix, dtype=np.float64)
        tcp.mct_dec_matrix = np.linalg.inv(tcp.mct_enc_matrix)
        tcp.mct_offsets = [0.0 if c.signed else float(1 << (c.prec - 1)) for c in cs]
    else:
        tcp.mct = 1 if params.resolved_mct(image.num_comps, equal) else 0
    qs = params.quant_style
    if qs is None:
        qs = QuantStyle.SCALAR_EXPOUNDED if params.irreversible else QuantStyle.NO_QUANT
    for c in range(image.num_comps):
        t = TccpStyle(
            num_resolutions=params.num_resolutions,
            cblk_w_exp=params.cblk_width.bit_length() - 1,
            cblk_h_exp=params.cblk_height.bit_length() - 1,
            cblk_style=params.cblk_style | (CBLK_HT if params.ht else 0),
            guard_bits=params.guard_bits,
            irreversible=params.irreversible,
            quant_style=qs,
        )
        prec = image.components[c].prec
        if tcp.mct == 1 and not params.irreversible and c in (1, 2):
            prec += 1  # RCT expands the chroma range by one bit; ICT does not
        if params.roi_comp == c and params.roi_shift > 0:
            t.roi_shift = params.roi_shift  # Mb grows by the shift (E.1.1)
        compute_signalled_quant(t, prec)
        tcp.tccps.append(t)
    return tcp


def write_main_header(siz: Siz, tcp: Tcp, params: CompressParams) -> bytearray:
    """Main header SOC, SIZ, CAP (HT), COD, QCD, QCCs, MCT/MCC/MCO (Part-2
    MCT), RGN (ROI), COM."""
    out = bytearray()
    out += mk._u16(mk.SOC)
    out += mk.write_siz(siz)
    if params.ht:
        # CAP: Pcap bit for Part 15, Ccap15 from MAGB (T.814 A.3); grok_tpu
        # masks the irreversible bit (0x20) off for 9/7 too, so it stays clear
        magb = max(max(t.step_exps) + t.guard_bits - 1 for t in tcp.tccps)
        if magb <= 8:
            bp = 0
        elif magb < 28:
            bp = magb - 8
        elif magb < 48:
            bp = 13 + (magb >> 2)
        else:
            bp = 31
        out += mk.write_cap(0x00020000, [bp])
    out += mk.write_cod(tcp)
    out += mk.write_qcd(tcp)
    base = tcp.tccps[0]
    for c in range(1, siz.num_comps):
        t = tcp.tccps[c]
        if t.step_exps != base.step_exps or t.step_mants != base.step_mants:
            out += mk.write_qcc(tcp, c, siz.num_comps)
    if tcp.mct == 2:
        out += mk.write_mct_markers(tcp.mct_dec_matrix, tcp.mct_offsets)
    if params.roi_comp >= 0 and params.roi_shift > 0:
        # written for roi_comp past the last component too, as grok_tpu does
        out += mk.write_rgn(params.roi_comp, params.roi_shift, siz.num_comps)
    if params.comment:
        out += mk.write_com(params.comment.encode())
    return out


def _extract_tile(image: Image, siz: Siz, tile_index: int) -> list[np.ndarray]:
    tb = siz.tile_bounds(tile_index)
    arrays = []
    for c in image.components:
        x0 = ceil_div(tb.x0, c.dx) - c.x0
        y0 = ceil_div(tb.y0, c.dy) - c.y0
        x1 = ceil_div(tb.x1, c.dx) - c.x0
        y1 = ceil_div(tb.y1, c.dy) - c.y0
        arrays.append(c.data[y0:y1, x0:x1])
    return arrays


def encode_tile_to_blob(siz: Siz, tcp: Tcp, ti: int, comp_arrays: list[np.ndarray] | None,
                        device: torch.device | None = None, clock: StageClock | None = None,
                        params: CompressParams | None = None,
                        coeffs: list[torch.Tensor] | None = None) -> bytes:
    """Encode one tile into its SOT..body blob (one tile-part); ``params``
    carry the rate or quality targets. With ``coeffs`` (the tile's packed
    int32 coefficient planes, transformed elsewhere: a shard of the mesh,
    or the sharded strip through its layout bridge) the tile is
    entropy-coded on the coefficients' device and ``comp_arrays`` is not
    read."""
    if coeffs is not None:
        device = coeffs[0].device
    tp = TileProcessor(siz, tcp, ti, device, params)
    with on_device(tp.device):
        body = tp.compress(comp_arrays, clock, coeffs=coeffs)
    psot = 12 + 2 + len(body)
    return mk.write_sot(ti, psot, 0, 1) + mk._u16(mk.SOD) + body


def resolve_device(device, entry: str = "compress") -> torch.device:
    """``device`` or, when None, the current CUDA device; never a silent
    CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"grok_tpu_torch.{entry} runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def compress(image: Image, params: CompressParams | None = None, device=None,
             stage_ms: dict[str, float] | None = None, tile_coeff_fn=None) -> bytes:
    """Encode an Image to a raw .j2k codestream on ``device`` (default: the
    current CUDA device). With ``stage_ms`` (a dict) the device is
    synchronised between stages and their milliseconds are added there,
    with the count of rate control's packet simulations under
    ``pcrd_simulations``.

    ``tile_coeff_fn(tile_index)`` may supply a tile's packed coefficient
    planes, transformed on a shard of a mesh (the distributed encode,
    grok_tpu/codestream/compress.py:156-222); that tile is entropy-coded
    on the planes' device, and a tile it returns None for takes the
    ordinary path on ``device``. T2 and the assembly stay on the host, in
    tile order."""
    params = params or CompressParams()
    if params.mct_matrix is not None:
        # the Part-2 MCT takes the irreversible path (grok_tpu sets the
        # caller's field; the port leaves the caller's object as it is)
        params = dataclasses.replace(params, irreversible=True)
    params.validate()
    check_supported(params)
    dev = resolve_device(device)
    clock = StageClock(dev, stage_ms)
    # the canvas origin is the Image's (x0, y0); params.image_offset is
    # carried but not applied, as in grok_tpu
    image.finalize()
    siz = build_siz(image, params)
    tcp = build_tcp(image, params)
    if params.ht:
        siz.rsiz |= 0x4000  # Part-15 capabilities in Rsiz (see CAP)
    if tcp.mct == 2:
        siz.rsiz |= 0x8100  # Part 2 with the array MCT extension
    for ti in range(siz.num_tiles):
        if siz.tile_bounds(ti).empty():
            raise ParameterError(f"tile {ti} empty")
    out = write_main_header(siz, tcp, params)
    clock.mark("markers")
    for ti in range(siz.num_tiles):
        coeffs = tile_coeff_fn(ti) if tile_coeff_fn is not None else None
        out += encode_tile_to_blob(siz, tcp, ti,
                                   None if coeffs is not None else _extract_tile(image, siz, ti),
                                   dev, clock, params, coeffs=coeffs)
    out += mk._u16(mk.EOC)
    return bytes(out)
