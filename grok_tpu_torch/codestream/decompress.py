"""Whole-image codestream decoder for the ported slices, Part-1 (MQ) and
HTJ2K, reversible 5/3 or irreversible 9/7, with the Part-2 array MCT (MCT
markers; MCC and MCO are not read, as in the reference) and ROI (RGN in
main and tile-part headers); counterpart of
grok_tpu/codestream/decompress.py (Decoder: main header, tile-part walk,
_paste_tile :366-399; decompress :403).

Host-side orchestration: the main header, the tile-part index and each
tile-part header are parsed here; one TileProcessor per tile drives its
device work, tiles one after another. ``DecompressParams.max_layers``
limits the decode to the first quality layers. Streams outside the slices
(precincts, SOP/EPH, POC, packed headers, length markers, mixed HT and
Part-1 codeblocks, a Part-2 MCT without its matrix or on 5/3) and the
other non-default DecompressParams are refused by name. A corrupt or
truncated tile decodes as far as its intact packets go, or as an empty
tile.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.errors import (CodestreamError, GrokTpuError, InvalidMarkerError,
                           UnsupportedFeatureError)
from ..core.image import Component, Image
from ..core.params import CBLK_HT, ColorSpace, DecompressParams
from ..core.rect import ceil_div
from ..core.timing import StageClock
from ..kernels import on_device
from ..ops.transform import ROI_MAX_SHIFT
from ..tile.tile_processor import TileProcessor
from . import markers as mk
from .compress import resolve_device
from .structs import HeaderInfo, Tcp


DECODE_FIELDS = ("max_layers",)  # the DecompressParams fields the port honours


def check_params(params: DecompressParams) -> None:
    """Refuse every other non-default DecompressParams field by name."""
    bad = [f.name for f in dataclasses.fields(DecompressParams)
           if f.name not in DECODE_FIELDS and getattr(params, f.name) != f.default]
    if bad:
        raise UnsupportedFeatureError(
            f"outside the ported decode slice: DecompressParams {', '.join(bad)}")


def check_decodable(tcp: Tcp) -> None:
    """Refuse coding styles outside the decode slices by name."""
    off = {
        "mixed HT / Part-1 codeblocks": (any(t.cblk_style & 0x80 for t in tcp.tccps)
                                         or len({t.cblk_style & CBLK_HT
                                                 for t in tcp.tccps}) > 1),
        "precinct sizes": any(t.precinct_exps is not None for t in tcp.tccps),
        "SOP/EPH markers": bool(tcp.csty & 0x06),
        f"MCT {tcp.mct}": tcp.mct not in (0, 1, 2),
        "MCT 2 with the 5/3 transform": tcp.mct == 2 and not tcp.tccps[0].irreversible,
        "MCT 2 without an N x N decorrelation array": (tcp.mct == 2
                                                       and tcp.mct_dec_matrix is None),
        f"RGN shift above {ROI_MAX_SHIFT}": any(t.roi_shift > ROI_MAX_SHIFT
                                                for t in tcp.tccps),
    }
    bad = [k for k, v in off.items() if v]
    if bad:
        raise UnsupportedFeatureError(f"outside the ported decode slice: {', '.join(bad)}")


def _valid_sot_at(data, pos: int, num_tiles: int) -> bool:
    """Plausibility check for an SOT marker segment at ``pos``."""
    if pos + 12 > len(data):
        return False
    c = mk.Cursor(data, pos)
    if c.u16() != mk.SOT or c.u16() != 10:
        return False
    ti, psot, tpi, tn = mk.read_sot(c)
    return ti < num_tiles and (psot == 0 or psot >= 14) and (tn == 0 or tpi < tn)


_RESYNC_FWD_WINDOW = 8 << 20  # bounds the forward scan on adversarial streams


def _resync_sot(data, body_start: int, end: int, num_tiles: int) -> int | None:
    """The real start of the next tile-part when Psot lied: the valid SOT
    nearest before ``end`` within 64 bytes, else the first after it within
    a bounded window (grok_tpu/cache/length_cache.py _resync_sot)."""
    lo = max(body_start, end - 64)
    b = bytes(data[lo:min(len(data), end)])
    for rel in range(len(b) - 2, -1, -1):
        if b[rel] == 0xFF and b[rel + 1] == 0x90 and _valid_sot_at(data, lo + rel, num_tiles):
            return lo + rel
    pos = end
    hi = min(len(data), end + _RESYNC_FWD_WINDOW)
    while pos + 2 <= hi:
        nxt = bytes(data[pos:min(hi, pos + 65536)]).find(b"\xff\x90")
        if nxt < 0:
            pos += 65536 - 1
            continue
        if _valid_sot_at(data, pos + nxt, num_tiles):
            return pos + nxt
        pos += nxt + 2
    return None


def index_tile_parts(data, first_sot: int,
                     num_tiles: int) -> dict[int, list[tuple[int, int, int]]]:
    """{tile: [(tp_index, sot_offset, body_end)]} by walking the SOT
    markers, resynchronising on the next valid SOT where Psot lies (the
    reference's index_by_scan, grok_tpu/cache/length_cache.py:117)."""
    spans: dict[int, list[tuple[int, int, int]]] = {}
    c = mk.Cursor(data, first_sot)
    while c.remaining() >= 2:
        m = c.u16()
        if m == mk.EOC:
            break
        if m != mk.SOT:
            raise CodestreamError(f"expected SOT, found 0x{m:04X}")
        sot = c.pos - 2
        c.u16()
        ti, psot, tpi, _ = mk.read_sot(c)
        while c.u16() != mk.SOD:  # the tile-part header
            ln = c.u16()
            c.pos += ln - 2
        end = min(sot + psot, len(data)) if psot else len(data)
        if end + 2 <= len(data) and ((data[end] << 8) | data[end + 1]) not in (mk.SOT, mk.EOC):
            fixed = _resync_sot(data, c.pos, end, num_tiles)
            if fixed is None:
                end = len(data)
            elif fixed >= c.pos:  # an empty body is valid; never cut the header
                end = fixed
        spans.setdefault(ti, []).append((tpi, sot, end))
        c.pos = end
    return spans


def read_tile_headers(data, header: HeaderInfo,
                      spans: list[tuple[int, int, int]]) -> tuple[Tcp, bytes]:
    """A tile's coding parameters (the main header's, updated by its
    tile-part headers) and its body, the tile-parts' data in order."""
    tcp = header.default_tcp.copy()
    bodies = []
    for _tpi, sot, end in sorted(spans):
        c = mk.Cursor(data, sot + 4)
        mk.read_sot(c)
        while True:
            m = c.u16()
            if m == mk.SOD:
                break
            if m < 0xFF00:
                raise InvalidMarkerError("bad marker in tile-part header")
            ln = c.u16()
            mk.read_tile_marker(m, mk.Cursor(c.data, c.pos, c.pos + ln - 2), tcp,
                                header.siz.num_comps)
            c.pos += ln - 2
        bodies.append(bytes(data[c.pos:end]))
    return tcp, b"".join(bodies)


def _make_image(header: HeaderInfo) -> Image:
    siz = header.siz
    img = Image(siz.x0, siz.y0, siz.x1, siz.y1, color_space=ColorSpace.UNKNOWN)
    img.components = [Component(dx=sc.dx, dy=sc.dy, prec=sc.prec, signed=sc.signed)
                      for sc in siz.comps]
    img.finalize()
    for c in img.components:
        # a tile without data (or with a corrupt tile index) holds the value
        # of all-zero coefficients
        c.data = np.full((c.h, c.w), 0 if c.signed else 1 << (c.prec - 1), dtype=np.int32)
    return img


def _paste_tile(img: Image, header: HeaderInfo, tile_index: int, arrays) -> None:
    tb = header.siz.tile_bounds(tile_index)
    for c, sc, a in zip(img.components, header.siz.comps, arrays):
        x0 = ceil_div(tb.x0, sc.dx) - c.x0
        y0 = ceil_div(tb.y0, sc.dy) - c.y0
        sy0, sx0 = max(0, -y0), max(0, -x0)
        dy0, dx0 = max(0, y0), max(0, x0)
        h = min(a.shape[0] - sy0, c.h - dy0)
        w = min(a.shape[1] - sx0, c.w - dx0)
        if h > 0 and w > 0:
            c.data[dy0:dy0 + h, dx0:dx0 + w] = a[sy0:sy0 + h, sx0:sx0 + w]


class Decoder:
    """One codestream: the main header and the tile-part index are parsed
    once, then each tile's headers and body on demand (the reference's
    Decoder, grok_tpu/codestream/decompress.py:42; _parse_tile_headers
    :99; decompress :256-320). Runs on ``device`` (default: the current
    CUDA device)."""

    def __init__(self, data, params: DecompressParams | None = None, device=None,
                 stage_ms: dict[str, float] | None = None):
        self.params = params or DecompressParams()
        check_params(self.params)
        self.device = resolve_device(device, "decompress")
        self.clock = StageClock(self.device, stage_ms)
        self.data = memoryview(bytes(data))
        self.header, first_sot = mk.parse_main_header(self.data)
        check_decodable(self.header.default_tcp)
        self.spans = index_tile_parts(self.data, first_sot, self.header.siz.num_tiles)

    def _parse_tile_headers(self, ti: int) -> tuple[Tcp, bytes]:
        """A tile's coding parameters and body; refuses by name a coding
        style outside the decode slices."""
        tcp, body = read_tile_headers(self.data, self.header, self.spans[ti])
        check_decodable(tcp)
        return tcp, body

    def decompress(self, tile_arrays_fn=None) -> Image:
        """Decode every tile into an Image. ``tile_arrays_fn(tile_index)``
        may supply a tile's per-component sample arrays (the distributed
        decode's hook, mirroring compress's tile_coeff_fn); a tile it
        returns None for takes the ordinary path."""
        siz, clock = self.header.siz, self.clock
        img = _make_image(self.header)
        clock.mark("markers")
        for ti in range(siz.num_tiles):
            if ti not in self.spans:
                continue
            arrays = tile_arrays_fn(ti) if tile_arrays_fn is not None else None
            if arrays is None:
                try:
                    tcp, body = self._parse_tile_headers(ti)
                    clock.mark("markers")
                    with on_device(self.device):
                        planes = TileProcessor(siz, tcp, ti, self.device).decompress(
                            body, clock, self.params.max_layers)
                    arrays = [p.cpu().numpy() for p in planes]
                except UnsupportedFeatureError:
                    raise  # a feature refused by name is not corruption
                except (GrokTpuError, ValueError, IndexError, OverflowError):
                    # corrupt-tile tolerance (grok_tpu/codestream/decompress.py:
                    # 180-201): a broken tile decodes as an empty one, the DC
                    # level _make_image filled in. A CUDA launch error is a
                    # RuntimeError and is never caught.
                    continue
            clock.mark("to_host")
            _paste_tile(img, self.header, ti, arrays)
        return img


def decompress(data, params: DecompressParams | None = None, device=None,
               stage_ms: dict[str, float] | None = None) -> Image:
    """Decode a raw .j2k Part-1 or HTJ2K codestream into an Image on
    ``device`` (default: the current CUDA device). With ``stage_ms`` (a
    dict) the device is synchronised between stages and their milliseconds
    are added there: markers, t2, upload, t1_dec (Part-1) or t1_ht_dec
    (HT), scatter, inverse, to_host."""
    return Decoder(data, params, device, stage_ms).decompress()
