"""Per-tile pipelines. Encode: transform (5/3, or 9/7 and quantization)
-> codeblock gather -> T1 -> T2; decode (Part-1 and HT): T2 -> T1 ->
codeblock scatter -> inverse transform (5/3, or dequantization and 9/7).

Counterpart of grok_tpu/tile/tile_processor.py: the device branch of
compress (:249-279), _entropy_and_t2 (:400) with its HT branch
(:492-538) and the Python _emit_packets (:655) for one quality layer
without rate control (every pass of every codeblock goes into the single
layer); and decompress (:1303) over the object T2 path
_decompress_t1_objects (:1154, layer limits and the merge of segment
pieces included) with the device inverse chain (:1422-1442).

The coefficients stay on the device from the transform through the
gather and the T1 kernels; only the codeblock bytes, lengths, pass rates
and plane counts come back to the host, for T2. On decode the segments
go up once (Part-1: back to back in one buffer; HT: padded rows) and the
decoded samples come back once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codestream.quantizer import apply_band_quant
from ..codestream.structs import Siz, Tcp
from ..core.errors import UnsupportedFeatureError
from ..core.params import CBLK_HT
from ..core.rect import Rect, ceil_div
from ..core.timing import StageClock
from ..ops.transform import forward_transform, inverse_transform
from ..t1 import ebcot_cuda, ht_cuda
from ..t1.ebcot_dec import SEGMENTED
from ..t2.packets import (CblkDec, CblkEnc, PrecinctCtx, decode_packet, encode_packet,
                          merge_segments)
from ..t2.progression import packet_order
from .geometry import BAND_LL, TileCompGeom, cached_tile_comp_geometry


def _band_origin_in_packed(geom: TileCompGeom, res_idx: int, orient: int):
    """Top-left of a band's data inside the Mallat-packed tile array."""
    if orient == BAND_LL:
        return 0, 0
    prev = geom.resolutions[res_idx - 1].rect
    if orient == 1:  # HL
        return 0, prev.width
    if orient == 2:  # LH
        return prev.height, 0
    return prev.height, prev.width  # HH


def _repair_pass_rates(pass_rates: np.ndarray, npasses: np.ndarray) -> None:
    """Suffix-min monotone repair of the conservative pass rates, in place
    (T2 segment lengths are differences of rates, so they must not drop)."""
    if pass_rates.size == 0:
        return
    cols = np.arange(pass_rates.shape[1])
    pad = cols[None, :] >= npasses[:, None]
    big = np.iinfo(pass_rates.dtype).max
    work = np.where(pad, big, pass_rates)
    work = np.minimum.accumulate(work[:, ::-1], axis=1)[:, ::-1]
    pass_rates[...] = np.where(pad, pass_rates, work)


def _block_index(base, stride, heights, widths, bh: int,
                 bw: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat sample index of every position of a [n, bh, bw] codeblock batch
    in the concatenated component planes (codeblock i's top-left sample at
    base[i], rows stride[i] apart), and whether it lies inside its
    codeblock."""
    ys = torch.arange(bh, device=base.device)[None, :, None]
    xs = torch.arange(bw, device=base.device)[None, None, :]
    idx = base[:, None, None] + ys * stride[:, None, None] + xs
    inside = (ys < heights[:, None, None]) & (xs < widths[:, None, None])
    return idx, inside


@dataclass
class _CblkRef:
    comp: int
    res: int
    band_i: int
    prec: int
    cblk_i: int


@dataclass
class _GatherPlan:
    """Codeblock layout of one tile: per-lane refs and the device tensors
    the gather indexes with."""

    refs: list[_CblkRef]
    base: torch.Tensor  # [n] flat offset of the block's top-left sample
    stride: torch.Tensor  # [n] row stride of its component plane
    heights: torch.Tensor  # [n]
    widths: torch.Tensor  # [n]
    orients: torch.Tensor  # [n]
    styles: torch.Tensor  # [n]


class TileProcessor:
    def __init__(self, siz: Siz, tcp: Tcp, tile_index: int, device: torch.device):
        self.siz = siz
        self.tcp = tcp
        self.device = torch.device(device)
        self.tile_index = tile_index
        self.tile_rect = siz.tile_bounds(tile_index)
        self.geoms: list[TileCompGeom] = []
        for c in range(siz.num_comps):
            comp = siz.comps[c]
            tc = Rect(
                ceil_div(self.tile_rect.x0, comp.dx),
                ceil_div(self.tile_rect.y0, comp.dy),
                ceil_div(self.tile_rect.x1, comp.dx),
                ceil_div(self.tile_rect.y1, comp.dy),
            )
            g, _key = cached_tile_comp_geometry(c, tc, tcp.tccps[c])
            self.geoms.append(g)

    # ------------------------------------------------------------ encode
    def compress(self, comp_arrays: list[np.ndarray],
                 clock: StageClock | None = None) -> bytes:
        """comp_arrays: per-component int32 tile data (natural range).
        Returns the tile body: its packets in progression order."""
        clock = clock or StageClock(self.device, None)
        siz, tcp = self.siz, self.tcp
        self._apply_band_quant()
        planes = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)
                  for a in comp_arrays]
        clock.mark("upload")
        dcs = [0 if c.signed else 1 << (c.prec - 1) for c in siz.comps]
        coeffs = forward_transform(
            planes, [g.rect for g in self.geoms],
            [t.num_resolutions - 1 for t in tcp.tccps], dcs, self._mct(),
            self.irreversible, self.band_tables() if self.irreversible else None)
        clock.mark("transform")
        return self._entropy_and_t2(coeffs, clock)

    @property
    def irreversible(self) -> bool:
        """9/7 for every component when the first component's style says so
        (the reference's tile_processor reads tccps[0] too)."""
        return self.tcp.tccps[0].irreversible

    def _mct(self) -> bool:
        return self.tcp.mct == 1 and self.siz.num_comps >= 3

    def _apply_band_quant(self) -> None:
        """Each band's Mb and step; RCT (never ICT) widens chroma by a bit
        (the reference's _comp_prec, :196)."""
        for c, (g, t) in enumerate(zip(self.geoms, self.tcp.tccps)):
            prec = self.siz.comps[c].prec
            if self.tcp.mct == 1 and not t.irreversible and c in (1, 2):
                prec += 1
            apply_band_quant(g, t, prec)

    def band_tables(self) -> list[list[tuple[int, int, int, int, float]]]:
        """Per component, (oy, ox, h, w, step) of each band in the packed
        plane: what K-l and K-m quantize and dequantize."""
        return [[(*_band_origin_in_packed(g, res.r, band.orient), band.rect.height,
                  band.rect.width, band.step) for res in g.resolutions for band in res.bands]
                for g in self.geoms]

    def gather_plan(self) -> _GatherPlan:
        refs: list[_CblkRef] = []
        cols: list[tuple[int, int, int, int, int, int]] = []
        offset = 0
        for c, g in enumerate(self.geoms):
            pw = g.rect.width
            style = self.tcp.tccps[c].cblk_style & 0x7F
            for res in g.resolutions:
                for bi, band in enumerate(res.bands):
                    oy, ox = _band_origin_in_packed(g, res.r, band.orient)
                    for pi, prc in enumerate(band.precincts):
                        for ci, cg in enumerate(prc.cblks):
                            refs.append(_CblkRef(c, res.r, bi, pi, ci))
                            r = cg.rect
                            y0 = r.y0 - band.rect.y0 + oy
                            x0 = r.x0 - band.rect.x0 + ox
                            cols.append((offset + y0 * pw + x0, pw,
                                         r.height, r.width, band.orient, style))
            offset += g.rect.area
        t = torch.tensor(cols, dtype=torch.int64).reshape(-1, 6).T.contiguous().to(self.device)
        return _GatherPlan(refs, *t)

    def gather(self, coeffs: list[torch.Tensor], plan: _GatherPlan) -> torch.Tensor:
        """Codeblock batch [n, bh, bw] int32 by one indexed read from the
        concatenated planes; samples outside a block read a zero sentinel.
        bh x bw is the largest block of the tile (at most the nominal
        size): positions outside every block code nothing."""
        cbh = max(int(plan.heights.max()), 1)
        cbw = max(int(plan.widths.max()), 1)
        flat = torch.cat([c.reshape(-1) for c in coeffs]
                         + [torch.zeros(1, dtype=torch.int32, device=self.device)])
        idx, inside = _block_index(plan.base, plan.stride, plan.heights, plan.widths,
                                   cbh, cbw)
        return flat[torch.where(inside, idx, flat.numel() - 1)]

    def _needs_pass_dist(self) -> bool:
        """Whether a layer allocation reads per-pass distortions (the
        reference's _needs_pass_dist, :753): only with several layers, as
        rate and PSNR targets are outside the slices."""
        return self.tcp.num_layers != 1

    def _entropy_and_t2(self, coeffs: list[torch.Tensor], clock: StageClock):
        plan = self.gather_plan()
        if not plan.refs:
            return b""
        batch = self.gather(coeffs, plan)
        clock.mark("gather")
        use_ht = bool(self.tcp.tccps[0].cblk_style & CBLK_HT)
        if use_ht:
            res = ht_cuda.encode_cblks(batch, plan.heights, plan.widths, clock=clock)
        else:
            res = ebcot_cuda.encode_cblks(batch, plan.heights, plan.widths, plan.orients,
                               styles=plan.styles, clock=clock,
                               want_dist=self._needs_pass_dist())
        maxlen = int(res.lengths.max())
        data = res.data[:, :maxlen].cpu().numpy()
        lengths = res.lengths.cpu().numpy()
        rates = res.pass_rates.cpu().numpy()
        numbps = res.numbps.cpu().numpy()
        npasses = res.npasses.cpu().numpy()
        clock.mark("to_host")
        if not use_ht:  # an HT codeblock has one pass: nothing to repair
            _repair_pass_rates(rates, npasses)
        out = self._emit_packets(plan.refs, data, lengths, rates, numbps, npasses)
        clock.mark("t2")
        return out

    def _emit_packets(self, refs, data, lengths, rates, numbps, npasses):
        """T2 for one layer holding every pass: per-precinct header state,
        then packets in progression order."""
        siz, tcp = self.siz, self.tcp
        prc_ctx_map: dict[tuple[int, int, int, int], PrecinctCtx] = {}
        for c in range(siz.num_comps):
            for res in self.geoms[c].resolutions:
                for bi, band in enumerate(res.bands):
                    for pi, prc in enumerate(band.precincts):
                        prc_ctx_map[(c, res.r, bi, pi)] = PrecinctCtx(band, prc)
        for i, ref in enumerate(refs):
            k = int(npasses[i])
            nbytes = int(rates[i, k - 1]) if k > 0 else 0
            cb = CblkEnc(
                data=data[i],
                total_len=int(lengths[i]),
                npasses=k,
                numbps=int(numbps[i]),
                layer_passes=[k],
                layer_bytes=[nbytes],
                first_layer=0 if k > 0 else 1,
                style=int(tcp.tccps[ref.comp].cblk_style) & 0x3F,
                pass_rates=rates[i],
            )
            prc_ctx_map[(ref.comp, ref.res, ref.band_i, ref.prec)].cblks[ref.cblk_i] = cb
        for ctx in prc_ctx_map.values():
            ctx.set_encoder_trees(tcp.num_layers)
        parts: list[bytes] = []
        for pk in packet_order(siz, tcp, self.geoms, self.tile_rect):
            res = self.geoms[pk.comp].resolutions[pk.res]
            ctxs = [prc_ctx_map[(pk.comp, pk.res, bi, pk.prec)]
                    for bi in range(len(res.bands))]
            parts.append(encode_packet(ctxs, pk.layer))
        return b"".join(parts)

    # ------------------------------------------------------------ decode
    def decompress(self, body, clock: StageClock | None = None,
                   max_layers: int = 0) -> list[torch.Tensor]:
        """Decode a tile body (its packets) into per-component int32 sample
        planes on the device. ``max_layers`` > 0 keeps the passes of the
        first that many quality layers only (the reference's
        _decompress_t1_objects, :1176-1198: packets of later layers are
        parsed and dropped, and reading stops after the last wanted one)."""
        clock = clock or StageClock(self.device, None)
        siz, tcp = self.siz, self.tcp
        self._apply_band_quant()

        # ---- T2: parse the packets (the object path of the reference)
        prc_ctx_map: dict[tuple[int, int, int, int], PrecinctCtx] = {}
        for c, g in enumerate(self.geoms):
            style = tcp.tccps[c].cblk_style & 0x7F
            for res in g.resolutions:
                for bi, band in enumerate(res.bands):
                    for pi, prc in enumerate(band.precincts):
                        ctx = PrecinctCtx(band, prc)
                        ctx.cblks = [CblkDec(style=style) for _ in prc.cblks]
                        prc_ctx_map[(c, res.r, bi, pi)] = ctx
        def wanted(pk) -> bool:
            return not max_layers or pk.layer < max_layers

        order = list(packet_order(siz, tcp, self.geoms, self.tile_rect))
        last = max((i for i, pk in enumerate(order) if wanted(pk)), default=-1)
        pos = 0
        for pk in order[:last + 1]:
            if pos >= len(body):
                break  # truncated stream: the remaining packets are empty
            res = self.geoms[pk.comp].resolutions[pk.res]
            pos, whole = decode_packet(body, pos, [prc_ctx_map[(pk.comp, pk.res, bi, pk.prec)]
                                                   for bi in range(len(res.bands))], pk.layer,
                                       drop=not wanted(pk))
            if not whole:
                break  # corrupt or truncated: keep the intact prefix

        # ---- the codeblocks that carry data; the others decode to zeros
        use_ht = bool(tcp.tccps[0].cblk_style & CBLK_HT)
        offsets = np.cumsum([0] + [g.rect.area for g in self.geoms])
        segs: list[bytes] = []
        cols: list[tuple[int, ...]] = []
        merged: list[list[int]] = []
        for (c, r, bi, pi), ctx in prc_ctx_map.items():
            g = self.geoms[c]
            band = g.resolutions[r].bands[bi]
            oy, ox = _band_origin_in_packed(g, r, band.orient)
            for cg, cb in zip(ctx.prc.cblks, ctx.cblks):
                if cb.npasses == 0 or cg.rect.empty():
                    continue
                if use_ht and (cb.npasses > 1 or cb.numbps > 1):
                    raise UnsupportedFeatureError(
                        "outside the ported slices: HT refinement passes")
                y0 = cg.rect.y0 - band.rect.y0 + oy
                x0 = cg.rect.x0 - band.rect.x0 + ox
                seg = b"".join(cb.segments)
                segs.append(seg)
                cols.append((int(offsets[c]) + y0 * g.rect.width + x0, g.rect.width,
                             cg.rect.height, cg.rect.width, cb.numbps, cb.npasses,
                             band.orient, cb.style & 0x3F, len(seg)))
                merged.append(merge_segments(cb.style, [len(p) for p in cb.segments],
                                             cb.seg_passes)
                              if cb.style & SEGMENTED else [])
        clock.mark("t2")

        flat = torch.zeros(int(offsets[-1]) + 1, dtype=torch.int32, device=self.device)
        if segs:
            t = np.array(cols, dtype=np.int64).T
            bh, bw = int(t[2].max()), int(t[3].max())
            base, stride, heights, widths = (torch.from_numpy(v).to(self.device) for v in t[:4])
            if use_ht:
                data = np.zeros((len(segs), max(max(len(s) for s in segs), 2)), dtype=np.uint8)
                for i, s in enumerate(segs):
                    data[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
                data_t = torch.from_numpy(data).to(self.device)
                lens = torch.from_numpy(t[8]).to(self.device)
                clock.mark("upload")
                out = ht_cuda.decode_cleanup_batch(data_t, lens, heights, widths, bh, bw,
                                                   clock=clock)
            else:
                seg_arr = np.zeros((len(segs), max(max(map(len, merged)), 1)), dtype=np.int32)
                for i, m in enumerate(merged):
                    seg_arr[i, :len(m)] = m
                lanes = t[[4, 5, 2, 3, 6, 7, 8]].astype(np.int32)  # t1.ebcot_dec.LANE_ROWS
                data = np.frombuffer(b"".join(segs) or b"\0", dtype=np.uint8)
                data_t, starts, lanes_t, seg_t = (
                    torch.from_numpy(a.copy()).to(self.device)
                    for a in (data, np.cumsum(t[8]) - t[8], lanes, seg_arr))
                clock.mark("upload")
                out, _ = ebcot_cuda.decode_cblks(data_t, starts, lanes_t, seg_t, bh, bw,
                                                 clock=clock)
            idx, inside = _block_index(base, stride, heights, widths, bh, bw)
            flat[torch.where(inside, idx, flat.numel() - 1)] = out
        planes = [flat[int(offsets[c]):int(offsets[c + 1])].view(g.rect.height, g.rect.width)
                  for c, g in enumerate(self.geoms)]
        clock.mark("scatter")
        comps = siz.comps
        out_planes = inverse_transform(
            planes, [g.rect for g in self.geoms],
            [t.num_resolutions - 1 for t in tcp.tccps], [c.prec for c in comps],
            [c.signed for c in comps], self._mct(), self.irreversible,
            self.band_tables() if self.irreversible else None)
        clock.mark("inverse")
        return out_planes
