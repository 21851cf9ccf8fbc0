"""Per-tile pipelines. Encode: transform (5/3, or 9/7 and quantization)
-> codeblock gather -> T1 -> T2; decode (Part-1 and HT): T2 -> T1 ->
codeblock scatter -> inverse transform (5/3, or dequantization and 9/7).

Counterpart of grok_tpu/tile/tile_processor.py: the device branch of
compress (:249-279), _entropy_and_t2 (:400) with its HT branch
(:492-538), its PCRD rate control (the simulate-then-write loop :566-606,
_allocate_layers :762 with the exact-rate simulation of the default
native path, _layer_targets :737, _mct_weights :866) and the Python
_emit_packets (:655) for any number of quality layers; and decompress
(:1303) over the object T2 path _decompress_t1_objects (:1154, layer
limits and the merge of segment pieces included) with the device inverse
chain (:1422-1442), with the Part-2 MCT (:327-337, :1599-1602) and the
ROI maxshift (:379-384; on decode in K-i's writeout for Part-1, :986-997,
and on the staging planes for HT, :1487-1500). The plane-limited
re-encode of the reference (GROK_TPU_RATE_SKIP, :509-529) is not ported:
it needs its host T1.

The coefficients stay on the device from the transform through the
gather and the T1 kernels; only the codeblock bytes, lengths, repaired
pass rates, plane counts and, for rate control, the weighted pass
distortions and their hull slopes (K-q) come back to the host, once, for
PCRD and T2. The threshold search and its packet simulations run on the
host, as in the reference. On decode the segments
go up once (Part-1: back to back in one buffer; HT: padded rows) and the
decoded samples come back once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codestream.quantizer import apply_band_quant, band_norm
from ..codestream.structs import Siz, Tcp
from ..core.errors import UnsupportedFeatureError
from ..core.params import CBLK_HT, CompressParams
from ..core.rect import Rect, ceil_div
from ..core.timing import StageClock
from ..ops.transform import forward_transform, inverse_transform
from ..t1 import ebcot_cuda, ht_cuda
from ..t1.ebcot_dec import SEGMENTED
from ..t2 import rate_control
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


def _repaired_pass_rates(pass_rates: torch.Tensor, npasses: torch.Tensor) -> torch.Tensor:
    """Suffix-min monotone repair of the conservative pass rates int64
    [n, P], on their device (T2 segment lengths are differences of rates,
    so they must not drop); passes beyond npasses [n] stay as they are."""
    if pass_rates.numel() == 0:
        return pass_rates
    cols = torch.arange(pass_rates.shape[1], device=pass_rates.device)
    pad = cols[None, :] >= npasses[:, None]
    work = pass_rates.masked_fill(pad, torch.iinfo(pass_rates.dtype).max)
    work = work.flip(1).cummin(1).values.flip(1)
    return torch.where(pad, pass_rates, work)


def _repair_pass_rates(pass_rates: np.ndarray, npasses: np.ndarray) -> None:
    """``_repaired_pass_rates`` of host arrays, in place."""
    pass_rates[...] = _repaired_pass_rates(torch.from_numpy(pass_rates),
                                           torch.from_numpy(np.asarray(npasses))).numpy()


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
class _T1Host:
    """A tile's T1 results on the host, what PCRD and T2 read."""

    data: np.ndarray  # [n, maxlen] uint8 segment bytes
    lengths: np.ndarray  # [n]
    rates: np.ndarray  # [n, P] int64 cumulative pass rates, repaired
    numbps: np.ndarray  # [n]
    npasses: np.ndarray  # [n]


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
    def __init__(self, siz: Siz, tcp: Tcp, tile_index: int, device: torch.device,
                 params: CompressParams | None = None):
        self.siz = siz
        self.tcp = tcp
        # the encoder's parameters: rate control reads their targets
        self.params = params or CompressParams()
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
    def compress(self, comp_arrays: list[np.ndarray] | None,
                 clock: StageClock | None = None,
                 coeffs: list[torch.Tensor] | None = None) -> bytes:
        """comp_arrays: per-component int32 tile data (natural range); or
        ``coeffs``, the tile's packed int32 coefficient planes on this
        processor's device, transformed elsewhere (a shard of the mesh,
        the reference's compress_from_coeffs), which skip the upload and
        the transform. Returns the tile body: its packets in progression
        order."""
        clock = clock or StageClock(self.device, None)
        self._apply_band_quant()
        if coeffs is None:
            planes = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)
                      for a in comp_arrays]
            clock.mark("upload")
            coeffs = forward_transform(planes, **self.forward_plan())
            clock.mark("transform")
        elif any(c.device != self.device or c.dtype != torch.int32 for c in coeffs):
            raise ValueError(f"tile {self.tile_index}: the coefficients must be int32 planes "
                             f"on {self.device}")
        return self._entropy_and_t2(coeffs, clock)

    def forward_plan(self) -> dict:
        """The arguments of ``forward_transform`` besides the planes, for
        this tile's geometry and coding parameters (band quantization
        applied): what a shard of the mesh runs for it."""
        siz, tcp = self.siz, self.tcp
        return dict(
            rects=[g.rect for g in self.geoms],
            num_levels=[t.num_resolutions - 1 for t in tcp.tccps],
            dcs=[0 if c.signed else 1 << (c.prec - 1) for c in siz.comps],
            mct=self._mct(), irreversible=self.irreversible,
            bands=self.band_tables() if self.irreversible else None, rois=self._rois(),
            # the Part-2 encoding matrix in float32, as the host path applies
            # it (the reference's :327-337)
            custom=None if tcp.mct != 2 else np.asarray(tcp.mct_enc_matrix, dtype=np.float32))

    @property
    def irreversible(self) -> bool:
        """9/7 for every component when the first component's style says so
        (the reference's tile_processor reads tccps[0] too)."""
        return self.tcp.tccps[0].irreversible

    def _mct(self) -> bool:
        """The RCT or ICT (the Part-2 MCT, mct = 2, is another path)."""
        return self.tcp.mct == 1 and self.siz.num_comps >= 3

    def _rois(self) -> list[int]:
        return [t.roi_shift for t in self.tcp.tccps]

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

    def _layer_targets(self) -> list[float | None] | None:
        """Cumulative byte budgets per layer from the configured ratios, for
        this tile's area and precisions (the reference's :737)."""
        rates_cfg = self.params.layer_rates
        if not rates_cfg:
            return None
        tile_bits = 0
        for c in range(self.siz.num_comps):
            tile_bits += self.geoms[c].rect.area * self.siz.comps[c].prec
        tile_bytes = tile_bits / 8.0
        targets: list[float | None] = []
        for li in range(self.tcp.num_layers):
            ratio = rates_cfg[li] if li < len(rates_cfg) else 0
            targets.append(None if not ratio or ratio <= 1.0 else tile_bytes / float(ratio))
        return targets

    def _needs_pass_dist(self) -> bool:
        """Whether PCRD reads per-pass distortions (the reference's :753):
        not for one layer without rate or quality targets, which takes
        every pass."""
        p = self.params
        return self.tcp.num_layers != 1 or bool(p.layer_rates or p.layer_psnrs)

    def _mct_weights(self) -> list[float]:
        """L2 norms of the inverse MCT's columns, the error-propagation
        weights of each component (the reference's :866), from the float64
        matrices; 1.0 for every component without the RCT or ICT, the
        Part-2 MCT included (the reference's :870)."""
        ncomp = self.siz.num_comps
        if not self._mct():
            return [1.0] * ncomp
        m = rate_control.ICT_INV64 if self.irreversible else rate_control.RCT_INV_LINEAR
        return rate_control.mct_column_weights(m) + [1.0] * (ncomp - 3)

    def _band_weights(self, refs: list[_CblkRef]) -> np.ndarray:
        """Each codeblock's distortion weight (step * band norm * MCT
        weight)^2 float64 [n] (the reference's :784-805)."""
        mct_w = self._mct_weights()
        per_band: dict[tuple[int, int, int], float] = {}
        for c, g in enumerate(self.geoms):
            tccp = self.tcp.tccps[c]
            nl = tccp.num_resolutions - 1
            for res in g.resolutions:
                for bi, band in enumerate(res.bands):
                    lvl = nl - res.r + 1 if band.orient != BAND_LL else nl
                    bn = band_norm(band.orient, lvl, tccp.irreversible)
                    per_band[(c, res.r, bi)] = (band.step * bn * mct_w[c]) ** 2
        return np.array([per_band[(r.comp, r.res, r.band_i)] for r in refs], dtype=np.float64)

    def _entropy_and_t2(self, coeffs: list[torch.Tensor], clock: StageClock):
        plan = self.gather_plan()
        if not plan.refs:
            return b""
        batch = self.gather(coeffs, plan)
        clock.mark("gather")
        use_ht = bool(self.tcp.tccps[0].cblk_style & CBLK_HT)
        want_dist = self._needs_pass_dist()
        if use_ht:
            res = ht_cuda.encode_cblks(batch, plan.heights, plan.widths, clock=clock,
                                       want_dist=want_dist)
        else:
            res = ebcot_cuda.encode_cblks(batch, plan.heights, plan.widths, plan.orients,
                               styles=plan.styles, clock=clock,
                               want_dist=want_dist)
        rates = res.pass_rates
        if not use_ht:  # an HT codeblock has one pass: nothing to repair
            rates = _repaired_pass_rates(rates, res.npasses)
        if want_dist:
            # PCRD's inputs stay on the device for the hull: the distortions
            # weighted by their band, and the slopes of each codeblock's hull
            w2 = torch.from_numpy(self._band_weights(plan.refs)).to(self.device)
            dists = res.pass_dist * w2[:, None]
            slopes = rate_control.hull_slopes(rates, dists,
                                              res.npasses.to(torch.int32).contiguous())
            clock.mark("hull")
        maxlen = int(res.lengths.max())
        t1 = _T1Host(data=res.data[:, :maxlen].cpu().numpy(),
                     lengths=res.lengths.cpu().numpy(), rates=rates.cpu().numpy(),
                     numbps=res.numbps.cpu().numpy(), npasses=res.npasses.cpu().numpy())
        if want_dist:
            dists, slopes = dists.cpu().numpy(), slopes.cpu().numpy()
        clock.mark("to_host")
        order = packet_order(self.siz, self.tcp, self.geoms, self.tile_rect)
        if not want_dist:
            out = self._emit_packets(plan.refs, t1, t1.npasses[None, :].astype(np.int64), order)
            clock.mark("t2")
            return out

        # ---- PCRD: the simulate-then-write loop of the reference
        # (:566-606): a layer allocation, the packets, and a tighter budget
        # while the packets overshoot the rate target
        targets = self._layer_targets()
        shrink = 0
        for _attempt in range(4):
            cum_passes = self._allocate_layers(plan.refs, t1, dists, slopes, order, clock,
                                               extra_margin=shrink)
            clock.mark("pcrd")
            body = self._emit_packets(plan.refs, t1, cum_passes, order)
            clock.mark("t2")
            if targets is None or targets[-1] is None:
                break
            total = len(body)
            if total <= targets[-1]:
                break
            shrink += total - targets[-1] + 16
        return body

    def _allocate_layers(self, refs, t1: _T1Host, dists: np.ndarray, slopes: np.ndarray,
                         order, clock: StageClock, extra_margin: float = 0.0) -> np.ndarray:
        """Cumulative pass counts per layer [L, N] (the reference's :762):
        rate targets through exact packet simulations (or, with
        rc_algorithm=1, a header estimate), PSNR targets through the
        residual distortion. ``clock`` counts the simulations under
        ``pcrd_simulations``."""
        p = self.params
        num_layers = self.tcp.num_layers
        targets = self._layer_targets() or [None] * num_layers
        targets = [None if t is None else max(t - extra_margin, 0.0) for t in targets]

        # fixed-quality (PSNR) layers: residual-distortion ceilings in the
        # weighted (image-domain) squared-error units of `dists`
        dist_targets = None
        if p.layer_psnrs:
            samples = sum(g.rect.area for g in self.geoms)
            peak = max((1 << c.prec) - 1 for c in self.siz.comps)
            dist_targets = [
                None if (q is None or q <= 0)
                else samples * float(peak) ** 2 / (10.0 ** (q / 10.0))
                for q in p.layer_psnrs
            ]

        exact_rate_fn = None
        if p.rc_algorithm != 1:
            def exact_rate_fn(rows):
                clock.count("pcrd_simulations")
                return self._emit_packets(refs, t1, np.stack(rows).astype(np.int64), order,
                                          simulate=True)

        n_prc = sum(res.num_precincts for g in self.geoms for res in g.resolutions)
        per_pkt = 1.2  # no SOP or EPH markers (the reference adds 6 and 2)

        def header_overhead(cum):
            # per-packet floor + ~4 bytes per included block's header
            return n_prc * per_pkt + int((cum > 0).sum()) * 4.0

        return rate_control.allocate_layers(
            t1.rates, dists, t1.npasses, targets, header_overhead,
            exact_rate_fn=exact_rate_fn, dist_targets=dist_targets, slopes=slopes)

    def _emit_packets(self, refs, t1: _T1Host, cum_passes: np.ndarray, order,
                      simulate: bool = False):
        """T2 of the first L = len(cum_passes) quality layers, codeblock i
        holding cum_passes[l, i] passes after layer l: fresh precinct
        header state, then the packets of those layers in progression order.
        Returns the body, or with ``simulate`` its length only (the
        reference's native simulation, T2Compress compressPacketsSimulate)."""
        siz, tcp = self.siz, self.tcp
        num_layers = cum_passes.shape[0]
        prev = np.concatenate([np.zeros_like(cum_passes[:1]), cum_passes[:-1]])
        layer_passes = cum_passes - prev
        rate_at = np.take_along_axis(t1.rates, np.maximum(cum_passes.T - 1, 0), axis=1).T
        rate_at = np.where(cum_passes > 0, rate_at, 0)
        rate_prev = np.concatenate([np.zeros_like(rate_at[:1]), rate_at[:-1]])
        layer_bytes = np.where(layer_passes > 0, rate_at - rate_prev, 0)
        has = layer_passes > 0
        first_layer = np.where(has.any(axis=0), has.argmax(axis=0), num_layers)
        lp_cols, lb_cols = layer_passes.T.tolist(), layer_bytes.T.tolist()

        prc_ctx_map: dict[tuple[int, int, int, int], PrecinctCtx] = {}
        for c in range(siz.num_comps):
            for res in self.geoms[c].resolutions:
                for bi, band in enumerate(res.bands):
                    for pi, prc in enumerate(band.precincts):
                        prc_ctx_map[(c, res.r, bi, pi)] = PrecinctCtx(band, prc)
        for i, ref in enumerate(refs):
            cb = CblkEnc(
                data=t1.data[i],
                total_len=int(t1.lengths[i]),
                npasses=int(t1.npasses[i]),
                numbps=int(t1.numbps[i]),
                layer_passes=lp_cols[i],
                layer_bytes=lb_cols[i],
                first_layer=int(first_layer[i]),
                style=int(tcp.tccps[ref.comp].cblk_style) & 0x3F,
                pass_rates=t1.rates[i],
            )
            prc_ctx_map[(ref.comp, ref.res, ref.band_i, ref.prec)].cblks[ref.cblk_i] = cb
        for ctx in prc_ctx_map.values():
            ctx.set_encoder_trees(num_layers)
        parts: list[bytes] = []
        total = 0
        for pk in order:
            if pk.layer >= num_layers:
                continue  # a simulation of the first layers only
            res = self.geoms[pk.comp].resolutions[pk.res]
            ctxs = [prc_ctx_map[(pk.comp, pk.res, bi, pk.prec)]
                    for bi in range(len(res.bands))]
            if simulate:
                total += encode_packet(ctxs, pk.layer, simulate=True)
            else:
                parts.append(encode_packet(ctxs, pk.layer))
        return total if simulate else b"".join(parts)

    # ------------------------------------------------------------ decode
    def decompress(self, body, clock: StageClock | None = None,
                   max_layers: int = 0, staging_only: bool = False) -> list[torch.Tensor]:
        """Decode a tile body (its packets) into per-component int32 sample
        planes on the device. ``max_layers`` > 0 keeps the passes of the
        first that many quality layers only (the reference's
        _decompress_t1_objects, :1176-1198: packets of later layers are
        parsed and dropped, and reading stops after the last wanted one).
        With ``staging_only`` it returns the int32 staging planes before
        the inverse transform (the reference's :1306, :1415), for
        ``inverse`` to finish, here or on a shard of the mesh."""
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
        rois = [0 if use_ht else r for r in self._rois()]
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
                # a Part-1 codeblock's ROI shift rides style bits 8-15 to K-i
                # (the reference's :986-997)
                cols.append((int(offsets[c]) + y0 * g.rect.width + x0, g.rect.width,
                             cg.rect.height, cg.rect.width, cb.numbps, cb.npasses,
                             band.orient, (cb.style & 0x3F) | (rois[c] << 8), len(seg)))
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
        if staging_only:
            return planes
        return self.inverse(planes, clock)

    def inverse(self, planes: list[torch.Tensor],
                clock: StageClock | None = None) -> list[torch.Tensor]:
        """The inverse chain of this tile on its staging planes (on their
        device): the component samples."""
        clock = clock or StageClock(planes[0].device, None)
        tcp, comps = self.tcp, self.siz.comps
        use_ht = bool(tcp.tccps[0].cblk_style & CBLK_HT)
        # HT codeblocks get the ROI downshift on the staging planes (the
        # reference's :1487-1500); K-i already applied it to Part-1 ones
        out_planes = inverse_transform(
            planes, [g.rect for g in self.geoms],
            [t.num_resolutions - 1 for t in tcp.tccps], [c.prec for c in comps],
            [c.signed for c in comps], self._mct(), self.irreversible,
            self.band_tables() if self.irreversible else None,
            rois=self._rois() if use_ht else None,
            custom=(None if tcp.mct != 2
                    else np.asarray(tcp.mct_dec_matrix, dtype=np.float32)),
            offsets=tcp.mct_offsets)
        clock.mark("inverse")
        return out_planes
