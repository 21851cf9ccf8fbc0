"""Per-tile encode pipeline: transform -> codeblock gather -> T1 -> T2.

Counterpart of the encode half of grok_tpu/tile/tile_processor.py: the
device branch of compress (:249-279), _entropy_and_t2 (:400) and the
Python _emit_packets (:655) for one quality layer without rate control
(every pass of every codeblock goes into the single layer).

The coefficients stay on the device from the transform through the
gather and both T1 kernels; only the codeblock bytes, lengths, pass
rates and plane counts come back to the host, for T2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codestream.quantizer import apply_band_quant
from ..codestream.structs import Siz, Tcp
from ..core.rect import Rect, ceil_div
from ..core.timing import StageClock
from ..ops.transform import forward_transform
from ..t1.ebcot_cuda import encode_cblks
from ..t2.packets import CblkEnc, PrecinctCtx, encode_packet
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
        ncomp = siz.num_comps
        for c in range(ncomp):
            apply_band_quant(self.geoms[c], tcp.tccps[c])
        planes = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)
                  for a in comp_arrays]
        clock.mark("upload")
        dcs = [0 if c.signed else 1 << (c.prec - 1) for c in siz.comps]
        coeffs = forward_transform(
            planes, [g.rect for g in self.geoms],
            [t.num_resolutions - 1 for t in tcp.tccps], dcs,
            rct=tcp.mct == 1 and ncomp >= 3)
        clock.mark("transform")
        return self._entropy_and_t2(coeffs, clock)

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
        ys = torch.arange(cbh, device=self.device)[None, :, None]
        xs = torch.arange(cbw, device=self.device)[None, None, :]
        idx = plan.base[:, None, None] + ys * plan.stride[:, None, None] + xs
        inside = (ys < plan.heights[:, None, None]) & (xs < plan.widths[:, None, None])
        return flat[torch.where(inside, idx, flat.numel() - 1)]

    def _entropy_and_t2(self, coeffs: list[torch.Tensor], clock: StageClock):
        plan = self.gather_plan()
        if not plan.refs:
            return b""
        batch = self.gather(coeffs, plan)
        clock.mark("gather")
        res = encode_cblks(batch, plan.heights, plan.widths, plan.orients,
                           styles=plan.styles, clock=clock)
        maxlen = int(res.lengths.max())
        data = res.data[:, :maxlen].cpu().numpy()
        lengths = res.lengths.cpu().numpy()
        rates = res.pass_rates.cpu().numpy()
        numbps = res.numbps.cpu().numpy()
        npasses = res.npasses.cpu().numpy()
        clock.mark("to_host")
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
