"""Packet progression order for one tile (T.800 B.12); counterpart of
grok_tpu/t2/progression.py without progression changes (POC is outside
this slice). Position-based orders sort every (comp, res, precinct) by its
projected canvas anchor, which equals the standard's nested loops."""

from __future__ import annotations

from dataclasses import dataclass

from ..codestream.structs import Siz, Tcp
from ..core.params import ProgressionOrder
from ..tile.geometry import TileCompGeom


@dataclass(frozen=True)
class PacketIndex:
    layer: int
    comp: int
    res: int
    prec: int  # precinct index within (comp, res)


def _precinct_anchors(siz: Siz, geoms: list[TileCompGeom], tile_rect):
    """(comp, res, prec_idx, canvas_x, canvas_y) for every precinct; the
    first precinct of a direction sorts at the tile origin only when the
    projected resolution origin is off the precinct grid (B.12.1.3)."""
    out = []
    for c, g in enumerate(geoms):
        dx, dy = siz.comps[c].dx, siz.comps[c].dy
        nl = g.num_resolutions - 1
        for res in g.resolutions:
            shift = nl - res.r
            if res.rect.empty() or res.num_precincts == 0:
                continue
            px0 = (res.rect.x0 >> res.ppx) << res.ppx
            py0 = (res.rect.y0 >> res.ppy) << res.ppy
            x_aligned = ((res.rect.x0 << shift) % (1 << (res.ppx + shift))) == 0
            y_aligned = ((res.rect.y0 << shift) % (1 << (res.ppy + shift))) == 0
            for pj in range(res.prc_grid_h):
                for pi in range(res.prc_grid_w):
                    p = pj * res.prc_grid_w + pi
                    cx = ((px0 + (pi << res.ppx)) << shift) * dx
                    cy = ((py0 + (pj << res.ppy)) << shift) * dy
                    if pi == 0:
                        cx = (res.rect.x0 << shift) * dx if x_aligned else tile_rect.x0
                    if pj == 0:
                        cy = (res.rect.y0 << shift) * dy if y_aligned else tile_rect.y0
                    out.append((c, res.r, p, cx, cy))
    return out


def packet_order(siz: Siz, tcp: Tcp, geoms: list[TileCompGeom],
                 tile_rect) -> list[PacketIndex]:
    """Full packet sequence of one tile in the tile's progression order."""
    order = tcp.progression
    layers = range(tcp.num_layers)
    max_res = max(g.num_resolutions for g in geoms)
    out: list[PacketIndex] = []
    if order in (ProgressionOrder.LRCP, ProgressionOrder.RLCP):
        outer, inner = ((layers, range(max_res))
                        if order == ProgressionOrder.LRCP
                        else (range(max_res), layers))
        for a in outer:
            for b in inner:
                l, r = (a, b) if order == ProgressionOrder.LRCP else (b, a)
                for c, g in enumerate(geoms):
                    if r >= g.num_resolutions:
                        continue
                    for p in range(g.resolutions[r].num_precincts):
                        out.append(PacketIndex(l, c, r, p))
        return out
    key = {
        ProgressionOrder.RPCL: lambda t: (t[1], t[4], t[3], t[0]),
        ProgressionOrder.PCRL: lambda t: (t[4], t[3], t[0], t[1]),
        ProgressionOrder.CPRL: lambda t: (t[0], t[4], t[3], t[1]),
    }[order]
    for (c, r, p, _x, _y) in sorted(_precinct_anchors(siz, geoms, tile_rect), key=key):
        for l in layers:
            out.append(PacketIndex(l, c, r, p))
    return out
