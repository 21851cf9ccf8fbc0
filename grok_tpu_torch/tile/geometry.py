"""Tile-component geometry: resolution pyramid, bands, precincts and
codeblocks (T.800 Annex B eq. B-5..B-15); counterpart of
grok_tpu/tile/geometry.py.

All rects are half-open on the canvas:
  - component coords: tile-component rect (tcx0..tcx1)
  - resolution coords: ceil(tc / 2^(NL-r))
  - band coords: eq. B-15 with band origin offsets
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..codestream.structs import TccpStyle
from ..core.rect import Rect, ceil_div_pow2, floor_div_pow2

BAND_LL = 0
BAND_HL = 1  # horizontally high-pass
BAND_LH = 2
BAND_HH = 3

_BAND_OFFSETS = {BAND_LL: (0, 0), BAND_HL: (1, 0), BAND_LH: (0, 1), BAND_HH: (1, 1)}
# subband log2 gain for reversible exponent derivation (T.800 E.1.1)
BAND_GAIN = {BAND_LL: 0, BAND_HL: 1, BAND_LH: 1, BAND_HH: 2}


@dataclass
class CodeblockGeom:
    rect: Rect  # band coords, clipped to both band and precinct
    cx: int  # position in the precinct's codeblock grid
    cy: int


@dataclass
class PrecinctGeom:
    rect: Rect  # band coords
    cblk_grid_w: int
    cblk_grid_h: int
    cblks: list[CodeblockGeom] = field(default_factory=list)


@dataclass
class BandGeom:
    orient: int  # BAND_*
    rect: Rect  # band coords
    num_bps: int = 0  # Mb: max bitplanes incl. guard bits
    step: float = 1.0  # quantization step (9/7; 1.0 when reversible)
    precincts: list[PrecinctGeom] = field(default_factory=list)


@dataclass
class ResolutionGeom:
    r: int
    rect: Rect  # resolution coords
    ppx: int
    ppy: int
    cblk_w_exp: int  # effective codeblock exponents (after precinct clamp)
    cblk_h_exp: int
    prc_grid_w: int
    prc_grid_h: int
    bands: list[BandGeom] = field(default_factory=list)

    @property
    def num_precincts(self) -> int:
        return self.prc_grid_w * self.prc_grid_h


@dataclass
class TileCompGeom:
    comp: int
    rect: Rect  # component coords (tile-component rect)
    num_resolutions: int
    resolutions: list[ResolutionGeom] = field(default_factory=list)


def partition_count(r: Rect, exp_x: int, exp_y: int) -> tuple[int, int]:
    """Grid cells of size 2^exp anchored at origin 0 covering rect."""
    if r.empty():
        return 0, 0
    w = ceil_div_pow2(r.x1, exp_x) - floor_div_pow2(r.x0, exp_x)
    h = ceil_div_pow2(r.y1, exp_y) - floor_div_pow2(r.y0, exp_y)
    return w, h


def band_rect(tc: Rect, nl: int, r: int, orient: int) -> Rect:
    """T.800 eq. B-15."""
    if r == 0:
        return tc.ceil_div_pow2(nl)
    n = nl - r + 1  # decomposition level of the band
    xo, yo = _BAND_OFFSETS[orient]
    return Rect(
        ceil_div_pow2(tc.x0 - (xo << (n - 1)), n),
        ceil_div_pow2(tc.y0 - (yo << (n - 1)), n),
        ceil_div_pow2(tc.x1 - (xo << (n - 1)), n),
        ceil_div_pow2(tc.y1 - (yo << (n - 1)), n),
    )


def geom_cache_key(comp: int, tc_rect: Rect, tccp: TccpStyle) -> tuple:
    """Every input that shapes the tree or the band fields applied to it."""
    return (
        comp, tc_rect.x0, tc_rect.y0, tc_rect.x1, tc_rect.y1,
        tccp.num_resolutions, tccp.cblk_w_exp, tccp.cblk_h_exp,
        tccp.guard_bits, tuple(tccp.step_exps), tccp.roi_shift,
    )


_GEOM_CACHE: dict[tuple, TileCompGeom] = {}
_GEOM_CACHE_CAP = 64


def cached_tile_comp_geometry(comp: int, tc_rect: Rect,
                              tccp: TccpStyle) -> tuple[TileCompGeom, tuple]:
    """Memoized geometry tree (a 4K tile holds ~6k codeblock objects).
    Returns (geometry, cache_key)."""
    key = geom_cache_key(comp, tc_rect, tccp)
    g = _GEOM_CACHE.get(key)
    if g is None:
        g = build_tile_comp_geometry(comp, tc_rect, tccp)
        if len(_GEOM_CACHE) >= _GEOM_CACHE_CAP:
            _GEOM_CACHE.pop(next(iter(_GEOM_CACHE)))
        _GEOM_CACHE[key] = g
    return g, key


def build_tile_comp_geometry(comp: int, tc_rect: Rect, tccp: TccpStyle) -> TileCompGeom:
    """Construct the full geometry tree for one tile-component."""
    nl = tccp.num_resolutions - 1
    g = TileCompGeom(comp=comp, rect=tc_rect, num_resolutions=tccp.num_resolutions)
    for r in range(tccp.num_resolutions):
        res_rect = tc_rect.ceil_div_pow2(nl - r)
        ppx, ppy = tccp.precinct_exp(r)
        # codeblock size clamped by the precinct size (T.800 B.7)
        if r == 0:
            cbw = min(tccp.cblk_w_exp, ppx)
            cbh = min(tccp.cblk_h_exp, ppy)
        else:
            cbw = min(tccp.cblk_w_exp, ppx - 1)
            cbh = min(tccp.cblk_h_exp, ppy - 1)
        pw, ph = partition_count(res_rect, ppx, ppy)
        res = ResolutionGeom(
            r=r, rect=res_rect, ppx=ppx, ppy=ppy,
            cblk_w_exp=cbw, cblk_h_exp=cbh, prc_grid_w=pw, prc_grid_h=ph,
        )
        orients = [BAND_LL] if r == 0 else [BAND_HL, BAND_LH, BAND_HH]
        for orient in orients:
            brect = band_rect(tc_rect, nl, r, orient)
            band = BandGeom(orient=orient, rect=brect)
            px0 = floor_div_pow2(res_rect.x0, ppx) << ppx
            py0 = floor_div_pow2(res_rect.y0, ppy) << ppy
            for pj in range(ph):
                for pi in range(pw):
                    prc_res = Rect(
                        px0 + (pi << ppx), py0 + (pj << ppy),
                        px0 + ((pi + 1) << ppx), py0 + ((pj + 1) << ppy),
                    ).intersect(res_rect)
                    if r == 0:
                        prc_band = prc_res
                    else:
                        xo, yo = _BAND_OFFSETS[orient]
                        prc_band = Rect(
                            ceil_div_pow2(prc_res.x0 - xo, 1),
                            ceil_div_pow2(prc_res.y0 - yo, 1),
                            ceil_div_pow2(prc_res.x1 - xo, 1),
                            ceil_div_pow2(prc_res.y1 - yo, 1),
                        )
                    prc_band = prc_band.intersect(brect)
                    cg_w, cg_h = partition_count(prc_band, cbw, cbh)
                    prc = PrecinctGeom(rect=prc_band, cblk_grid_w=cg_w,
                                       cblk_grid_h=cg_h)
                    if not prc_band.empty():
                        cx0 = floor_div_pow2(prc_band.x0, cbw) << cbw
                        cy0 = floor_div_pow2(prc_band.y0, cbh) << cbh
                        for cj in range(cg_h):
                            for ci in range(cg_w):
                                crect = Rect(
                                    cx0 + (ci << cbw), cy0 + (cj << cbh),
                                    cx0 + ((ci + 1) << cbw),
                                    cy0 + ((cj + 1) << cbh),
                                ).intersect(prc_band)
                                prc.cblks.append(CodeblockGeom(rect=crect, cx=ci, cy=cj))
                    band.precincts.append(prc)
            res.bands.append(band)
        g.resolutions.append(res)
    return g
