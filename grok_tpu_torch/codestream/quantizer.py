"""Quantization parameters for the reversible path (T.800 Annex E);
counterpart of grok_tpu/codestream/quantizer.py.

Reversible (5/3): exponent-only signalling, eps_b = P + gain_b with P the
component's bit depth (incl. the +1 RCT chroma expansion) and gain_b the
subband log2 gain; Mb = G + eps_b - 1 (eq. E-2). ``band_norm`` gives the
synthesis-basis L2 norms that weight per-pass distortions.
"""

from __future__ import annotations

import numpy as np

from ..tile.geometry import BAND_GAIN, BAND_HH, BAND_HL, BAND_LH, BAND_LL, TileCompGeom
from .structs import TccpStyle

_NORMS: dict[int, list[float]] = {}


def _compute_dwt53_norms(max_levels: int = 33) -> dict[int, list[float]]:
    """Per-band synthesis L2 norms of the 5/3 filters for levels 1..max,
    from upsample-and-filter chains (separable: HL = nL * nH)."""
    lo = np.array([0.5, 1.0, 0.5])
    hi = np.array([-0.125, -0.25, 0.75, -0.25, -0.125])

    def upsample(x):
        y = np.zeros(2 * len(x) - 1)
        y[::2] = x
        return y

    n_l, n_h = [], []
    cur = np.array([1.0])
    exact = min(max_levels, 12)  # beyond this the norms grow ~2x per level
    for _ in range(exact):
        wave_l = np.convolve(upsample(cur) if len(cur) > 1 else cur, lo)
        wave_h = np.convolve(upsample(cur) if len(cur) > 1 else cur, hi)
        n_l.append(float(np.sqrt((wave_l ** 2).sum())))
        n_h.append(float(np.sqrt((wave_h ** 2).sum())))
        cur = wave_l
    for _ in range(exact, max_levels):
        n_l.append(n_l[-1] * (n_l[-1] / n_l[-2]))
        n_h.append(n_h[-1] * (n_l[-2] / n_l[-3]))
    return {
        BAND_LL: [a * a for a in n_l],
        BAND_HL: [a * b for a, b in zip(n_l, n_h)],
        BAND_LH: [b * a for a, b in zip(n_l, n_h)],
        BAND_HH: [b * b for b in n_h],
    }


def band_norm(orient: int, level: int) -> float:
    """Synthesis norm of a 5/3 band at decomposition ``level`` (1 at 0)."""
    if not _NORMS:
        _NORMS.update(_compute_dwt53_norms())
    if level <= 0:
        return 1.0
    return _NORMS[orient][min(level, len(_NORMS[orient])) - 1]


def _band_order(num_resolutions: int):
    """Orient of each band in SQcd order: LL then HL, LH, HH per res."""
    return [BAND_LL] + [BAND_HL, BAND_LH, BAND_HH] * (num_resolutions - 1)


def compute_signalled_quant(tccp: TccpStyle, prec: int) -> None:
    """Fill tccp.step_exps for a reversible encode; ``prec`` includes any
    MCT range expansion of this component."""
    tccp.step_exps = [max(0, prec + BAND_GAIN[o]) for o in _band_order(tccp.num_resolutions)]


def apply_band_quant(geom: TileCompGeom, tccp: TccpStyle) -> None:
    """Fill each band's Mb (num_bps) from the signalled exponents, so it
    always agrees with the codestream."""
    for res in geom.resolutions:
        for band in res.bands:
            bidx = 0 if band.orient == BAND_LL else 3 * (res.r - 1) + band.orient
            exp = tccp.step_exps[min(bidx, len(tccp.step_exps) - 1)]
            band.num_bps = tccp.guard_bits + exp - 1
