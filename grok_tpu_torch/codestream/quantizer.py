"""Quantization parameters (T.800 Annex E); counterpart of
grok_tpu/codestream/quantizer.py.

Reversible (5/3): exponent-only signalling, eps_b = P + gain_b with P the
component's bit depth (incl. the +1 RCT chroma expansion) and gain_b the
subband log2 gain; Mb = G + eps_b - 1 (eq. E-2).

Irreversible (9/7): the default step Delta_b = 2^gain_b / norm_b, norm_b
the 9/7 synthesis-basis L2 norm, signalled as a 5-bit exponent and an
11-bit mantissa, Delta_b = 2^(R_b - eps_b) * (1 + mu_b / 2^11) with
R_b = P + gain_b; quantization style 2 (expounded) signals every band,
style 1 (derived) the LL band only (eq. E-5).
"""

from __future__ import annotations

import math

import numpy as np

from ..core.params import QuantStyle
from ..tile.geometry import BAND_GAIN, BAND_HH, BAND_HL, BAND_LH, BAND_LL, TileCompGeom
from .structs import TccpStyle

# 9/7 and 5/3 synthesis low- and high-pass impulse responses
_SYNTH = {
    True: (np.array([-0.091271763114250, -0.057543526228500, 0.591271763114250,
                     1.115087052457000, 0.591271763114250, -0.057543526228500,
                     -0.091271763114250]),
           np.array([0.026748757410810, 0.016864118442875, -0.078223266528990,
                     -0.266864118442875, 0.602949018236360, -0.266864118442875,
                     -0.078223266528990, 0.016864118442875, 0.026748757410810])),
    False: (np.array([0.5, 1.0, 0.5]), np.array([-0.125, -0.25, 0.75, -0.25, -0.125])),
}
_NORMS: dict[bool, dict[int, list[float]]] = {}


def _compute_dwt_norms(irreversible: bool, max_levels: int = 33) -> dict[int, list[float]]:
    """Per-band synthesis L2 norms for levels 1..max, from
    upsample-and-filter chains of the synthesis filters (separable:
    HL = nL * nH)."""
    lo, hi = _SYNTH[irreversible]

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


def band_norm(orient: int, level: int, irreversible: bool = False) -> float:
    """Synthesis norm of a 5/3 (or 9/7) band at decomposition ``level``
    (1 at level 0)."""
    if irreversible not in _NORMS:
        _NORMS[irreversible] = _compute_dwt_norms(irreversible)
    norms = _NORMS[irreversible][orient]
    if level <= 0:
        return 1.0
    return norms[min(level, len(norms)) - 1]


def _encode_stepsize(stepsize: float, num_bps: int) -> tuple[int, int]:
    """(exp, mant) with delta = 2^(num_bps - exp) * (1 + mant/2048)."""
    if stepsize <= 0:
        return 0, 0
    p = int(math.floor(math.log2(stepsize)))
    frac = stepsize / (2.0 ** p)
    mant = int(math.floor((frac - 1.0) * 2048.0 + 0.5))
    if mant >= 2048:
        mant = 0
        p += 1
    return max(0, min(31, num_bps - p)), mant


def _band_order(num_resolutions: int):
    """(orient, level) of each band in SQcd order: LL, then HL, LH, HH per
    resolution."""
    nl = num_resolutions - 1
    return [(BAND_LL, nl)] + [(o, nl - r + 1) for r in range(1, num_resolutions)
                              for o in (BAND_HL, BAND_LH, BAND_HH)]


def compute_signalled_quant(tccp: TccpStyle, prec: int) -> None:
    """Fill tccp.step_exps/step_mants for an encode; ``prec`` includes any
    MCT range expansion of this component."""
    exps: list[int] = []
    mants: list[int] = []
    for orient, level in _band_order(tccp.num_resolutions):
        gain = BAND_GAIN[orient]
        if tccp.quant_style == QuantStyle.NO_QUANT:
            exps.append(max(0, prec + gain))
            mants.append(0)
        else:
            e, m = _encode_stepsize((1 << gain) / band_norm(orient, level, True), prec + gain)
            exps.append(e)
            mants.append(m)
    if tccp.quant_style == QuantStyle.SCALAR_DERIVED:
        exps, mants = exps[:1], mants[:1]
    tccp.step_exps = exps
    tccp.step_mants = mants


def apply_band_quant(geom: TileCompGeom, tccp: TccpStyle, prec: int) -> None:
    """Fill each band's Mb (num_bps) and step from the signalled values, so
    encoder and decoder always agree with the codestream; ``prec`` includes
    any MCT range expansion of this component."""
    nl = tccp.num_resolutions - 1
    for res in geom.resolutions:
        for band in res.bands:
            gain = BAND_GAIN[band.orient]
            if tccp.quant_style == QuantStyle.SCALAR_DERIVED:
                level = nl if band.orient == BAND_LL else nl - res.r + 1
                exp = tccp.step_exps[0] - (nl - level)
                mant = tccp.step_mants[0]
            else:
                bidx = 0 if band.orient == BAND_LL else 3 * (res.r - 1) + band.orient
                i = min(bidx, len(tccp.step_exps) - 1)
                exp = tccp.step_exps[i]
                mant = tccp.step_mants[i] if tccp.step_mants else 0
            # Mb includes the ROI upshift (T.800 E.1: Mb = G + eps - 1 + s)
            band.num_bps = tccp.guard_bits + exp - 1 + tccp.roi_shift
            band.step = (1.0 if tccp.quant_style == QuantStyle.NO_QUANT
                         else (2.0 ** ((prec + gain) - exp)) * (1.0 + mant / 2048.0))
