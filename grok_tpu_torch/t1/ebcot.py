"""EBCOT Tier-1 encode helpers (T.800 Annex D); counterpart of the
encode-side helpers of grok_tpu/t1/ebcot_np.py: the zero-coding and
sign-coding context tables, the per-lane pass bookkeeping and the
distortion-decrease formulas, all on torch tensors."""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _build_zc_lut() -> torch.Tensor:
    """Zero-coding contexts (T.800 Table D-1), indexed
    [orient][h*15 + v*5 + d] with h, v in 0..2 and d in 0..4.
    Orients: 0 LL, 1 HL, 2 LH, 3 HH."""
    lut = torch.zeros((4, 45), dtype=torch.int32)

    def normal(h, v, d):
        if h == 2:
            return 8
        if h == 1:
            return 7 if v >= 1 else (6 if d >= 1 else 5)
        if v == 2:
            return 4
        if v == 1:
            return 3
        return 2 if d >= 2 else (1 if d == 1 else 0)

    def hh(h, v, d):
        a = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if a >= 1 else 6
        if d == 1:
            return 5 if a >= 2 else (4 if a == 1 else 3)
        return 2 if a >= 2 else (1 if a == 1 else 0)

    for h in range(3):
        for v in range(3):
            for d in range(5):
                i = h * 15 + v * 5 + d
                lut[0, i] = normal(h, v, d)  # LL
                lut[2, i] = normal(h, v, d)  # LH
                lut[1, i] = normal(v, h, d)  # HL: transpose roles
                lut[3, i] = hh(h, v, d)  # HH
    return lut


def _build_sc_tables() -> tuple[torch.Tensor, torch.Tensor]:
    """Sign-coding contexts and xor bits (T.800 Table D-3), indexed
    (hbar + 1) * 3 + (vbar + 1)."""
    ctx = torch.zeros(9, dtype=torch.int32)
    xor = torch.zeros(9, dtype=torch.int32)
    for hb in (-1, 0, 1):
        for vb in (-1, 0, 1):
            i = (hb + 1) * 3 + (vb + 1)
            if hb == 0:
                c, x = (9, 0) if vb == 0 else (10, 0 if vb > 0 else 1)
            elif hb > 0:
                c, x = {1: (13, 0), 0: (12, 0), -1: (11, 0)}[vb]
            else:
                c, x = {1: (11, 1), 0: (12, 1), -1: (13, 1)}[vb]
            ctx[i] = c
            xor[i] = x
    return ctx, xor


ZC_LUT = _build_zc_lut()
SC_CTX, SC_XOR = _build_sc_tables()


def ctx_table(zc_lut=ZC_LUT, sc_ctx=SC_CTX, sc_xor=SC_XOR) -> torch.Tensor:
    """ZC LUT (180) + SC ctx (9) + SC xor (9) as one int32 [198] tensor,
    the layout the symbol-scan kernel loads into shared memory."""
    return torch.cat([zc_lut.reshape(-1), sc_ctx, sc_xor]).to(torch.int32)


@dataclass
class T1EncodeResult:
    """Batched T1 output; tensors live on the device that encoded them."""

    data: torch.Tensor  # [N, max_bytes + 1] uint8 segment bytes per lane
    lengths: torch.Tensor  # [N] int64 total segment bytes
    numbps: torch.Tensor  # [N] int64 coded magnitude bit planes
    npasses: torch.Tensor  # [N] int64 coding passes (3*numbps - 2, or 0)
    pass_rates: torch.Tensor  # [N, max_passes] int64 cumulative byte bounds
    # [N, max_passes] float64 distortion decrease; None when not asked for
    pass_dist: torch.Tensor | None
    # (buffer [N, max_bytes + 2], column of byte 0): data == buf[:, 1:]
    raw_data: tuple | None = None


def lane_numbps(mag: torch.Tensor, heights: torch.Tensor,
                widths: torch.Tensor) -> torch.Tensor:
    """Coded magnitude planes per lane: bit length of the largest in-block
    magnitude. mag: [N, H, W] int32/int64 (non-negative)."""
    n, h, w = mag.shape
    ys = torch.arange(h, device=mag.device)[None, :, None]
    xs = torch.arange(w, device=mag.device)[None, None, :]
    inb = (ys < heights[:, None, None]) & (xs < widths[:, None, None])
    mx = torch.where(inb, mag, 0).reshape(n, -1).amax(dim=1).to(torch.int64)
    nb = torch.zeros(n, dtype=torch.int64, device=mag.device)
    for b in range(32):
        nb += (mx >= (1 << b)).to(torch.int64)
    return nb


def local_pass_index(plane, kind: int, numbps: torch.Tensor) -> torch.Tensor:
    """Lane-local pass index for (plane, kind); kind 0 SPP, 1 MRP, 2 CUP.
    The first (MSB) plane has only CUP (pass 0)."""
    rel = numbps - 1 - plane
    return torch.where(rel <= 0, 0, (rel - 1) * 3 + 1 + kind)


def pass_is_raw(bypass: torch.Tensor, lpi: torch.Tensor, kind) -> torch.Tensor:
    """Bypass lanes code SPP/MRP raw from the 11th pass on (T.800 D.4)."""
    return bypass & (lpi >= 10) & (torch.as_tensor(kind, device=lpi.device) != 2)


def term_after(termall: torch.Tensor, bypass: torch.Tensor,
               lpi: torch.Tensor) -> torch.Tensor:
    """Per-lane 'this pass ends a codeword segment' predicate."""
    t = torch.where(lpi == 0, 2, torch.remainder(lpi - 1, 3))
    bound = bypass & ((lpi == 9) | ((lpi > 9) & ((t == 1) | (t == 2))))
    return termall | bound


def dd_sig(v: torch.Tensor, plane: int) -> torch.Tensor:
    """v^2 - (v - 1.5*2^p)^2 = 3*2^p*v - 2.25*4^p in float64 (the op order
    of the reference coders; constants exact)."""
    return float(3.0 * 2.0 ** plane) * v.to(torch.float64) - float(2.25 * 4.0 ** plane)


def dd_ref(v: torch.Tensor, plane: int) -> torch.Tensor:
    """(v - rb)^2 - (v - ra)^2 with a1 = (v mod 2^{p+1}) - 2^p and
    a2 = (v mod 2^p) - 2^{p-1}."""
    a1 = (v & ((2 << plane) - 1)).to(torch.float64) - float(2.0 ** plane)
    a2 = (v & ((1 << plane) - 1)).to(torch.float64) - float(2.0 ** (plane - 1))
    return a1 * a1 - a2 * a2
