"""Part-1 EBCOT on the GPU: the encoder's symbol-scan kernel + MQ packer
kernel, and the decoder kernel.

Counterpart of grok_tpu/t1/ebcot_pallas.py. The context-modelling scan
(K-c ``ebcot_symbols``, csrc/ebcot_symbols.cu, the port of the Pallas
kernel ``_build_kernel_wide``) emits one byte record per coding decision
at a fixed slot; the packer (K-d ``mq_pack``, csrc/mq_pack.cu, the port of
the host packers ``_pack_symbols``/``_pack_symbols_nat``) drives the MQ and
raw coders over those records. The encoder's symbol sequence never depends
on the coder state, so records + contexts reproduce the stream exactly.

The decoder (K-i ``ebcot_decode``, csrc/ebcot_dec.cu, the port of K5's
lockstep decoder ``ebcot_jax._build_decoder``) turns codeword segments
back into coefficients, one warp a codeblock over the reference decoder's
stripe words.

The per-pass distortions that a layer allocation reads come from K-p
``ebcot_pass_dist`` (csrc/ebcot_dist.cu, the counterpart of K5-enc's
distortion half, ``ebcot_jax._build_encoder``), over K-c's records.

Each kernel has its plain torch version (``ebcot_symbols_plain``,
``mq_pack_plain``, ``pass_dist_from_records`` in this module;
``ebcot_decode_plain`` in t1/ebcot_dec.py). A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from ..core.errors import UnsupportedFeatureError
from ..core.timing import StageClock
from .ebcot import (
    T1EncodeResult,
    ctx_table,
    dd_ref,
    dd_sig,
    lane_numbps,
    local_pass_index,
    pass_is_raw,
    term_after,
)
from .ebcot_dec import LANE_ROWS, ebcot_decode_plain
from .mq import CTX_MR0, CTX_RL, CTX_UNI, MQEncoder, mq_table

# symbol record bit layout (kernel, plain scan and packers)
_VALID = 0x80
_RAW = 0x40
_CTXM = 0x1F


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def slot_counts(ns: int, w: int) -> tuple[int, int, int, int]:
    """Slots per pass for ns stripes of width w: (SPP, MRP, CUP, padded)."""
    s_spp = ns * w * 8  # (s, x, k) x (zc, sign)
    s_mrp = ns * w * 4  # (s, x, k)
    s_cup = ns * w * 11 + 4  # (s, x) x (rl, uni1, uni0, 4x(zc, sign)) + segsym
    s_pad = _round_up(max(s_spp, s_cup), 8)
    return s_spp, s_mrp, s_cup, s_pad


def max_bytes_for(pmax: int, h: int, w: int) -> int:
    """Per-lane segment capacity (the reference coders' bound)."""
    return max(64, (pmax * h * w) // 4 + 128)


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(f"{name}: want {dtype} {ndim}-d on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ===================================================== K-c: symbol scan
def ebcot_symbols(coeffs: torch.Tensor, lanes: torch.Tensor, tab: torch.Tensor,
                  pmaxc: int) -> torch.Tensor:
    """Symbol records [n, pmaxc, 3, s_pad] uint8 of a codeblock batch
    (codeblock-major, the layout the Pallas kernel emits).

    coeffs: [n, h, w] int32; lanes: [5, n] int32 rows numbps, height,
    width, orient, style; tab: [198] int32 (t1.ebcot.ctx_table)."""
    n, h, w = coeffs.shape
    dev = coeffs.device
    _check(coeffs, "coeffs", torch.int32, 3, dev)
    _check(lanes, "lanes", torch.int32, 2, dev)
    _check(tab, "tab", torch.int32, 1, dev)
    if lanes.shape != (5, n) or tab.shape != (198,) or pmaxc % 4:
        raise ValueError("lanes must be [5, n], tab [198], pmaxc a multiple of 4")
    if dev.type == "cpu":
        return ebcot_symbols_plain(coeffs, lanes, tab, pmaxc)
    if dev.type != "cuda":
        raise ValueError(f"ebcot_symbols: unsupported device {dev}")
    s_pad = slot_counts(_round_up(h, 4) // 4, w)[3]
    out = torch.empty((n, pmaxc, 3, s_pad), dtype=torch.uint8, device=dev)
    kernels.KERNELS["ebcot_symbols"].call(
        coeffs.data_ptr(), lanes.data_ptr(), tab.data_ptr(), out.data_ptr(),
        n, h, w, pmaxc, s_pad, kernels.stream_ptr(dev))
    return out


def ebcot_symbols_plain(coeffs: torch.Tensor, lanes: torch.Tensor,
                        tab: torch.Tensor, pmaxc: int) -> torch.Tensor:
    """Plain torch form of K-c: the scan of the Pallas kernel with the
    codeblock batch on the last axis, one stripe column (4 rows) per step.
    State planes [Hp+2, W+2, n]: significance S, sign contribution CV
    (0 or +-1), visited V, refined R. Within a column only the significance
    of the row above changes between rows, so everything but the SPP
    coding decisions is computed for the four rows at once. The records
    are built lane-minor and permuted to [n, pmaxc, 3, s_pad] at the end."""
    n, h, w = coeffs.shape
    dev = coeffs.device
    hp = _round_up(h, 4)
    ns = hp // 4
    s_spp, s_mrp, s_cup, s_pad = slot_counts(ns, w)
    nb, hgt, wid, orient, sty = (lanes[i].to(torch.int64) for i in range(5))
    tab = tab.to(torch.int64)
    zc_lut, scc_t, scx_t = tab[:180], tab[180:189], tab[189:198]
    o45 = orient * 45
    vsc = (sty & 0x08) != 0
    segsym = (sty & 0x20) != 0
    bypass = (sty & 0x01) != 0
    i64 = dict(dtype=torch.int64, device=dev)
    zero = torch.zeros(n, **i64)
    no = torch.zeros(n, dtype=torch.bool, device=dev)

    coef = torch.zeros((hp + 2, w + 2, n), **i64)
    coef[1:h + 1, 1:w + 1] = coeffs.permute(1, 2, 0)
    mag = coef.abs()
    sgn = (coef < 0).to(torch.int64)
    sgv = 1 - 2 * sgn  # the sign contribution once significant
    S = torch.zeros((hp + 2, w + 2, n), **i64)
    CV = torch.zeros_like(S)
    V = torch.zeros_like(S)
    R = torch.zeros_like(S)
    ys = torch.arange(hp, device=dev)[:, None, None]
    xs = torch.arange(w, device=dev)[None, :, None]
    in_blk = (ys < hgt) & (xs < wid)  # [hp, w, n]
    keep4 = torch.ones((4, n), **i64)
    keep4[3] = (~vsc).to(torch.int64)  # VSC: no significance from below
    kk = torch.arange(4, device=dev)[:, None]
    out = torch.zeros((pmaxc, 3, s_pad, n), dtype=torch.uint8, device=dev)

    def rec(valid, raw, bit, ctx):
        return ((valid.to(torch.int64) << 7) | ((raw & valid).to(torch.int64) << 6)
                | ((bit & 1) << 5) | ctx).to(torch.uint8)

    def column(y0, x):
        """Neighbourhood terms of the column's four rows that do not depend
        on the row above: (LUT index, count, sign index, views)."""
        Sw = S[y0:y0 + 6, x:x + 3]
        Cw = CV[y0:y0 + 6, x:x + 3]
        hh = Sw[1:5, 0] + Sw[1:5, 2]
        vdn = Sw[2:6, 1] * keep4
        dd = Sw[0:4, 0] + Sw[0:4, 2] + (Sw[2:6, 0] + Sw[2:6, 2]) * keep4
        hb = (Cw[1:5, 0] + Cw[1:5, 2]).clamp(-1, 1)
        return (o45 + hh * 15 + vdn * 5 + dd, hh + vdn + dd,
                hb * 3 + 4, Cw[2:6, 1] * keep4, Sw, Cw)

    def contexts(y0, x, part, hbp, cdn, Sw, Cw, sig_new, cv_new):
        """ZC and SC contexts of the four rows given the column's updates."""
        vup = torch.cat([Sw[0:1, 1], sig_new[:3]])
        cup = torch.cat([Cw[0:1, 1], cv_new[:3]])
        si = hbp + (cup + cdn).clamp(-1, 1)
        return zc_lut[part + vup * 5], scc_t[si], scx_t[si]

    def store(y0, x, sig_new, cv_new):
        S[y0 + 1:y0 + 5, x + 1] = sig_new
        CV[y0 + 1:y0 + 5, x + 1] = cv_new

    for p in range(pmaxc):
        plane = pmaxc - 1 - p
        spp_m = nb - 1 > plane
        cup_m = nb - 1 >= plane
        raw_spp = pass_is_raw(bypass, local_pass_index(plane, 0, nb), 0)
        raw_mrp = pass_is_raw(bypass, local_pass_index(plane, 1, nb), 1)
        bits = (mag >> plane) & 1
        inb_spp = in_blk & spp_m
        inb_cup = in_blk & cup_m

        # ---- SPP: a row is coded only with a significant neighbour, so
        # the decision chain runs row by row
        o = out[p, 0, :s_spp].view(ns, w, 4, 2, n)
        for s in range(ns):
            y0 = 4 * s
            for x in range(w):
                part, cnt, hbp, cdn, Sw, Cw = column(y0, x)
                sig4 = Sw[1:5, 1]
                b4 = bits[y0 + 1:y0 + 5, x + 1]
                vup = Sw[0, 1]
                codes, becs = [], []
                for k in range(4):
                    code = inb_spp[y0 + k, x] & (sig4[k] == 0) & (cnt[k] + vup > 0)
                    became = code & (b4[k] == 1)
                    vup = sig4[k] | became
                    codes.append(code)
                    becs.append(became)
                code4 = torch.stack(codes)
                bec4 = torch.stack(becs)
                sig_new = sig4 | bec4
                cv_new = torch.where(bec4, sgv[y0 + 1:y0 + 5, x + 1], Cw[1:5, 1])
                ctx, scc, xr = contexts(y0, x, part, hbp, cdn, Sw, Cw, sig_new, cv_new)
                sg = sgn[y0 + 1:y0 + 5, x + 1]
                o[s, x, :, 0] = rec(code4, raw_spp, b4, ctx)
                o[s, x, :, 1] = rec(bec4, raw_spp, torch.where(raw_spp, sg, sg ^ xr), scc)
                store(y0, x, sig_new, cv_new)
                V[y0 + 1:y0 + 5, x + 1] = code4

        # ---- MRP: no decision feeds another, one step for the plane
        Si = S[1:-1, 1:-1]
        cut = torch.zeros((hp, 1, n), dtype=torch.bool, device=dev)
        cut[3::4] = vsc
        ncnt = (S[1:-1, :-2] + S[1:-1, 2:] + S[:-2, 1:-1] + S[:-2, :-2] + S[:-2, 2:]
                + torch.where(cut, 0, S[2:, 1:-1] + S[2:, :-2] + S[2:, 2:]))
        code = inb_spp & (Si == 1) & (V[1:-1, 1:-1] == 0)
        ctx = torch.where(R[1:-1, 1:-1] == 1, CTX_MR0 + 2,
                          torch.where(ncnt > 0, CTX_MR0 + 1, CTX_MR0))
        r = rec(code, raw_mrp, bits[1:-1, 1:-1], ctx)  # [hp, w, n]
        out[p, 1, :s_mrp] = r.view(ns, 4, w, n).permute(0, 2, 1, 3).reshape(s_mrp, n)
        R[1:-1, 1:-1] |= code.to(torch.int64)

        # ---- CUP: a row's decision depends on its own state only; the
        # row above changes just its contexts
        o = out[p, 2, :ns * w * 11].view(ns, w, 11, n)
        for s in range(ns):
            y0 = 4 * s
            col_ok = ((y0 + 4) <= hgt) & cup_m
            for x in range(w):
                part, cnt, hbp, cdn, Sw, Cw = column(y0, x)
                sig4 = Sw[1:5, 1]
                vis4 = V[y0 + 1:y0 + 5, x + 1]
                b4 = bits[y0 + 1:y0 + 5, x + 1]
                free4 = (sig4 == 0) & (vis4 == 0)
                rl = (col_ok & (x < wid) & free4.all(0)
                      & ((cnt + Sw[0:4, 1]) == 0).all(0))
                hit = rl & (b4 == 1)
                fk = torch.where(hit[0], 0, torch.where(hit[1], 1, torch.where(
                    hit[2], 2, torch.where(hit[3], 3, 4))))
                sigcol = rl & (fk < 4)
                o[s, x, 0] = rec(rl, no, sigcol.to(torch.int64), zero + CTX_RL)
                o[s, x, 1] = rec(sigcol, no, (fk >> 1) & 1, zero + CTX_UNI)
                o[s, x, 2] = rec(sigcol, no, fk & 1, zero + CTX_UNI)
                implied = sigcol & (kk == fk)
                zc_code = (inb_cup[y0:y0 + 4, x] & free4 & ~(rl & ~sigcol)
                           & ~(sigcol & (kk < fk)) & ~implied)
                bec4 = (zc_code & (b4 == 1)) | implied
                sig_new = sig4 | bec4
                cv_new = torch.where(bec4, sgv[y0 + 1:y0 + 5, x + 1], Cw[1:5, 1])
                ctx, scc, xr = contexts(y0, x, part, hbp, cdn, Sw, Cw, sig_new, cv_new)
                o[s, x, 3::2] = rec(zc_code, no, b4, ctx)
                o[s, x, 4::2] = rec(bec4, no, sgn[y0 + 1:y0 + 5, x + 1] ^ xr, scc)
                store(y0, x, sig_new, cv_new)
        V.zero_()  # 'visited' restarts with the next plane
        seg = segsym & cup_m
        for j, b in enumerate((1, 0, 1, 0)):
            out[p, 2, ns * w * 11 + j] = rec(seg, no, zero + b, zero + CTX_UNI)
    return out.permute(3, 0, 1, 2).contiguous()


# ====================================================== K-d: MQ packer
def mq_pack(sym: torch.Tensor, numbps: torch.Tensor, styles: torch.Tensor,
            table: torch.Tensor, h: int, w: int, pmax: int):
    """Code the records into segments. Returns (buf [n, max_bytes + 2]
    uint8 with byte 0 the carry byte, lengths [n] int64, pass_rates
    [n, max(max_passes, 1)] int64); raises if a segment overflows."""
    n, pmaxc, three, s_pad = sym.shape
    dev = sym.device
    _check(sym, "sym", torch.uint8, 4, dev)
    _check(numbps, "numbps", torch.int32, 1, dev)
    _check(styles, "styles", torch.int32, 1, dev)
    _check(table, "table", torch.int32, 2, dev)
    hp = _round_up(h, 4)
    if three != 3 or s_pad != slot_counts(hp // 4, w)[3] or table.shape != (4, 47):
        raise ValueError("sym must be [n, pmaxc, 3, s_pad], table [4, 47]")
    if dev.type == "cpu":
        return mq_pack_plain(sym, numbps, styles, table, h, w, pmax)
    if dev.type != "cuda":
        raise ValueError(f"mq_pack: unsupported device {dev}")
    if sym.data_ptr() % 16:
        raise ValueError("mq_pack: sym must start on a 16-byte boundary")
    max_bytes = max_bytes_for(pmax, h, w)
    max_passes = max(3 * pmax - 2, 1)
    buf = torch.zeros((n, max_bytes + 2), dtype=torch.uint8, device=dev)
    lengths = torch.empty(n, dtype=torch.int64, device=dev)
    rates = torch.zeros((n, max_passes), dtype=torch.int64, device=dev)
    kernels.KERNELS["mq_pack"].call(
        sym.data_ptr(), numbps.data_ptr(), styles.data_ptr(), table.data_ptr(),
        buf.data_ptr(), lengths.data_ptr(), rates.data_ptr(), n, pmaxc, s_pad,
        hp // 4, w, max_bytes + 2, max_passes, kernels.stream_ptr(dev))
    if bool((lengths < 0).any()):
        raise RuntimeError("mq_pack: codeblock segment buffer overflow")
    return buf, lengths, rates


def mq_pack_plain(sym, numbps, styles, table, h: int, w: int, pmax: int):
    """Plain torch form of K-d: the lane-parallel ``_pack_symbols`` loop,
    slot rows with no valid record skipped."""
    n, pmaxc = sym.shape[:2]
    dev = sym.device
    ns = _round_up(h, 4) // 4
    s_spp, s_mrp, s_cup, _ = slot_counts(ns, w)
    nb = numbps.to(torch.int64)
    sty = styles.to(torch.int64)
    max_bytes = max_bytes_for(pmax, h, w)
    npasses = (nb * 3 - 2).clamp(min=0)
    max_passes = max(3 * pmax - 2, 1)
    mq = MQEncoder(n, max_bytes, table)
    rates = torch.zeros((n, max_passes), dtype=torch.int64, device=dev)
    termall = (sty & 0x04) != 0
    bypass = (sty & 0x01) != 0
    reset = (sty & 0x02) != 0
    last_term = torch.zeros(n, dtype=torch.bool, device=dev)

    def feed(stream):
        st = stream.T.to(torch.int64)  # [slots, n]
        kind = st & (_VALID | _RAW)
        any_mq = (kind == _VALID).any(dim=1).tolist()
        any_raw = (kind == (_VALID | _RAW)).any(dim=1).tolist()
        for i in range(st.shape[0]):
            if not (any_mq[i] or any_raw[i]):
                continue
            r = st[i]
            bit = (r >> 5) & 1
            if any_mq[i]:
                mq.encode(bit, r & _CTXM, kind[i] == _VALID)
            if any_raw[i]:
                mq.raw_bit(bit, kind[i] == (_VALID | _RAW))

    def end_pass(plane, kind, lane_mask):
        lpi = local_pass_index(plane, kind, nb)
        raw_m = pass_is_raw(bypass, lpi, kind) & lane_mask
        term_m = term_after(termall, bypass, lpi) & lane_mask
        r = torch.where(raw_m, mq.raw_safe_len(), mq.pos + (27 - mq.ct + 7) // 8)
        t_mq = term_m & ~raw_m
        t_raw = term_m & raw_m
        if bool(t_mq.any()):
            r = torch.where(t_mq, mq.terminate_restart(t_mq), r)
        if bool(t_raw.any()):
            r = torch.where(t_raw, mq.raw_terminate_restart_mq(t_raw), r)
        idx = lpi.clamp(0, max_passes - 1)[:, None]
        rates.scatter_(1, idx, torch.where(lane_mask, r, rates.gather(1, idx)[:, 0])[:, None])
        last_term.copy_(torch.where(lane_mask, term_m, last_term))
        mq.reset_ctx(reset & lane_mask)
        nxt_raw = pass_is_raw(bypass, lpi + 1, (kind + 1) % 3) & term_m
        if bool(nxt_raw.any()):
            mq.raw_start(nxt_raw)

    for plane in range(pmax - 1, -1, -1):
        pidx = pmaxc - 1 - plane
        spp_lanes = nb - 1 > plane
        cup_lanes = nb - 1 >= plane
        if bool(spp_lanes.any()):
            feed(sym[:, pidx, 0, :s_spp])
            end_pass(plane, 0, spp_lanes)
            feed(sym[:, pidx, 1, :s_mrp])
            end_pass(plane, 1, spp_lanes)
        if bool(cup_lanes.any()):
            feed(sym[:, pidx, 2, :s_cup])
            end_pass(plane, 2, cup_lanes)

    final_lpi = (npasses - 1).clamp(min=0)
    fkind = torch.where(final_lpi == 0, 2, torch.remainder(final_lpi - 1, 3))
    in_raw_tail = pass_is_raw(bypass, final_lpi, fkind) & ~last_term
    lengths = torch.where(last_term, rates.gather(1, final_lpi[:, None])[:, 0], 0)
    if bool(in_raw_tail.any()):
        lengths = torch.where(in_raw_tail, mq.raw_terminate_restart_mq(in_raw_tail), lengths)
    rest = ~last_term & ~in_raw_tail
    mq.flush(rest)
    lengths = torch.where(rest, mq.lengths(), lengths)
    lengths = torch.where(npasses > 0, lengths, 0)
    if bool((mq.overflow & (npasses > 0)).any()):
        raise RuntimeError("mq_pack: codeblock segment buffer overflow")
    rates.scatter_(1, final_lpi[:, None], lengths[:, None])
    rates = torch.minimum(rates, lengths[:, None])
    buf = torch.where((npasses > 0)[:, None], mq.buf, 0)
    return buf, lengths, rates


# ============================================ K-p: per-pass distortions
def ebcot_pass_dist(sym: torch.Tensor, coeffs: torch.Tensor, numbps: torch.Tensor,
                    pmax: int) -> torch.Tensor:
    """Distortion decrease per (codeblock, pass), float64 [n, max(3 pmax - 2,
    1)], from K-c's records [n, pmaxc, 3, s_pad] uint8 (16-byte aligned on
    the card), the coefficients [n, h, w] int32 and numbps [n] int32: each
    pass's sum equals the native host coder's float64 sum in slot order,
    bit for bit (on the card an exact int64 reduction where the bound of
    csrc/ebcot_dist.cu's header holds, its C entry ``ebcot_dist_exact``,
    the ordered chain elsewhere)."""
    n, h, w = coeffs.shape
    dev = coeffs.device
    _check(sym, "sym", torch.uint8, 4, dev)
    _check(coeffs, "coeffs", torch.int32, 3, dev)
    _check(numbps, "numbps", torch.int32, 1, dev)
    pmaxc, s_pad = sym.shape[1], sym.shape[3]
    if (sym.shape[0] != n or sym.shape[2] != 3 or numbps.shape != (n,) or pmax > pmaxc
            or s_pad != slot_counts(_round_up(h, 4) // 4, w)[3]):
        raise ValueError("sym must be [n, pmaxc >= pmax, 3, s_pad], numbps [n]")
    if dev.type == "cpu":
        return pass_dist_from_records(sym, coeffs, numbps, pmax)
    if dev.type != "cuda":
        raise ValueError(f"ebcot_pass_dist: unsupported device {dev}")
    if sym.data_ptr() % 16:
        raise ValueError("sym must be 16-byte aligned (the kernel reads 16-byte chunks)")
    max_passes = max(3 * pmax - 2, 1)
    dist = torch.empty((n, max_passes), dtype=torch.float64, device=dev)
    kernels.KERNELS["ebcot_pass_dist"].call(
        sym.data_ptr(), coeffs.data_ptr(), numbps.data_ptr(), dist.data_ptr(), n, pmaxc,
        s_pad, h, w, max_passes, kernels.stream_ptr(dev))
    return dist


def pass_dist_from_records(sym: torch.Tensor, coeffs: torch.Tensor,
                           numbps: torch.Tensor, pmax: int) -> torch.Tensor:
    """Plain form of K-p: per pass, the decreases of the records that
    became significant (SPP/CUP sign slots) or were refined (MRP slots),
    zero elsewhere, summed in slot order by a running sum (torch.cumsum,
    sequential on the CPU; on the card a parallel scan, the same sum while
    every partial sum is exact)."""
    n, h, w = coeffs.shape
    pmaxc = sym.shape[1]
    hp = _round_up(h, 4)
    ns = hp // 4
    s_spp, s_mrp, _, _ = slot_counts(ns, w)
    nb = numbps.to(torch.int64)
    max_passes = max(3 * pmax - 2, 1)
    magp = torch.zeros((n, hp, w), dtype=torch.int64, device=coeffs.device)
    magp[:, :h] = coeffs.abs()
    mag_sxk = magp.view(n, ns, 4, w).permute(0, 1, 3, 2).reshape(n, -1)
    dist = torch.zeros((n, max_passes), dtype=torch.float64, device=coeffs.device)

    def put(plane, kind, lanes, mask_ns, dd_fn):
        terms = torch.where(mask_ns, dd_fn(mag_sxk, plane), 0.0)
        dd = torch.cumsum(terms, dim=1)[:, -1]
        idx = local_pass_index(plane, kind, nb).clamp(0, max_passes - 1)[:, None]
        dist.scatter_(1, idx, torch.where(lanes, dd, dist.gather(1, idx)[:, 0])[:, None])

    for plane in range(pmax - 1, -1, -1):
        pidx = pmaxc - 1 - plane
        spp_lanes = nb - 1 > plane
        cup_lanes = nb - 1 >= plane
        became = (sym[:, pidx, 0, :s_spp].view(n, -1, 2)[:, :, 1] & _VALID) != 0
        put(plane, 0, spp_lanes, became, dd_sig)
        coded = (sym[:, pidx, 1, :s_mrp] & _VALID) != 0
        put(plane, 1, spp_lanes, coded, dd_ref)
        became = (sym[:, pidx, 2, :ns * w * 11].view(n, -1, 11)[:, :, 4::2] & _VALID) != 0
        put(plane, 2, cup_lanes, became.reshape(n, -1), dd_sig)
    return dist


# ==================================================== public entry point
def encode_cblks(coeffs: torch.Tensor, heights, widths, orients,
                 styles=None, clock: StageClock | None = None,
                 want_dist: bool = True) -> T1EncodeResult:
    """Encode a batch of codeblocks on the device holding ``coeffs``.

    coeffs: [N, H, W] int32 quantized coefficients (signed);
    heights/widths/orients/styles: [N] per-lane extents, band orientation
    codes and codeblock styles. The result's tensors stay on that device.
    ``clock`` (optional) charges the scan, the packer and the distortion
    sums to stages t1_symbols, t1_pack and t1_dist. Without ``want_dist``
    the per-pass distortions, which only a layer allocation reads, are not
    computed (pass_dist None)."""
    clock = clock or StageClock(coeffs.device, None)
    dev = coeffs.device
    coeffs = coeffs.to(torch.int32).contiguous()
    n, h, w = coeffs.shape
    as_i64 = lambda a: torch.as_tensor(a, device=dev).to(torch.int64)  # noqa: E731
    heights, widths, orients = as_i64(heights), as_i64(widths), as_i64(orients)
    sty = torch.zeros(n, dtype=torch.int64, device=dev) if styles is None \
        else as_i64(styles) & 0x3F
    numbps = lane_numbps(coeffs.abs(), heights, widths)
    pmax = int(numbps.max()) if n else 0
    npasses = (numbps * 3 - 2).clamp(min=0)
    if pmax == 0:
        buf = torch.zeros((n, max_bytes_for(0, h, w) + 2), dtype=torch.uint8, device=dev)
        return T1EncodeResult(
            data=buf[:, 1:], raw_data=(buf, 1),
            lengths=torch.zeros(n, dtype=torch.int64, device=dev),
            numbps=numbps, npasses=npasses,
            pass_rates=torch.zeros((n, 1), dtype=torch.int64, device=dev),
            pass_dist=torch.zeros((n, 1), dtype=torch.float64, device=dev) if want_dist
            else None)
    pmaxc = _round_up(pmax, 4)
    lanes = torch.stack([numbps, heights, widths, orients, sty]).to(torch.int32).contiguous()
    tabs = device_tables(dev)
    sym = ebcot_symbols(coeffs, lanes, tabs["ctx"], pmaxc)
    clock.mark("t1_symbols")
    buf, lengths, rates = mq_pack(sym, lanes[0].contiguous(), lanes[4].contiguous(),
                                  tabs["mq"], h, w, pmax)
    clock.mark("t1_pack")
    dist = None
    if want_dist:
        dist = ebcot_pass_dist(sym, coeffs, lanes[0].contiguous(), pmax)
        clock.mark("t1_dist")
    return T1EncodeResult(data=buf[:, 1:], raw_data=(buf, 1), lengths=lengths,
                          numbps=numbps, npasses=npasses, pass_rates=rates,
                          pass_dist=dist)


# ========================================================= K-i: decode
NUMBPS_LIMIT = 30  # 3 << 29 plus its refinements is the largest int32 magnitude
MAX_CBLK_SAMPLES = 4096  # T.800's bound on a codeblock's samples (xcb + ycb <= 12)
DEC_WARPS = 16  # codeblocks (warps) a CUDA block
DEC_CX_BYTES = 80  # CX_BYTES of csrc/ebcot_dec.cu: a warp's 19 context entries
DEC_MR_BYTES = 144  # MR_BYTES of csrc/ebcot_dec.cu: a warp's MRP chunk
DEC_TAB_BYTES = 3448  # the block's static tables in csrc/ebcot_dec.cu
DEC_SMEM_LIMIT = 232448  # shared memory a block may use on an H100 after opting in (227 KB)


@dataclass(frozen=True)
class DecLayout:
    """K-i's launch over one batch: a warp's shared state, from the batch's
    largest codeblock, and the block it sits in."""

    warps: int  # codeblocks a CUDA block
    warp_bytes: int  # contexts, MRP chunk, column bits, stripe words and a byte for each
    col_stripes: int  # stripes of column bits a warp holds (codeblocks of width <= 64)
    smem: int  # dynamic shared bytes a block (the static tables come on top)


def dec_layout(max_samples: int, max_words: int, col_stripes: int,
               warps: int = DEC_WARPS) -> DecLayout:
    """The shared memory of a K-i launch whose largest codeblock has
    ``max_samples`` samples and ``max_words`` stripe words (ceil(h / 4) * w),
    and whose codeblocks of width 64 or less have at most ``col_stripes``
    stripes. Blocks shrink to the warps whose state fits DEC_SMEM_LIMIT.
    Raises ValueError for a codeblock over MAX_CBLK_SAMPLES samples."""
    if max_samples > MAX_CBLK_SAMPLES:
        raise ValueError(f"ebcot_decode: codeblocks of at most {MAX_CBLK_SAMPLES} samples")
    warp_bytes = _round_up(DEC_CX_BYTES + DEC_MR_BYTES + 16 * col_stripes
                           + 5 * max_words, 16)
    warps = min(warps, (DEC_SMEM_LIMIT - DEC_TAB_BYTES) // warp_bytes)
    if warps < 1:  # not for any codeblock of MAX_CBLK_SAMPLES or fewer
        raise ValueError("ebcot_decode: a codeblock's state exceeds shared memory")
    return DecLayout(warps, warp_bytes, col_stripes, warps * warp_bytes)


def dec_block_warps(n: int, sms: int) -> int:
    """Codeblocks a block for a batch of n on ``sms`` SMs: DEC_WARPS, or
    fewer where that leaves SMs without a block, so a small batch (one
    tile's) runs its chains on every SM and not a few to an SM."""
    return max(1, min(DEC_WARPS, n // max(sms, 1)))


def dec_waves(n: int, warps: int, blocks_per_sm: int, sms: int) -> int:
    """Waves of a launch of n codeblocks, ``warps`` a block, with
    ``blocks_per_sm`` blocks resident on each of ``sms`` SMs."""
    return -(-n // (warps * max(blocks_per_sm, 1) * sms)) if n else 0


def dec_order(lengths: torch.Tensor, waves: int) -> torch.Tensor | None:
    """The codeblock each warp decodes: longest first by segment bytes
    (ties in batch order) when the batch takes more than one wave, so the
    longest chains start first and the short ones fill the tail; None
    (batch order) in one wave."""
    if waves <= 1:
        return None
    return torch.sort(lengths, descending=True, stable=True).indices.to(torch.int32)


def dec_flat(data: torch.Tensor) -> torch.Tensor:
    """The flat buffer as the kernel takes it: 4-aligned and a multiple of
    4 bytes long, at least 4, so an aligned word that holds a readable byte
    lies inside it; else a copy padded with zeros, which no segment reads
    (every byte past a codeblock's own reads 0xFF)."""
    n = data.numel()
    if n >= 4 and n % 4 == 0 and data.data_ptr() % 4 == 0:
        return data
    out = torch.zeros(max(_round_up(n, 4), 4), dtype=torch.uint8, device=data.device)
    out[:n] = data
    return out


_RESIDENT: dict[tuple, int] = {}


def dec_blocks_per_sm(layout: DecLayout) -> int:
    """Blocks of ``layout`` resident on one SM of the current card
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), cached."""
    import ctypes

    key = (layout.warps, layout.smem)
    got = _RESIDENT.get(key)
    if got is None:
        fn = kernels.library("ebcot_dec.cu").ebcot_decode_occupancy
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        rc = fn(layout.warps, layout.smem, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"ebcot_decode_occupancy: CUDA error {rc}")
        got = _RESIDENT[key] = out.value
    return got


@dataclass(frozen=True)
class DecPlan:
    """How K-i launches one batch on the card."""

    layout: DecLayout
    sms: int
    blocks_per_sm: int  # blocks of the layout resident on one SM
    waves: int
    order: torch.Tensor | None  # the codeblock each warp decodes (dec_order)


def dec_launch_plan(lanes: torch.Tensor) -> DecPlan:
    """K-i's launch over the batch of ``lanes`` ([7, n] int32 on a card):
    the shared-memory layout of its largest codeblock, the blocks resident
    on an SM, the waves and the launch order. Raises ValueError for a
    codeblock over MAX_CBLK_SAMPLES samples."""
    n = lanes.shape[1]
    hw = lanes[2:4].to(torch.int64)
    stripes = (hw[0] + 3) // 4
    max_samples, max_words, col_stripes = torch.stack([
        (hw[0] * hw[1]).max(), (stripes * hw[1]).max(),
        torch.where(hw[1] <= 64, stripes, 0).max()]).tolist()
    sms = torch.cuda.get_device_properties(lanes.device).multi_processor_count
    layout = dec_layout(max_samples, max_words, col_stripes, dec_block_warps(n, sms))
    blocks = dec_blocks_per_sm(layout)
    waves = dec_waves(n, layout.warps, blocks, sms)
    return DecPlan(layout, sms, blocks, waves, dec_order(lanes[6], waves))


def ebcot_decode(data: torch.Tensor, starts: torch.Tensor, lanes: torch.Tensor,
                 seg_lengths: torch.Tensor, ctx_tab: torch.Tensor, mq_tab: torch.Tensor,
                 bh: int, bw: int) -> torch.Tensor:
    """Coefficients int32 [n, bh, bw] of a Part-1 codeblock batch.

    data: uint8 [total], the codeblocks' bytes back to back; starts: int64
    [n]; lanes: int32 [7, n] with rows t1.ebcot_dec.LANE_ROWS (numbps,
    npasses, height, width, orient, style, length); seg_lengths: int32
    [n, max_segs >= 1], the merged codeword segment lengths of TERMALL and
    BYPASS codeblocks; ctx_tab: int32 [198]; mq_tab: int32 [4, 47].
    Raises UnsupportedFeatureError for numbps > NUMBPS_LIMIT, ValueError for
    a codeblock over MAX_CBLK_SAMPLES samples."""
    n = lanes.shape[1]
    dev = data.device
    _check(data, "data", torch.uint8, 1, dev)
    _check(starts, "starts", torch.int64, 1, dev)
    _check(lanes, "lanes", torch.int32, 2, dev)
    _check(seg_lengths, "seg_lengths", torch.int32, 2, dev)
    _check(ctx_tab, "ctx_tab", torch.int32, 1, dev)
    _check(mq_tab, "mq_tab", torch.int32, 2, dev)
    if (lanes.shape != (len(LANE_ROWS), n) or starts.shape != (n,)
            or seg_lengths.shape[0] != n or seg_lengths.shape[1] < 1
            or ctx_tab.shape != (198,) or mq_tab.shape != (4, 47)):
        raise ValueError("lanes must be [7, n], starts [n], seg_lengths [n, >= 1], "
                         "ctx_tab [198], mq_tab [4, 47]")
    if n and int(lanes[0].max()) > NUMBPS_LIMIT:
        raise UnsupportedFeatureError(
            f"Part-1 decode of more than {NUMBPS_LIMIT} magnitude bit-planes")
    if dev.type == "cpu":
        return ebcot_decode_plain(data, starts, lanes, seg_lengths, ctx_tab, mq_tab, bh, bw)
    if dev.type != "cuda":
        raise ValueError(f"ebcot_decode: unsupported device {dev}")
    out = torch.zeros((n, bh, bw), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    plan = dec_launch_plan(lanes)
    lay = plan.layout
    data = dec_flat(data)
    args = (data.data_ptr(), data.numel(), starts.data_ptr(), lanes.data_ptr(),
            seg_lengths.data_ptr(), ctx_tab.data_ptr(), mq_tab.data_ptr(),
            0 if plan.order is None else plan.order.data_ptr(), out.data_ptr(), n,
            seg_lengths.shape[1], bh, bw, lay.warps, lay.warp_bytes, lay.col_stripes,
            kernels.stream_ptr(dev))
    kernels.KERNELS["ebcot_decode"].call(*args)
    return out


def decode_cblks(data: torch.Tensor, starts, lanes, seg_lengths, bh: int, bw: int,
                 clock: StageClock | None = None):
    """Decode a Part-1 codeblock batch on the device holding ``data``
    (counterpart of ebcot_np/ebcot_jax ``decode_cblks``): (coefficients
    int32 [n, bh, bw], planes_decoded [n]). ``starts``, ``lanes`` and
    ``seg_lengths`` as for ``ebcot_decode``, in any integer type; the stage
    is t1_dec."""
    clock = clock or StageClock(data.device, None)
    dev = data.device
    as32 = lambda a: torch.as_tensor(a, device=dev).to(torch.int32).contiguous()  # noqa: E731
    lanes = as32(lanes)
    tabs = device_tables(dev)
    out = ebcot_decode(data.contiguous(), torch.as_tensor(starts, device=dev).to(torch.int64),
                       lanes, as32(seg_lengths), tabs["ctx"], tabs["mq"], bh, bw)
    clock.mark("t1_dec")
    planes = torch.minimum((lanes[1] + 2) // 3, lanes[0])
    return out, planes


_TABLES: dict[str, dict[str, torch.Tensor]] = {}


def device_tables(dev: torch.device) -> dict[str, torch.Tensor]:
    """The coding tables on ``dev``, copied there once."""
    key = str(dev)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = {"ctx": ctx_table().to(dev), "mq": mq_table().to(dev).contiguous()}
    return t

