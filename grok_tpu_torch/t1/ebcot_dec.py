"""Plain torch form of K-i ``ebcot_decode``: the Part-1 (MQ) codeblock
decoder (T.800 Annex D), lane-parallel over a codeblock batch.

Counterpart of grok_tpu/t1/ebcot_np.py ``decode_cblks`` (:354) with the
decode halves of ``_spp`` (:463), ``_mrp`` (:530) and ``_cup`` (:581):
every pass scans the batch's stripes column by column, each decision is a
masked tensor step across the codeblocks, and the MQ and raw decoders
(t1/mq.py ``MQDecoder``) keep one lane per codeblock. Its inputs are the
kernel's (t1/ebcot_cuda.py ``ebcot_decode``): one flat byte buffer with
each codeblock's start, and the merged codeword segment lengths of the
TERMALL and BYPASS codeblocks.

An ROI shift s rides style bits 8-15 (the reference's tile_processor.py
:986-997): magnitudes of at least 1 << s in the scaled domain shift down
by s before the halving, as ebcot_np.py:447-455 and the native decoder do.

State planes are lane-minor, [hp + 2, w + 2, n] with a one-sample border:
significance S, sign contribution CV (+1 or -1 once significant), visited
V, refined R, magnitudes MAG in the scaled-by-2 domain (a sample that
becomes significant at plane p gets 3 << p, a refinement adds or takes
1 << p, the result is halved at the end: mid-bin reconstruction). The
zero-coding neighbourhood Z (15 per horizontal, 5 per vertical, 1 per
diagonal significant neighbour, i.e. the index h*15 + v*5 + d of the ZC
table) and the sign sums HS, VS are kept up to date as samples become
significant, VSC's cut included, so a step reads its contexts directly.
"""

from __future__ import annotations

import torch

from .ebcot import local_pass_index, pass_is_raw, term_after
from .mq import CTX_MR0, CTX_RL, CTX_UNI, MQDecoder

LANE_ROWS = ("numbps", "npasses", "height", "width", "orient", "style", "length")
# styles that split a codeblock's bytes into several codeword segments
SEGMENTED = 0x04 | 0x01  # TERMALL, BYPASS


def ebcot_decode_plain(data: torch.Tensor, starts: torch.Tensor, lanes: torch.Tensor,
                       seg_lengths: torch.Tensor, ctx_tab: torch.Tensor, mq_tab: torch.Tensor,
                       bh: int, bw: int) -> torch.Tensor:
    """Coefficients int32 [n, bh, bw] of a codeblock batch (zeros outside
    each codeblock's height x width).

    data: uint8 [total]; starts: int64 [n], the first byte of each
    codeblock; lanes: int32 [7, n], rows LANE_ROWS; seg_lengths: int32
    [n, max_segs], the merged segment lengths of TERMALL/BYPASS
    codeblocks; ctx_tab: int32 [198] (t1.ebcot.ctx_table); mq_tab: int32
    [4, 47] (t1.mq.mq_table)."""
    n = lanes.shape[1]
    dev = data.device
    nb, npass, hgt, wid, orient, sty, length = (lanes[i].to(torch.int64) for i in range(7))
    pmax = int(nb.max()) if n else 0
    hp = -(-bh // 4) * 4
    w = bw
    i64 = dict(dtype=torch.int64, device=dev)
    if pmax <= 0:
        return torch.zeros((n, bh, bw), dtype=torch.int32, device=dev)
    tab = ctx_tab.to(torch.int64)
    zc_lut, scc_t, scx_t = tab[:180], tab[180:189], tab[189:198]
    o45 = orient * 45
    keep = ((sty & 0x08) == 0).to(torch.int64)  # VSC: no significance from below
    reset = (sty & 0x02) != 0
    segsym = (sty & 0x20) != 0
    termall = (sty & 0x04) != 0
    bypass = (sty & 0x01) != 0
    segmented = (sty & SEGMENTED) != 0
    segl = seg_lengths.to(torch.int64)
    nseg = segl.shape[1]
    lane_ix = torch.arange(n, device=dev)
    mq = MQDecoder(data, starts, length, torch.where(segmented, segl[:, 0], length), mq_tab)
    seg_i = torch.zeros(n, **i64)
    seg_off = torch.zeros(n, **i64)

    shape = (hp + 2, w + 2, n)
    S, CV, V, R, MAG, Z, HS, VS = (torch.zeros(shape, **i64) for _ in range(8))
    ys = torch.arange(hp, device=dev)[:, None, None]
    xs = torch.arange(w, device=dev)[None, :, None]
    in_blk = (ys < hgt) & (xs < wid)  # [hp, w, n]
    wrow = torch.tensor([1, 5, 1], **i64)[:, None]
    wtop0 = wrow * keep  # row above a stripe's first row: cut under VSC

    def became_at(py: int, px: int, k: int, became, neg, plane: int) -> None:
        """Make the masked lanes' sample significant; update the context
        sums of its neighbours."""
        e = became.to(torch.int64)
        cv = torch.where(neg, -e, e)
        S[py, px] |= e
        CV[py, px] += cv
        MAG[py, px] = torch.where(became, 3 << plane, MAG[py, px])
        Z[py - 1, px - 1:px + 2] += (wtop0 if k == 0 else wrow) * e
        Z[py, px - 1:px + 2:2] += 15 * e
        Z[py + 1, px - 1:px + 2] += wrow * e
        HS[py, px - 1:px + 2:2] += cv
        VS[py + 1, px] += cv
        VS[py - 1, px] += cv * keep if k == 0 else cv

    def decide(ctx, mask, raw, raw_any: bool):
        bit = mq.decode(ctx, mask & ~raw) if raw_any else mq.decode(ctx, mask)
        if raw_any:
            rm = mask & raw
            if bool(rm.any()):
                bit = torch.where(rm, mq.raw_bit(rm), bit)
        return bit

    def sign(py: int, px: int, became, raw, raw_any: bool):
        """Negative-sign mask of the samples that became significant."""
        si = (HS[py, px].clamp(-1, 1) + 1) * 3 + VS[py, px].clamp(-1, 1) + 1
        d = decide(scc_t[si], became, raw, raw_any)
        # a raw sign bit is the sign itself; an MQ one is xored with the
        # sign-coding predictor
        return torch.where(raw, d, d ^ scx_t[si]) == 1

    def spp(plane: int, act, raw, raw_any: bool) -> None:
        for y0 in range(0, hp, 4):
            rows = min(4, bh - y0)
            cand = (act[y0:y0 + rows] & (S[y0 + 1:y0 + 1 + rows, 1:w + 1] == 0)
                    & (Z[y0 + 1:y0 + 1 + rows, 1:w + 1] > 0)).any(-1).any(0).tolist()
            force = False
            for x in range(w):
                if not (cand[x] or force):
                    continue
                force = False
                px = x + 1
                for k in range(rows):
                    py = y0 + k + 1
                    code = act[y0 + k, x] & (S[py, px] == 0) & (Z[py, px] > 0)
                    if not bool(code.any()):
                        continue
                    bit = decide(zc_lut[o45 + Z[py, px]], code, raw, raw_any)
                    V[py, px] |= code.to(torch.int64)
                    became = code & (bit == 1)
                    if bool(became.any()):
                        became_at(py, px, k, became, sign(py, px, became, raw, raw_any),
                                  plane)
                        force = True

    def mrp(plane: int, act, raw, raw_any: bool) -> None:
        step = 1 << plane
        for y0 in range(0, hp, 4):
            rows = min(4, bh - y0)
            blk = (act[y0:y0 + rows] & (S[y0 + 1:y0 + 1 + rows, 1:w + 1] == 1)
                   & (V[y0 + 1:y0 + 1 + rows, 1:w + 1] == 0))  # static in the pass
            for x, k in blk.any(-1).T.nonzero().tolist():
                py, px = y0 + k + 1, x + 1
                code = blk[k, x]
                ctx = torch.where(R[py, px] == 1, CTX_MR0 + 2,
                                  torch.where(Z[py, px] > 0, CTX_MR0 + 1, CTX_MR0))
                bit = decide(ctx, code, raw, raw_any)
                MAG[py, px] += torch.where(code, torch.where(bit == 1, step, -step), 0)
                R[py, px] |= code.to(torch.int64)

    no = torch.zeros(n, dtype=torch.bool, device=dev)
    rl_ctx = torch.full((n,), CTX_RL, **i64)
    uni_ctx = torch.full((n,), CTX_UNI, **i64)

    def cup(plane: int, act, lanes_m) -> None:
        for y0 in range(0, hp, 4):
            rows = min(4, bh - y0)
            full = (y0 + 4 <= hgt) & lanes_m
            for x in range(w):
                px = x + 1
                sl = slice(y0 + 1, y0 + 1 + rows)
                free = act[y0:y0 + rows, x] & (S[sl, px] == 0) & (V[sl, px] == 0)
                if not bool(free.any()):
                    continue
                sigcol = None
                skip = no
                if rows == 4:
                    rl = full & (x < wid) & (free & (Z[sl, px] == 0)).all(0)
                    if bool(rl.any()):
                        rl_bit = mq.decode(rl_ctx, rl)
                        sigcol = rl & (rl_bit == 1)
                        skip = rl & (rl_bit == 0)
                        if bool(sigcol.any()):
                            b1 = mq.decode(uni_ctx, sigcol)
                            b0 = mq.decode(uni_ctx, sigcol)
                            fk = torch.where(sigcol, b1 * 2 + b0, 4)
                        else:
                            sigcol = None
                for k in range(rows):
                    py = y0 + k + 1
                    zc_code = free[k] & ~skip
                    implied = no
                    if sigcol is not None:
                        # before the run's first significant sample: implied
                        # zero; at it: significant without a ZC decision
                        implied = sigcol & (fk == k)
                        zc_code = zc_code & ~(sigcol & (fk >= k))
                    became = implied
                    if bool(zc_code.any()):
                        bit = mq.decode(zc_lut[o45 + Z[py, px]], zc_code)
                        became = became | (zc_code & (bit == 1))
                    if bool(became.any()):
                        became_at(py, px, k, became, sign(py, px, became, no, False), plane)
        seg = segsym & lanes_m  # SEGSYM: four UNIFORM decisions, dropped
        for _ in range(4):
            mq.decode(uni_ctx, seg)

    def next_segment(lpi, lanes_m) -> None:
        """Lanes whose pass ended a codeword segment re-prime the MQ decoder,
        or start a raw segment, on the next merged segment."""
        adv = lanes_m & segmented & term_after(termall, bypass, lpi) & (lpi + 1 < npass)
        if not bool(adv.any()):
            return
        cur = segl[lane_ix, seg_i.clamp(max=nseg - 1)]
        seg_off.add_(torch.where(adv, cur, 0))
        seg_i.add_(adv.to(torch.int64))
        nxt = torch.where(seg_i < nseg, segl[lane_ix, seg_i.clamp(max=nseg - 1)], 0)
        nlpi = lpi + 1
        nraw = pass_is_raw(bypass, nlpi, torch.where(nlpi == 0, 2, torch.remainder(nlpi - 1, 3)))
        mq.raw_init(adv & nraw, seg_off, nxt)
        mq.init_registers(adv & ~nraw, seg_off, nxt)

    def end_pass(lpi, lanes_m) -> None:
        mq.reset_ctx(reset & lanes_m)
        next_segment(lpi, lanes_m)

    for plane in range(pmax - 1, -1, -1):
        lp = [local_pass_index(plane, kind, nb) for kind in range(3)]
        coded = nb - 1 > plane
        for kind, fn in ((0, spp), (1, mrp)):
            lanes_m = coded & (lp[kind] < npass)
            if bool(lanes_m.any()):
                raw = pass_is_raw(bypass, lp[kind], kind) & lanes_m
                fn(plane, in_blk & lanes_m, raw, bool(raw.any()))
                end_pass(lp[kind], lanes_m)
        lanes_m = ((nb - 1 >= plane) & (lp[2] < npass))
        if bool(lanes_m.any()):
            cup(plane, in_blk & lanes_m, lanes_m)
            end_pass(lp[2], lanes_m)
        V.zero_()  # 'visited' restarts with the next plane

    # the ROI downshift (style bits 8-15) in the scaled domain, before the
    # half bit is dropped (ebcot_np.py:447-455)
    m2 = MAG[1:bh + 1, 1:bw + 1]
    rs = (sty >> 8) & 0xFF
    if bool((rs > 0).any()):
        sh = rs.clamp(max=31)
        m2 = torch.where((rs > 0) & (rs < 32) & (m2 >= (torch.ones_like(sh) << sh)),
                         m2 >> sh, m2)
    mag = m2 >> 1
    out = torch.where(CV[1:bh + 1, 1:bw + 1] < 0, -mag, mag)
    return out.permute(2, 0, 1).to(torch.int32).contiguous()
