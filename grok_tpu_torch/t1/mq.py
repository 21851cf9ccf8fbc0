"""MQ arithmetic coder tables (ITU-T T.88 / T.800 Annex C) and the
lane-parallel torch MQ encoder; counterpart of grok_tpu/t1/mq_np.py.

``MQEncoder`` keeps one coder per codeblock with all registers in [N]
tensors, so each decision is a handful of masked tensor ops across the
block batch. It is the plain version behind the symbol packer kernel
(t1/ebcot_cuda.py ``mq_pack``) and follows the scalar coder of
csrc/mq_pack.cu step for step, including its bounded output buffer.
"""

from __future__ import annotations

import torch

# T.88 Table E.1 - probability state machine.
QE = torch.tensor([
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
    0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
    0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
    0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601,
], dtype=torch.int64)
NMPS = torch.tensor([
    1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
    37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46,
], dtype=torch.int64)
NLPS = torch.tensor([
    1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16,
    17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46,
], dtype=torch.int64)
SWITCH = torch.tensor([
    1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
], dtype=torch.int64)

# Context indices (19 contexts, T.800 D.2).
NUM_CTX = 19
CTX_ZC0 = 0  # zero coding, zero-neighborhood context
CTX_MR0 = 14  # first magnitude-refinement context
CTX_RL = 17  # run-length (aggregation) context
CTX_UNI = 18  # uniform context

# initial state per context: all 0 except ZC0 -> 4, RL -> 3, UNI -> 46
INIT_STATES = torch.zeros(NUM_CTX, dtype=torch.int64)
INIT_STATES[CTX_ZC0] = 4
INIT_STATES[CTX_RL] = 3
INIT_STATES[CTX_UNI] = 46


def mq_table(qe=QE, nmps=NMPS, nlps=NLPS, switch=SWITCH) -> torch.Tensor:
    """The four state-machine columns as one int32 [4, 47] tensor, the
    layout the packer kernel loads into shared memory."""
    return torch.stack([qe, nmps, nlps, switch]).to(torch.int32)


class MQEncoder:
    """N independent MQ encoders advancing in lockstep.

    ``buf`` is [N, max_bytes + 2]; byte 0 of each lane absorbs carry
    propagation. A write that would reach the last column sets the lane's
    ``overflow`` flag instead (the kernel's bounds check)."""

    def __init__(self, n: int, max_bytes: int, table: torch.Tensor):
        dev = table.device
        self.n = n
        t = table.to(torch.int64)
        self.qe_t, self.nmps_t, self.nlps_t, self.sw_t = t[0], t[1], t[2], t[3]
        self.a = torch.full((n,), 0x8000, dtype=torch.int64, device=dev)
        self.c = torch.zeros(n, dtype=torch.int64, device=dev)
        self.ct = torch.full((n,), 12, dtype=torch.int64, device=dev)
        self.cap = max_bytes + 2
        self.buf = torch.zeros((n, self.cap), dtype=torch.uint8, device=dev)
        self.pos = torch.zeros(n, dtype=torch.int64, device=dev)
        self.overflow = torch.zeros(n, dtype=torch.bool, device=dev)
        self._init_states = INIT_STATES.to(dev)
        self.state = self._init_states.repeat(n, 1)
        self.mps = torch.zeros((n, NUM_CTX), dtype=torch.int64, device=dev)
        self.lanes = torch.arange(n, device=dev)
        self.raw_tmp = torch.zeros(n, dtype=torch.int64, device=dev)
        self.raw_used = torch.zeros(n, dtype=torch.int64, device=dev)
        self.raw_avail = torch.full((n,), 8, dtype=torch.int64, device=dev)

    # -- byte buffer ---------------------------------------------------
    def _cur(self) -> torch.Tensor:
        return self.buf[self.lanes, self.pos].to(torch.int64)

    def _set_cur(self, val: torch.Tensor, mask: torch.Tensor) -> None:
        old = self.buf[self.lanes, self.pos]
        self.buf[self.lanes, self.pos] = torch.where(mask, val.to(torch.uint8), old)

    def _push(self, val: torch.Tensor, mask: torch.Tensor) -> None:
        ok = mask & (self.pos + 1 < self.cap)
        self.overflow |= mask & ~ok
        wpos = torch.where(ok, self.pos + 1, self.pos)
        old = self.buf[self.lanes, wpos]
        self.buf[self.lanes, wpos] = torch.where(ok, (val & 0xFF).to(torch.uint8), old)
        self.pos = wpos

    def reset_ctx(self, mask: torch.Tensor) -> None:
        """Per-lane context reset (RESET codeblock style)."""
        m = mask[:, None]
        self.state = torch.where(m, self._init_states, self.state)
        self.mps = torch.where(m, 0, self.mps)

    # -- coder -----------------------------------------------------------
    def _byteout(self, mask: torch.Tensor) -> None:
        if not bool(mask.any()):
            return
        b = self._cur()
        c = self.c
        carry = mask & (b != 0xFF) & ((c & 0x8000000) != 0)
        b = torch.where(carry, (b + 1) & 0xFF, b)
        self._set_cur(b, carry)
        c = torch.where(carry & (b == 0xFF), c & 0x7FFFFFF, c)
        is_ff = b == 0xFF
        self._push(torch.where(is_ff, c >> 20, c >> 19), mask)
        self.c = torch.where(mask, torch.where(is_ff, c & 0xFFFFF, c & 0x7FFFF), self.c)
        self.ct = torch.where(mask, torch.where(is_ff, 7, 8), self.ct)

    def _renorm(self, mask: torch.Tensor) -> None:
        """Shift A up to >= 0x8000 (at least once), emitting a byte each
        time CT runs out; done in at most three CT-bounded shift runs."""
        if not bool(mask.any()):
            return
        _, e = torch.frexp(self.a.to(torch.float32))
        left = torch.where(mask, 16 - e.to(torch.int64), 0)
        act = mask
        while True:
            s = torch.where(act, torch.minimum(left, self.ct), 0)
            self.a = self.a << s
            self.c = self.c << s
            self.ct = self.ct - s
            left = left - s
            self._byteout(act & (self.ct == 0))
            act = left > 0
            if not bool(act.any()):
                return

    def encode(self, bit: torch.Tensor, ctx: torch.Tensor, mask: torch.Tensor) -> None:
        """Encode one decision per masked lane; bit/ctx are [N] int64."""
        ci = ctx[:, None]
        st = self.state.gather(1, ci)[:, 0]
        mps = self.mps.gather(1, ci)[:, 0]
        qe = self.qe_t[st]
        is_mps = (bit == mps) & mask
        is_lps = (bit != mps) & mask
        a_sub = self.a - qe
        low = a_sub < qe
        renorm_mps = is_mps & ((a_sub & 0x8000) == 0)
        add_c = (is_mps & ~(renorm_mps & low)) | (is_lps & low)
        self.c = torch.where(add_c, self.c + qe, self.c)
        new_st = torch.where(renorm_mps, self.nmps_t[st],
                             torch.where(is_lps, self.nlps_t[st], st))
        self.state.scatter_(1, ci, new_st[:, None])
        sw = is_lps & (self.sw_t[st] == 1)
        self.mps.scatter_(1, ci, torch.where(sw, 1 - mps, mps)[:, None])
        a = torch.where(mask, a_sub, self.a)
        self.a = torch.where((renorm_mps & low) | (is_lps & ~low), qe, a)
        self._renorm(renorm_mps | is_lps)

    def flush(self, mask: torch.Tensor) -> None:
        """Standard FLUSH termination for the masked lanes."""
        tempc = self.c + self.a
        c = self.c | 0xFFFF
        c = torch.where(c >= tempc, c - 0x8000, c)
        self.c = torch.where(mask, c, self.c)
        for _ in range(2):
            self.c = torch.where(mask, (self.c << self.ct) & 0xFFFFFFFF, self.c)
            self._byteout(mask)

    def lengths(self) -> torch.Tensor:
        """Stream length per lane (current byte included unless 0xFF)."""
        return self.pos + (self._cur() != 0xFF).to(torch.int64) - 1

    def _restart(self, mask: torch.Tensor) -> None:
        self.a = torch.where(mask, 0x8000, self.a)
        self.c = torch.where(mask, 0, self.c)
        self.ct = torch.where(mask, torch.where(self._cur() == 0xFF, 13, 12), self.ct)

    def terminate_restart(self, mask: torch.Tensor) -> torch.Tensor:
        """FLUSH + restart the masked lanes; returns the stream lengths."""
        self.flush(mask)
        lens = self.lengths()
        self.pos = torch.where(mask, lens, self.pos)
        self._restart(mask)
        return lens

    # -- raw (bypass) emission -------------------------------------------
    def raw_start(self, mask: torch.Tensor) -> None:
        self.raw_tmp = torch.where(mask, 0, self.raw_tmp)
        self.raw_used = torch.where(mask, 0, self.raw_used)
        self.raw_avail = torch.where(mask, torch.where(self._cur() == 0xFF, 7, 8),
                                     self.raw_avail)

    def raw_bit(self, bits: torch.Tensor, mask: torch.Tensor) -> None:
        """MSB-first raw bit with 0xFF stuffing (bypass segments)."""
        self.raw_tmp = torch.where(mask, (self.raw_tmp << 1) | bits, self.raw_tmp)
        self.raw_used = torch.where(mask, self.raw_used + 1, self.raw_used)
        emit = mask & (self.raw_used == self.raw_avail)
        self._push(self.raw_tmp, emit)
        self.raw_avail = torch.where(emit, torch.where(self._cur() == 0xFF, 7, 8),
                                     self.raw_avail)
        self.raw_tmp = torch.where(emit, 0, self.raw_tmp)
        self.raw_used = torch.where(emit, 0, self.raw_used)

    def raw_safe_len(self) -> torch.Tensor:
        return self.pos + (self.raw_used > 0).to(torch.int64)

    def raw_terminate_restart_mq(self, mask: torch.Tensor) -> torch.Tensor:
        """Byte-align raw segments and restart MQ; returns stream lengths."""
        pend = mask & (self.raw_used > 0)
        self._push(self.raw_tmp << (self.raw_avail - self.raw_used), pend)
        self._push(torch.zeros_like(self.pos), mask & (self._cur() == 0xFF))
        lens = self.pos.clone()
        self._restart(mask)
        self.raw_used = torch.where(mask, 0, self.raw_used)
        self.raw_tmp = torch.where(mask, 0, self.raw_tmp)
        return lens


def packed_transitions(table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The state machine over packed context values v = state << 1 | mps:
    Qe of v, v after an MPS renormalisation (NMPS) and v after an LPS
    (NLPS, with the MPS sense switched where SWITCH says); int64 [94]."""
    t = table.to(torch.int64)
    qe, nmps, nlps, sw = t[0], t[1], t[2], t[3]
    st = torch.arange(2 * qe.numel(), device=t.device) >> 1
    mps = torch.arange(2 * qe.numel(), device=t.device) & 1
    return qe[st], (nmps[st] << 1) | mps, (nlps[st] << 1) | (mps ^ sw[st])


class MQDecoder:
    """N independent MQ decoders advancing in lockstep; counterpart of
    grok_tpu/t1/mq_np.py MQDecoder (T.800 C.3).

    Lane i owns the bytes ``data[starts[i] : starts[i] + totals[i]]`` of
    one flat uint8 buffer and decodes the segment of ``lengths[i]`` bytes
    at its start. Reads past the current segment's end (or past the
    lane's bytes) give 0xFF, as in the reference. Each context holds
    ``state << 1 | mps`` in one int64; registers are int64 lanes with C
    masked to 32 bits where the reference masks it."""

    def __init__(self, data: torch.Tensor, starts: torch.Tensor, totals: torch.Tensor,
                 lengths: torch.Tensor, table: torch.Tensor):
        dev = data.device
        self.n = n = starts.numel()
        self.data = data if data.numel() else torch.full((1,), 0xFF, dtype=torch.uint8,
                                                         device=dev)
        self.starts = starts.to(torch.int64)
        self.totals = totals.to(torch.int64)
        self.qe_v, self.nm_v, self.nl_v = packed_transitions(table.to(dev))
        self.lanes19 = torch.arange(n, device=dev) * NUM_CTX
        self._init_cx = (INIT_STATES << 1).to(dev)
        self.cx = self._init_cx.repeat(n, 1)
        zero = torch.zeros(n, dtype=torch.int64, device=dev)
        self.base = zero.clone()
        self.end = lengths.to(torch.int64).clone()
        self.bp, self.c, self.ct, self.a = zero.clone(), zero.clone(), zero.clone(), zero.clone()
        self.rbase, self.rend, self.rpos = zero.clone(), zero.clone(), zero.clone()
        self.rtmp, self.rbits = zero.clone(), zero.clone()
        self.rprev_ff = torch.zeros(n, dtype=torch.bool, device=dev)
        self._prime(torch.ones(n, dtype=torch.bool, device=dev))

    def _byte(self, base: torch.Tensor, idx: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
        """Byte idx of the segment at base (end bytes long), 0xFF past it."""
        pos = base + idx
        ok = (idx < end) & (pos < self.totals)
        flat = (self.starts + pos).clamp(0, self.data.numel() - 1)
        return torch.where(ok, self.data[flat].to(torch.int64), 0xFF)

    def _bytein(self, mask: torch.Tensor) -> None:
        b = self._byte(self.base, self.bp, self.end)
        b1 = self._byte(self.base, self.bp + 1, self.end)
        is_ff = b == 0xFF
        marker = is_ff & (b1 > 0x8F)  # a marker (or the end): feed 1 bits
        add = torch.where(marker, 0xFF00, b1 << torch.where(is_ff, 9, 8))
        self.c = torch.where(mask, self.c + add, self.c)
        self.ct = torch.where(mask, torch.where(is_ff & ~marker, 7, 8), self.ct)
        self.bp = torch.where(mask & ~marker, self.bp + 1, self.bp)

    def _prime(self, mask: torch.Tensor) -> None:
        """INITDEC on the current segment of the masked lanes."""
        self.bp = torch.where(mask, 0, self.bp)
        b0 = self._byte(self.base, torch.zeros_like(self.bp), self.end)
        self.c = torch.where(mask, b0 << 16, self.c)
        self._bytein(mask)
        self.c = torch.where(mask, (self.c << 7) & 0xFFFFFFFF, self.c)
        self.ct = torch.where(mask, self.ct - 7, self.ct)
        self.a = torch.where(mask, 0x8000, self.a)

    def reset_ctx(self, mask: torch.Tensor) -> None:
        """Per-lane context reset (RESET codeblock style)."""
        self.cx = torch.where(mask[:, None], self._init_cx, self.cx)

    def init_registers(self, mask: torch.Tensor, base: torch.Tensor,
                       seg_len: torch.Tensor) -> None:
        """Re-prime the masked lanes on a new codeword segment at byte
        ``base`` of their data; the context states persist."""
        if not bool(mask.any()):
            return
        self.base = torch.where(mask, base, self.base)
        self.end = torch.where(mask, seg_len, self.end)
        self._prime(mask)

    def raw_init(self, mask: torch.Tensor, base: torch.Tensor, seg_len: torch.Tensor) -> None:
        """Start a raw (BYPASS) segment at byte ``base`` for the masked lanes."""
        self.rbase = torch.where(mask, base, self.rbase)
        self.rend = torch.where(mask, seg_len, self.rend)
        self.rpos = torch.where(mask, 0, self.rpos)
        self.rtmp = torch.where(mask, 0, self.rtmp)
        self.rbits = torch.where(mask, 0, self.rbits)
        self.rprev_ff = self.rprev_ff & ~mask

    def raw_bit(self, mask: torch.Tensor) -> torch.Tensor:
        """One raw bit per masked lane, MSB first; a byte after 0xFF gives
        7 bits, and 0xFF is read past the segment's end."""
        need = mask & (self.rbits == 0)
        if bool(need.any()):
            b = self._byte(self.rbase, self.rpos, self.rend)
            self.rpos = torch.where(need, self.rpos + 1, self.rpos)
            self.rbits = torch.where(need, torch.where(self.rprev_ff, 7, 8), self.rbits)
            self.rprev_ff = torch.where(need, b == 0xFF, self.rprev_ff)
            self.rtmp = torch.where(need, b, self.rtmp)
        self.rbits = torch.where(mask, self.rbits - 1, self.rbits)
        return torch.where(mask, (self.rtmp >> self.rbits.clamp(min=0)) & 1, 0)

    def _renorm(self, mask: torch.Tensor) -> None:
        """Shift A up to >= 0x8000, reading a byte each time CT is 0 before
        a shift; done in CT-bounded runs (at most three, one when no lane
        runs out of bits)."""
        _, e = torch.frexp(self.a.to(torch.float32))
        left = torch.where(mask, 16 - e.to(torch.int64), 0)
        if not bool((left > self.ct).any()):
            self.a = self.a << left
            self.c = (self.c << left) & 0xFFFFFFFF
            self.ct = self.ct - left
            return
        act = mask
        while True:
            refill = act & (self.ct == 0)
            if bool(refill.any()):
                self._bytein(refill)
            s = torch.where(act, torch.minimum(left, self.ct), 0)
            self.a = self.a << s
            self.c = (self.c << s) & 0xFFFFFFFF
            self.ct = self.ct - s
            left = left - s
            act = left > 0
            if not bool(act.any()):
                return

    def decode(self, ctx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Decode one decision per masked lane in context ctx ([N] int64);
        returns the bits, 0 on unmasked lanes."""
        if not bool(mask.any()):
            return torch.zeros(self.n, dtype=torch.int64, device=mask.device)
        flat = self.cx.view(-1)
        idx = self.lanes19 + ctx
        v = flat[idx]
        qe = self.qe_v[v]
        a = self.a - qe
        lps = ((self.c >> 16) & 0xFFFF) < qe
        low = a < qe
        renorm = mask & (lps | (a < 0x8000))
        lpsym = renorm & (lps != low)  # the decoded bit is the LPS
        flat[idx] = torch.where(renorm, torch.where(lpsym, self.nl_v[v], self.nm_v[v]), v)
        self.c = torch.where(mask & ~lps, self.c - (qe << 16), self.c)
        self.a = torch.where(mask, torch.where(lps, qe, a), self.a)
        self._renorm(renorm)
        return torch.where(mask, (v & 1) ^ lpsym.to(torch.int64), 0)
