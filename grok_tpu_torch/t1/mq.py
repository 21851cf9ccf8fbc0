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
