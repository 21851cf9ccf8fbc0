"""HTJ2K (FBCOT) cleanup-pass block coder, ITU-T T.814: the scalar host
coder and its tables; counterpart of grok_tpu/t1/ht.py (:24-632).

Segment layout (Dcup): [MagSgn fwd][MEL fwd][VLC bwd], with the 12-bit
interface locator word Scup = len(MEL) + len(VLC) packed into the last 12
bits of the segment. This module is the oracle of the two HT kernels
(t1/ht_cuda.py): their plain versions call ``encode_cleanup`` and
``decode_cleanup`` block by block. The SigProp/MagRef refinement passes
are not ported.
"""

from __future__ import annotations

import numpy as np

from .ht_tables_data import TABLE0, TABLE1

# the widest MagSgn field a decode reads (native/ht_coder.cpp decode_block)
MS_BITS = 32
# MEL run-length state machine exponents (T.814 Table C.3)
MEL_EXP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5]


# --------------------------------------------------------------- VLC tables
def _build_enc_table(src):
    """2048-entry LUT keyed (c_q<<8)|(rho<<4)|emb -> (cwd<<8)|(len<<4)|e_k.

    For emb != 0 pick the entry with u_off=1 whose (e_k, e_1) is consistent
    with the emb pattern, preferring the most e_k bits; for emb == 0 pick
    the u_off=0 entry (T.814 C.3.4 selection rule)."""
    tbl = [0] * 2048
    for i in range(2048):
        c_q, rho, emb = i >> 8, (i >> 4) & 0xF, i & 0xF
        if (emb & rho) != emb or (rho == 0 and c_q == 0):
            continue
        best = None
        if emb:
            best_ones = -1
            for (ec, erho, u_off, e_k, e_1, cwd, ln) in src:
                if ec == c_q and erho == rho and u_off == 1 and (emb & e_k) == e_1:
                    ones = bin(e_k).count("1")
                    if ones >= best_ones:
                        best = (cwd, ln, e_k)
                        best_ones = ones
        else:
            for (ec, erho, u_off, e_k, e_1, cwd, ln) in src:
                if ec == c_q and erho == rho and u_off == 0:
                    best = (cwd, ln, e_k)
                    break
        assert best is not None, (c_q, rho, emb)
        tbl[i] = (best[0] << 8) | (best[1] << 4) | best[2]
    return tbl


def _build_dec_table(src):
    """Per-context 128-entry LUT over 7 LSB-first bits ->
    (rho, u_off, e_k, e_1, cwd_len)."""
    tbl = [[None] * 128 for _ in range(8)]
    for (c_q, rho, u_off, e_k, e_1, cwd, ln) in src:
        for v in range(128):
            if (v & ((1 << ln) - 1)) == cwd:
                tbl[c_q][v] = (rho, u_off, e_k, e_1, ln)
    return tbl


ENC_TBL = (_build_enc_table(TABLE0), _build_enc_table(TABLE1))
DEC_TBL = (_build_dec_table(TABLE0), _build_dec_table(TABLE1))

# UVLC prefix/suffix codes (LSB-first codewords), T.814 C.3.5
_U_PRE = [0, 1, 2, 4, 4] + [0] * 28
_U_PRE_LEN = [0, 1, 2, 3, 3] + [3] * 28
_U_SUF = [0, 0, 0, 0, 1] + list(range(28))
_U_SUF_LEN = [0, 0, 0, 1, 1] + [5] * 28


# ------------------------------------------------------------ bit machines
class MelEnc:
    def __init__(self):
        self.bytes = bytearray()
        self.tmp = 0
        self.rem = 8
        self.run = 0
        self.k = 0
        self.threshold = 1

    def _bit(self, v):
        self.tmp = (self.tmp << 1) | v
        self.rem -= 1
        if self.rem == 0:
            self.bytes.append(self.tmp)
            self.rem = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def encode(self, bit):
        if not bit:
            self.run += 1
            if self.run >= self.threshold:
                self._bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
                self.threshold = 1 << MEL_EXP[self.k]
        else:
            self._bit(0)
            t = MEL_EXP[self.k]
            while t > 0:
                t -= 1
                self._bit((self.run >> t) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)
            self.threshold = 1 << MEL_EXP[self.k]


class VlcEnc:
    """Backward-growing LSB-first writer with the >0x8F stuffing rule."""

    def __init__(self):
        self.bytes = bytearray([0xFF])  # grows towards the front (we append)
        self.tmp = 0xF  # the 4 pre-filled locator bits
        self.used = 4
        self.last_gt_8f = True

    def encode(self, cwd, ln):
        while ln > 0:
            avail = 8 - (1 if self.last_gt_8f else 0) - self.used
            t = min(avail, ln)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            avail -= t
            ln -= t
            cwd >>= t
            if avail == 0:
                if self.last_gt_8f and self.tmp != 0x7F:
                    self.last_gt_8f = False
                    continue  # one more usable bit in this byte
                self.bytes.append(self.tmp)
                self.last_gt_8f = self.tmp > 0x8F
                self.tmp = 0
                self.used = 0

    def tail_bytes(self) -> bytes:
        """Bytes in stream order (last-emitted first)."""
        return bytes(reversed(self.bytes))


class MsEnc:
    """Forward LSB-first writer with 0xFF stuffing."""

    def __init__(self):
        self.bytes = bytearray()
        self.max_bits = 8
        self.used = 0
        self.tmp = 0

    def encode(self, cwd, ln):
        while ln > 0:
            t = min(self.max_bits - self.used, ln)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            cwd >>= t
            ln -= t
            if self.used >= self.max_bits:
                self.bytes.append(self.tmp)
                self.max_bits = 7 if self.tmp == 0xFF else 8
                self.tmp = 0
                self.used = 0

    def terminate(self):
        if self.used:
            t = self.max_bits - self.used
            self.tmp |= (0xFF & ((1 << t) - 1)) << self.used
            self.used += t
            if self.tmp != 0xFF:
                self.bytes.append(self.tmp)
        elif self.max_bits == 7:
            # last written byte was 0xFF with nothing after: drop it (the
            # decoder pads 0xFF beyond the segment end)
            self.bytes.pop()


def _terminate_mel_vlc(mel: MelEnc, vlc: VlcEnc) -> tuple[bytes, bytes]:
    if mel.run > 0:
        mel._bit(1)
    mel_tmp = (mel.tmp << mel.rem) & 0xFF
    mel_mask = (0xFF << mel.rem) & 0xFF
    vlc_mask = 0xFF >> (8 - vlc.used) if vlc.used else 0
    if (mel_mask | vlc_mask) != 0:
        fuse = mel_tmp | vlc.tmp
        if (((fuse ^ mel_tmp) & mel_mask) | ((fuse ^ vlc.tmp) & vlc_mask)) == 0 \
                and fuse != 0xFF and len(vlc.bytes) > 1:
            return bytes(mel.bytes) + bytes([fuse]), vlc.tail_bytes()
        return bytes(mel.bytes) + bytes([mel_tmp]), bytes([vlc.tmp]) + vlc.tail_bytes()
    return bytes(mel.bytes), vlc.tail_bytes()


# ================================================================== encoder
def encode_cleanup(coeffs: np.ndarray, h: int, w: int) -> bytes:
    """Encode one codeblock's quantized coefficients (signed ints) as an HT
    cleanup codeword segment."""
    mel = MelEnc()
    vlc = VlcEnc()
    ms = MsEnc()

    mag = np.abs(coeffs[:h, :w].astype(np.int64))  # |-2^31| is 2^31
    sgn = (coeffs[:h, :w] < 0).astype(np.int64)
    nqw = (w + 1) // 2  # quads per row

    def sample(qy, qx, k):
        # quad sample order: 0 TL, 1 BL, 2 TR, 3 BR
        y = 2 * qy + (k & 1)
        x = 2 * qx + (k >> 1)
        if y >= h or x >= w:
            return 0, 0
        return int(mag[y, x]), int(sgn[y, x])

    prev_e = [0] * (nqw + 2)  # E line buffer (above row)
    prev_cx = [0] * (nqw + 2)  # significance line buffer
    for qy in range((h + 1) // 2):
        line0 = qy == 0
        tbl = ENC_TBL[0] if line0 else ENC_TBL[1]
        cur_e = [0] * (nqw + 2)
        cur_cx = [0] * (nqw + 2)
        c_left = 0  # context contribution carried from the left quad
        for qx in range(0, nqw, 2):
            u_vals = []
            for qi in (qx, qx + 1):
                if qi >= nqw:
                    u_vals.append(0)
                    continue
                rho, emax = 0, 0
                e_q = [0, 0, 0, 0]
                s_q = [0, 0, 0, 0]
                for k in range(4):
                    mu, s = sample(qy, qi, k)
                    if mu:
                        rho |= 1 << k
                        e_q[k] = (2 * mu - 1).bit_length()
                        emax = max(emax, e_q[k])
                        s_q[k] = 2 * (mu - 1) + s
                if line0:
                    c_q = c_left
                    kappa = 1
                else:
                    c_q = prev_cx[qi] + (prev_cx[qi + 1] << 2) + c_left
                    max_e = max(prev_e[qi], prev_e[qi + 1]) - 1
                    kappa = max(1, max_e) if (rho & (rho - 1)) else 1
                uq = max(emax, kappa)
                u = uq - kappa
                eps = 0
                if u > 0:
                    for k in range(4):
                        eps |= (e_q[k] == emax) << k
                tup = tbl[(c_q << 8) + (rho << 4) + eps]
                vlc.encode(tup >> 8, (tup >> 4) & 7)
                if c_q == 0:
                    mel.encode(rho != 0)
                for k in range(4):
                    if rho & (1 << k):
                        m = uq - ((tup >> k) & 1)
                        ms.encode(s_q[k] & ((1 << m) - 1), m)
                # line buffers for the next quad row
                cur_e[qi] = max(cur_e[qi], e_q[1])
                cur_e[qi + 1] = e_q[3]
                cur_cx[qi] |= (rho & 2) >> 1
                cur_cx[qi + 1] = (rho & 8) >> 3
                # context carried to the quad on the right
                if line0:
                    c_left = (rho >> 1) | (rho & 1)
                else:
                    c_left = ((rho & 4) >> 1) | ((rho & 8) >> 2)
                u_vals.append(u)

            u0, u1 = u_vals
            if line0:
                if u0 > 0 and u1 > 0:
                    mel.encode(min(u0, u1) > 2)
                if u0 > 2 and u1 > 2:
                    vlc.encode(_U_PRE[u0 - 2], _U_PRE_LEN[u0 - 2])
                    vlc.encode(_U_PRE[u1 - 2], _U_PRE_LEN[u1 - 2])
                    vlc.encode(_U_SUF[u0 - 2], _U_SUF_LEN[u0 - 2])
                    vlc.encode(_U_SUF[u1 - 2], _U_SUF_LEN[u1 - 2])
                    continue
                if u0 > 2 and u1 > 0:
                    vlc.encode(_U_PRE[u0], _U_PRE_LEN[u0])
                    vlc.encode(u1 - 1, 1)
                    vlc.encode(_U_SUF[u0], _U_SUF_LEN[u0])
                    continue
            vlc.encode(_U_PRE[u0], _U_PRE_LEN[u0])
            vlc.encode(_U_PRE[u1], _U_PRE_LEN[u1])
            vlc.encode(_U_SUF[u0], _U_SUF_LEN[u0])
            vlc.encode(_U_SUF[u1], _U_SUF_LEN[u1])
        prev_e = cur_e
        prev_cx = cur_cx

    mel_bytes, vlc_bytes = _terminate_mel_vlc(mel, vlc)
    ms.terminate()
    scup = len(mel_bytes) + len(vlc_bytes)
    seg = bytearray(bytes(ms.bytes) + mel_bytes + vlc_bytes)
    seg[-1] = (scup >> 4) & 0xFF
    seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
    return bytes(seg)


# ================================================================== decoder
class MelDec:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.tmp = 0
        self.bits = 0
        self.prev_ff = False
        self.k = 0
        self.zeros = 0  # pending zero events
        self.one = False  # a one event after them

    def _bit(self) -> int:
        if self.bits == 0:
            if self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
            else:
                b = 0xFF
            self.bits = 7 if self.prev_ff else 8
            self.prev_ff = b == 0xFF
            self.tmp = b
        self.bits -= 1
        return (self.tmp >> self.bits) & 1

    def event(self) -> int:
        """Next MEL event (0 or 1)."""
        if not self.zeros and not self.one:
            if self._bit():
                self.zeros = 1 << MEL_EXP[self.k]
                self.k = min(12, self.k + 1)
            else:
                run = 0
                for _ in range(MEL_EXP[self.k]):
                    run = (run << 1) | self._bit()
                self.k = max(0, self.k - 1)
                self.zeros, self.one = run, True
        if self.zeros:
            self.zeros -= 1
            return 0
        self.one = False
        return 1


class VlcDec:
    """Backward LSB-first reader; mirrors VlcEnc stuffing."""

    def __init__(self, data: bytes):
        # data = MEL+VLC chunk in stream order; VLC reads from the END
        # backwards. The last byte holds locator bits only; the second-to-
        # last byte's low nibble is locator, its high nibble starts the VLC
        # payload (3 bits only if its low 3 bits are all ones -- the
        # encoder's sentinel-stuffed first byte).
        self.data = data
        self.pos = len(data) - 2
        d = data[self.pos] if self.pos >= 0 else 0
        self.pos -= 1
        self.bits = 4 - (1 if ((d >> 4) & 7) == 7 else 0)
        # only ``bits`` bits of the nibble are payload (the reference's native
        # decoder masks the rest; a valid stream has a zero there)
        self.tmp = (d >> 4) & ((1 << self.bits) - 1)
        self.unstuff = (d | 0xF) > 0x8F

    def _read_byte(self):
        if self.pos >= 0:
            b = self.data[self.pos]
            self.pos -= 1
        else:
            b = 0
        # when the later (previously read) byte is > 0x8F and this byte's
        # low 7 bits are all ones, only 7 bits are payload
        nbits = 7 if self.unstuff and (b & 0x7F) == 0x7F else 8
        self.unstuff = b > 0x8F
        return b & ((1 << nbits) - 1), nbits

    def _fill(self, need):
        while self.bits < need:
            b, nbits = self._read_byte()
            self.tmp |= b << self.bits
            self.bits += nbits

    def peek(self, n) -> int:
        self._fill(n)
        return self.tmp & ((1 << n) - 1)

    def advance(self, n):
        self._fill(n)
        self.tmp >>= n
        self.bits -= n

    def read(self, n) -> int:
        v = self.peek(n)
        self.advance(n)
        return v


class MsDec:
    """Forward LSB-first reader with 0xFF unstuffing; pads 0xFF beyond end."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.tmp = 0
        self.bits = 0
        self.prev_ff = False

    def _fill(self, need):
        while self.bits < need:
            nbits = 7 if self.prev_ff else 8
            if self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
            else:
                b = 0xFF
            self.prev_ff = b == 0xFF
            self.tmp |= (b & ((1 << nbits) - 1)) << self.bits
            self.bits += nbits

    def read(self, n) -> int:
        if n == 0:
            return 0
        self._fill(n)
        v = self.tmp & ((1 << n) - 1)
        self.tmp >>= n
        self.bits -= n
        return v


def _dec_u_pair(vlc: VlcDec, line0: bool, u_off0: int, u_off1: int,
                mel: MelDec) -> tuple[int, int]:
    """Decode the u values for a quad pair (mirrors the encoder cases)."""

    def read_prefix():
        # LSB-first prefix codes: 1 -> 1, 01 -> 2, 001 -> 3, 000 -> 5
        # (5 marks the 5-bit-suffix escape)
        if vlc.read(1):
            return 1
        if vlc.read(1):
            return 2
        return 3 if vlc.read(1) else 5

    def read_suffix(pre):
        if pre == 3:
            return 3 + vlc.read(1)
        if pre == 5:
            return 5 + vlc.read(5)
        return pre

    if line0 and u_off0 and u_off1:
        if mel.event():
            p0 = read_prefix()
            p1 = read_prefix()
            return read_suffix(p0) + 2, read_suffix(p1) + 2
        p0 = read_prefix()
        if p0 > 2:
            # u0 > 2: then u1 is 1 or 2, one bit
            u1 = 1 + vlc.read(1)
            return read_suffix(p0), u1
        p1 = read_prefix()
        return read_suffix(p0), read_suffix(p1)
    p0 = read_prefix() if u_off0 else 0
    p1 = read_prefix() if u_off1 else 0
    u0 = read_suffix(p0) if u_off0 else 0
    u1 = read_suffix(p1) if u_off1 else 0
    return u0, u1


def decode_cleanup(seg: bytes, h: int, w: int) -> tuple[np.ndarray, bool]:
    """Decode an HT cleanup codeword segment into signed coefficients, as
    grok_tpu's default decoder does (native/ht_coder.cpp decode_block):
    returns (coefficients, whole). An invalid CxtVLC codeword or a MagSgn
    field over MS_BITS bits stops the decode there (whole False), keeping
    what was written; an invalid header (Scup outside [2, Lcup]) gives
    zeros. Values are exact here; the int32 output wraps them."""
    out = np.zeros((h, w), dtype=np.int64)
    if len(seg) < 2:
        return out, True
    scup = (seg[-1] << 4) | (seg[-2] & 0xF)
    if scup < 2 or scup > len(seg):
        return out, False
    ms = MsDec(seg[: len(seg) - scup])
    mel = MelDec(seg[len(seg) - scup:])
    vlc = VlcDec(seg[len(seg) - scup:])

    nqw = (w + 1) // 2
    prev_e = [0] * (nqw + 2)
    prev_cx = [0] * (nqw + 2)
    for qy in range((h + 1) // 2):
        line0 = qy == 0
        tbl = DEC_TBL[0] if line0 else DEC_TBL[1]
        cur_e = [0] * (nqw + 2)
        cur_cx = [0] * (nqw + 2)
        c_left = 0
        for qx in range(0, nqw, 2):
            quads = []  # (rho, u_off, e_k, e_1, kappa)
            for qi in (qx, qx + 1):
                if qi >= nqw:
                    quads.append(None)
                    continue
                if line0:
                    c_q = c_left
                else:
                    c_q = prev_cx[qi] + (prev_cx[qi + 1] << 2) + c_left
                if c_q == 0 and not mel.event():
                    rho, u_off, e_k, e_1 = 0, 0, 0, 0
                else:
                    entry = tbl[c_q][vlc.peek(7)]
                    if entry is None:
                        return out, False  # invalid codeword
                    rho, u_off, e_k, e_1, ln = entry
                    vlc.advance(ln)
                if line0 or not (rho & (rho - 1)):
                    kappa = 1
                else:
                    kappa = max(1, max(prev_e[qi], prev_e[qi + 1]) - 1)
                quads.append((rho, u_off, e_k, e_1, kappa))
                if line0:
                    c_left = (rho >> 1) | (rho & 1)
                else:
                    c_left = ((rho & 4) >> 1) | ((rho & 8) >> 2)

            u_off0 = quads[0][1]
            u_off1 = quads[1][1] if quads[1] else 0
            us = _dec_u_pair(vlc, line0, u_off0, u_off1, mel)

            for j, u in enumerate(us):
                qi = qx + j
                q = quads[j]
                if q is None:
                    continue
                rho, u_off, e_k, e_1, kappa = q
                uq = kappa + u
                e_bl = e_br = 0
                for k in range(4):
                    if not (rho & (1 << k)):
                        continue
                    m = uq - ((e_k >> k) & 1)
                    if m > MS_BITS:
                        return out, False
                    v = ms.read(m) | (((e_1 >> k) & 1) << m)
                    mu = (v >> 1) + 1
                    e_n = (v | 1).bit_length()
                    y = 2 * qy + (k & 1)
                    x = 2 * qi + (k >> 1)
                    if y < h and x < w:
                        out[y, x] = -mu if v & 1 else mu
                    if k == 1:
                        e_bl = e_n
                    elif k == 3:
                        e_br = e_n
                cur_e[qi] = max(cur_e[qi], e_bl)
                cur_e[qi + 1] = e_br
                cur_cx[qi] |= (rho & 2) >> 1
                cur_cx[qi + 1] = (rho & 8) >> 3
        prev_e = cur_e
        prev_cx = cur_cx
    return out, True
