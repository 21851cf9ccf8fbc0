"""HTJ2K cleanup coder on the GPU: encode kernel K-e and decode kernel K-f.

Counterpart of grok_tpu/t1/ht_jax.py (K3, ``encode_cblks`` :638) and
grok_tpu/t1/ht_jax_dec.py (K4, ``decode_cleanup_batch`` :484). K-e
``ht_cleanup_enc`` (csrc/ht_enc.cu) writes each codeblock's finished
cleanup segment, stuffing, termination and the Scup patch included, so no
host compaction follows it. K-f ``ht_cleanup_dec`` (csrc/ht_dec.cu) reads
each segment directly and writes what the scalar decoder gives: on a
corrupt segment (an invalid codeword, or a MagSgn field over 32 bits) it
stops where grok_tpu's default decoder stops, keeping what was written,
and flags the codeblock.

Each kernel's plain version runs the scalar coder of t1/ht.py block by
block. A wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..core.timing import StageClock
from . import ht
from .ebcot import T1EncodeResult
from .ebcot_cuda import _check

# int32 table layout of csrc/ht_enc.cu and csrc/ht_dec.cu
_T_ENC, _T_DEC, _T_MEL_EXP, _T_U = 0, 4096, 6144, 6157
TABLE_SIZE = _T_U + 4 * 33

def dec_tbl_array(dec_tbl) -> np.ndarray:
    """DEC_TBL ([2][8][128] of (rho, u_off, e_k, e_1, len) or None) as an
    int64 array [2, 8, 128, 5], -1 where a codeword is invalid."""
    return np.array([[[e if e is not None else (-1,) * 5 for e in ctx] for ctx in t]
                     for t in dec_tbl], dtype=np.int64)


def pack_ht_tables(mel_exp, enc_tbl, dec_tbl, u_pre, u_pre_len, u_suf,
                   u_suf_len) -> torch.Tensor:
    """The kernels' int32 table [TABLE_SIZE]: ENC_TBL [2][2048], DEC_TBL
    packed rho | u_off << 4 | e_k << 5 | e_1 << 9 | len << 13 (-1 when
    invalid), MEL_EXP [13], then the four u-code tables [33] each."""
    enc = np.asarray(enc_tbl, dtype=np.int64)
    dec = dec_tbl_array(dec_tbl)
    if enc.shape != (2, 2048) or dec.shape != (2, 8, 128, 5) or len(mel_exp) != 13 \
            or any(len(t) != 33 for t in (u_pre, u_pre_len, u_suf, u_suf_len)):
        raise ValueError("HT table shapes differ from the reference's")
    packed = (dec[..., 0] | (dec[..., 1] << 4) | (dec[..., 2] << 5) | (dec[..., 3] << 9)
              | (dec[..., 4] << 13))
    packed = np.where(dec[..., 4] < 0, -1, packed)
    flat = np.concatenate([enc.reshape(-1), packed.reshape(-1), mel_exp,
                           u_pre, u_pre_len, u_suf, u_suf_len]).astype(np.int32)
    return torch.from_numpy(flat)


_TABLES: dict[str, torch.Tensor] = {}


def ht_tables(dev: torch.device) -> torch.Tensor:
    """The port's HT tables (t1/ht.py) in the kernels' layout on ``dev``."""
    key = str(dev)
    if key not in _TABLES:
        _TABLES[key] = pack_ht_tables(ht.MEL_EXP, ht.ENC_TBL, ht.DEC_TBL, ht._U_PRE,
                                      ht._U_PRE_LEN, ht._U_SUF, ht._U_SUF_LEN).to(dev)
    return _TABLES[key]


def segment_capacity(bh: int, bw: int, mmax: int) -> tuple[int, int]:
    """(segment bytes, MEL + VLC scratch bytes) that a bh x bw codeblock
    whose MagSgn fields are at most ``mmax`` bits can need: at most mmax
    MagSgn bits a sample, 15 VLC bits a quad (a 7-bit CxtVLC codeword, half
    a pair's 16 u-code bits) and 9 MEL bits a quad (1.5 events of at most
    6 bits), each stream at least 7 payload bits a byte."""
    nq = ((bh + 1) // 2) * ((bw + 1) // 2)
    aux = -(-(nq * 15 + 16) // 7) + -(-(nq * 9 + 12) // 7) + 16
    return -(-(bh * bw * mmax) // 7) + aux + 16, aux


# ==================================================== K-e: cleanup encode
ENC_WARPS = 16  # codeblocks (warps) a CUDA block of K-e (PERF.md §6: chip_smoke.py --ke-warps)


def _occupancy(source: str, entry: str, *shape: int) -> tuple[int, int]:
    """(blocks resident on one SM, shared bytes a block) of a launch of the
    given shape (its int arguments), as the C entry ``entry`` of csrc/
    ``source`` answers it (cudaOccupancyMaxActiveBlocksPerMultiprocessor on
    the current card)."""
    import ctypes

    fn = getattr(kernels.library(source), entry)
    fn.argtypes = [ctypes.c_int] * len(shape) + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(*shape, ctypes.byref(blocks), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    return blocks.value, smem.value


def enc_occupancy(bw: int, warps: int) -> tuple[int, int]:
    """_occupancy of a K-e launch (a codeblock a warp)."""
    return _occupancy("ht_enc.cu", "ht_enc_occupancy", bw, warps)


def ht_cleanup_enc(coeffs: torch.Tensor, heights: torch.Tensor, widths: torch.Tensor,
                   tab: torch.Tensor, mmax: int, want_energy: bool = False):
    """Cleanup segments of a codeblock batch: (buf [n, cap] uint8, zero
    past each segment, lengths [n] int64; 0 for an empty or all-zero
    codeblock), and with ``want_energy`` a third item, each codeblock's
    energy sum(v*v) float64 [n]. coeffs [n, bh, bw] int32 whose largest
    magnitude M gives mmax = bit length of 2M - 1 (the widest MagSgn field,
    which sizes the segments); heights/widths [n] int32; tab: ht_tables().
    Raises if a segment overflows its capacity."""
    n, bh, bw = coeffs.shape
    dev = coeffs.device
    _check(coeffs, "coeffs", torch.int32, 3, dev)
    _check(heights, "heights", torch.int32, 1, dev)
    _check(widths, "widths", torch.int32, 1, dev)
    _check(tab, "tab", torch.int32, 1, dev)
    if heights.shape != (n,) or widths.shape != (n,) or tab.shape != (TABLE_SIZE,):
        raise ValueError("heights/widths must be [n], tab [TABLE_SIZE]")
    if bw > 1024:
        raise ValueError("codeblocks wider than 1024")
    cap, aux = segment_capacity(bh, bw, mmax)
    if dev.type == "cpu":
        out = ht_cleanup_enc_plain(coeffs, heights, widths, cap)
        return (*out, block_energy_plain(coeffs, heights, widths)) if want_energy else out
    if dev.type != "cuda":
        raise ValueError(f"ht_cleanup_enc: unsupported device {dev}")
    buf = torch.empty((n, cap), dtype=torch.uint8, device=dev)  # the kernel writes every byte
    scratch = torch.empty((n, aux), dtype=torch.uint8, device=dev)
    lengths = torch.empty(n, dtype=torch.int32, device=dev)
    energy = torch.empty(n, dtype=torch.float64, device=dev) if want_energy else None
    kernels.KERNELS["ht_cleanup_enc"].call(
        coeffs.data_ptr(), heights.data_ptr(), widths.data_ptr(), tab.data_ptr(),
        buf.data_ptr(), scratch.data_ptr(), lengths.data_ptr(),
        energy.data_ptr() if want_energy else None, n, bh, bw, cap, aux, ENC_WARPS, None,
        kernels.stream_ptr(dev))
    if n and int(lengths.min()) < 0:
        raise RuntimeError("ht_cleanup_enc: codeblock segment buffer overflow")
    out = (buf, lengths.to(torch.int64))
    return (*out, energy) if want_energy else out


def block_energy_plain(coeffs: torch.Tensor, heights: torch.Tensor,
                       widths: torch.Tensor) -> torch.Tensor:
    """Plain form of K-e's energy: float64 [n], each codeblock's row sums of
    v*v inside its heights x widths and then the sum of its rows, both
    running sums (torch.cumsum, sequential on the CPU) as the reference's
    HT coder adds them; the zeros outside a codeblock add nothing."""
    n, bh, bw = coeffs.shape
    ys = torch.arange(bh, device=coeffs.device)[None, :, None]
    xs = torch.arange(bw, device=coeffs.device)[None, None, :]
    inside = (ys < heights[:, None, None]) & (xs < widths[:, None, None])
    v = torch.where(inside, coeffs.to(torch.float64), 0.0)
    return torch.cumsum(torch.cumsum(v * v, dim=2)[:, :, -1], dim=1)[:, -1]


def ht_cleanup_enc_plain(coeffs, heights, widths, cap: int):
    """Plain form of K-e: ht.encode_cleanup block by block."""
    n = coeffs.shape[0]
    c = coeffs.numpy()
    buf = np.zeros((n, cap), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int64)
    for i, (h, w) in enumerate(zip(heights.tolist(), widths.tolist())):
        blk = c[i, :max(h, 0), :max(w, 0)]
        if blk.size == 0 or not blk.any():
            continue
        seg = ht.encode_cleanup(blk, h, w)
        if len(seg) > cap:
            raise RuntimeError("ht_cleanup_enc: codeblock segment buffer overflow")
        buf[i, :len(seg)] = np.frombuffer(seg, dtype=np.uint8)
        lengths[i] = len(seg)
    return torch.from_numpy(buf), torch.from_numpy(lengths)


# ==================================================== K-f: cleanup decode
DEC_WARPS = 12  # warps a CUDA block of K-f (csrc/ht_dec.cu WARPS)
DEC_GROUPS = 2  # codeblocks a warp of K-f (csrc/ht_dec.cu GROUPS: 16 lanes each)


def dec_occupancy(bw: int) -> tuple[int, int]:
    """_occupancy of a K-f launch (DEC_WARPS warps a block, DEC_GROUPS
    codeblocks a warp)."""
    return _occupancy("ht_dec.cu", "ht_dec_occupancy", bw)


def ht_cleanup_dec(data: torch.Tensor, lengths: torch.Tensor, heights: torch.Tensor,
                   widths: torch.Tensor, tab: torch.Tensor, bh: int,
                   bw: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode cleanup segments: (out [n, bh, bw] int32, stopped [n] bool).
    data [n, L] uint8, lengths/heights/widths [n] int32, tab: ht_tables().
    out is t1/ht.py decode_cleanup's, wrapped to int32, zero outside each
    codeblock's heights x widths; stopped marks the codeblocks whose decode
    stopped early on a corrupt segment (the kernel also flags, and leaves
    zero, a codeblock taller or wider than bh x bw, which the plain version
    refuses)."""
    n, L = data.shape
    dev = data.device
    _check(data, "data", torch.uint8, 2, dev)
    for t, name in ((lengths, "lengths"), (heights, "heights"), (widths, "widths")):
        _check(t, name, torch.int32, 1, dev)
        if t.shape != (n,):
            raise ValueError(f"{name} must be [n]")
    _check(tab, "tab", torch.int32, 1, dev)
    if tab.shape != (TABLE_SIZE,) or bw > 1024:
        raise ValueError("tab must be [TABLE_SIZE], codeblocks at most 1024 wide")
    if dev.type == "cpu":
        return ht_cleanup_dec_plain(data, lengths, heights, widths, bh, bw)
    if dev.type != "cuda":
        raise ValueError(f"ht_cleanup_dec: unsupported device {dev}")
    out = torch.empty((n, bh, bw), dtype=torch.int32, device=dev)  # the kernel writes every sample
    stopped = torch.empty(n, dtype=torch.uint8, device=dev)
    kernels.KERNELS["ht_cleanup_dec"].call(
        data.data_ptr(), lengths.data_ptr(), heights.data_ptr(), widths.data_ptr(),
        tab.data_ptr(), out.data_ptr(), stopped.data_ptr(), n, L, bh, bw,
        kernels.stream_ptr(dev))
    return out, stopped.bool()


def ht_cleanup_dec_plain(data, lengths, heights, widths, bh: int, bw: int):
    """Plain form of K-f: ht.decode_cleanup block by block."""
    n = data.shape[0]
    d = data.numpy()
    out = np.zeros((n, bh, bw), dtype=np.int64)
    stopped = np.zeros(n, dtype=bool)
    for i, (ln, h, w) in enumerate(zip(lengths.tolist(), heights.tolist(), widths.tolist())):
        if h > 0 and w > 0 and 2 <= ln <= d.shape[1]:
            out[i, :h, :w], whole = ht.decode_cleanup(d[i, :ln].tobytes(), h, w)
            stopped[i] = not whole
    return torch.from_numpy(out.astype(np.int32)), torch.from_numpy(stopped)


# ==================================================== public entry points
def _int32(t, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(t, device=dev).to(torch.int32).contiguous()


def largest_magnitude(coeffs: torch.Tensor) -> int:
    """The largest |v| of an int32 tensor (0 when empty): one min/max pass
    and one synchronisation, no |v| tensor."""
    if not coeffs.numel():
        return 0
    lo, hi = torch.stack(torch.aminmax(coeffs)).tolist()
    return max(-lo, hi)


def encode_cblks(coeffs: torch.Tensor, heights, widths,
                 clock: StageClock | None = None, want_dist: bool = True) -> T1EncodeResult:
    """HT cleanup-only encode of a codeblock batch on the device holding
    ``coeffs`` (counterpart of ht_jax.encode_cblks): every non-empty
    codeblock codes one pass, numbps = npasses = (length > 0) and
    pass_rates = lengths. With ``want_dist`` pass_dist [N, 1] is each
    codeblock's energy, what PCRD reads as the distortion its one pass
    removes; without it pass_dist is None."""
    clock = clock or StageClock(coeffs.device, None)
    dev = coeffs.device
    coeffs = coeffs.to(torch.int32).contiguous()
    mx = largest_magnitude(coeffs)
    mmax = max((2 * mx - 1).bit_length(), 1)
    out = ht_cleanup_enc(coeffs, _int32(heights, dev), _int32(widths, dev),
                         ht_tables(dev), mmax, want_energy=want_dist)
    clock.mark("t1_ht_enc")
    buf, lengths = out[:2]
    numbps = (lengths > 0).to(torch.int64)
    return T1EncodeResult(data=buf, lengths=lengths, numbps=numbps, npasses=numbps.clone(),
                          pass_rates=lengths[:, None].clone(),
                          pass_dist=out[2][:, None] if want_dist else None)


def decode_cleanup_batch(data: torch.Tensor, lengths, heights, widths, bh: int, bw: int,
                         clock: StageClock | None = None) -> torch.Tensor:
    """Decode a batch of HT cleanup segments on the device holding ``data``
    (counterpart of ht_jax_dec.decode_cleanup_batch): [n, bh, bw] int32
    coefficients equal to grok_tpu's default decoder's (native/ht_coder.cpp
    ht_decode_cblks_c), corrupt segments included."""
    clock = clock or StageClock(data.device, None)
    dev = data.device
    out, _ = ht_cleanup_dec(data.contiguous(), _int32(lengths, dev), _int32(heights, dev),
                            _int32(widths, dev), ht_tables(dev), bh, bw)
    clock.mark("t1_ht_dec")
    return out
