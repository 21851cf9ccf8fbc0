"""K-e's device code (csrc/ht_enc.cu) compiled for the host and held to its
plain version on the CPU: segments, lengths and energies, exactly.

The kernel's source up to its host entry points is built by g++ against
the shim of tests/cuda_host_shim.py (a std::thread a CUDA thread, one
block after another). The launch is the wrapper's (ht_cuda.segment_capacity,
ht_cuda.ENC_WARPS a block where a case sets no fewer), into segment rows
filled with 0xCC (the kernel writes the zeros past each segment), with a
guard row after the segments and the scratch rows that must stay untouched. What this cannot show: timing,
occupancy, and anything nvcc compiles differently from g++; the `cuda`
tests of tests/test_torch_cuda.py hold the card."""

import ctypes

import numpy as np
import pytest
import torch

from cuda_host_shim import SHIM_GLOBALS, build
from grok_tpu_torch import kernels
from grok_tpu_torch.t1 import ht_cuda as hc

HARNESS = r"""
#include "shim.h"
#include "kernel.inc"
""" + SHIM_GLOBALS + r"""alignas(16) uint8_t s_dyn[1 << 16];
extern "C" int host_encode(const void* coeffs, const void* heights, const void* widths,
                           const void* tab, void* out, void* scratch, void* lengths,
                           void* energy, void* stats, int n, int bh, int bw, int cap,
                           int aux_cap, int warps) {
    auto R = [](const void* p, size_t b) { return Range{(const char*)p, (const char*)p + b}; };
    g_ranges = {R(coeffs, 4LL * n * bh * bw), R(heights, 4 * n), R(widths, 4 * n),
                R(tab, 4 * (T_U_SUF_LEN + 33))};
    if (block_bytes(bw, warps) > (int)sizeof(s_dyn)) return 1;
    blockDim = {(unsigned)(warps * 32), 1, 1};
    for (int b = 0; b < (n + warps - 1) / warps; ++b) {
        Barrier blk;
        blk.n = warps * 32;
        g_block = &blk;
        std::vector<Barrier> wb(warps);
        std::vector<Exch> ex(warps);
        for (auto& w : wb) w.n = 32;
        std::vector<std::thread> th;
        for (int t = 0; t < warps * 32; ++t)
            th.emplace_back([&, t] {
                threadIdx = {(unsigned)t, 0, 0};
                blockIdx = {(unsigned)b, 0, 0};
                t_warp = &wb[t / 32];
                t_exch = &ex[t / 32];
                ht_enc_kernel((const int32_t*)coeffs, (const int32_t*)heights,
                              (const int32_t*)widths, (const int32_t*)tab, (uint8_t*)out,
                              (uint8_t*)scratch, (int32_t*)lengths, (double*)energy,
                              (int32_t*)stats, n, bh, bw, cap, aux_cap);
            });
        for (auto& x : th) x.join();
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("ke_host"), (kernels.CSRC / "ht_enc.cu").read_text(),
                "extern \"C\" int ht_enc_occupancy", HARNESS, "ke")
    lib.host_encode.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    return lib


def _host_encode(lib, c, h, w, warps=None):
    """(segments [n, cap], lengths [n] int64, energies [n], stats [n, 3])
    of a launch laid out as the wrapper lays it out."""
    n, bh, bw = c.shape
    mmax = max((2 * hc.largest_magnitude(c) - 1).bit_length(), 1)
    cap, aux = hc.segment_capacity(bh, bw, mmax)
    out = torch.full((n + 1, cap), 0xCC, dtype=torch.uint8)
    out[n] = 0
    scratch = torch.full((n + 1, aux), 0xA5, dtype=torch.uint8)
    lengths = torch.empty(n, dtype=torch.int32)
    energy = torch.empty(n, dtype=torch.float64)
    stats = torch.empty((n, 3), dtype=torch.int32)
    tab = hc.ht_tables(torch.device("cpu"))
    rc = lib.host_encode(c.data_ptr(), h.data_ptr(), w.data_ptr(), tab.data_ptr(),
                         out.data_ptr(), scratch.data_ptr(), lengths.data_ptr(),
                         energy.data_ptr(), stats.data_ptr(), n, bh, bw, cap, aux,
                         warps or hc.ENC_WARPS)
    assert rc == 0
    assert not out[n].any() and bool((scratch[n] == 0xA5).all()), "a write past the rows"
    return out[:n], lengths.to(torch.int64), energy, stats


def _batch(seed, n, bh, bw, mag, density=0.5, ragged=False, zero=()):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, mag + 1, size=(n, bh, bw)) * (rng.random((n, bh, bw)) < density)
    c = np.where(rng.random((n, bh, bw)) < 0.5, -c, c)
    h = rng.integers(1, bh + 1, size=n) if ragged else np.full(n, bh)
    w = rng.integers(1, bw + 1, size=n) if ragged else np.full(n, bw)
    for i in range(n):
        c[i, h[i]:] = 0
        c[i, :, w[i]:] = 0
    for i in zero:
        c[i] = 0
    return [torch.from_numpy(a.astype(np.int32)) for a in (c, h, w)]


def vlc_stress(n, bh, bw, seed=132):
    """Samples from a few small values (seed 132's draw): VLC bytes above
    0x8F followed by seven ones, stuffed, several times in an 8x64 block."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 4, size=6)
    c = rng.choice(vals, size=(n, bh, bw)) * rng.choice([-1, 1], size=(n, bh, bw))
    return torch.from_numpy(c.astype(np.int32))


def wide_batch(seed, n=4, bh=16, bw=64):
    """Magnitudes from 2^24 to 2^31 - 1 (log-uniform), the named ones 2^24,
    2^30 - 1, 2^30, 2^31 - 1 and INT32_MIN, and small values beside wide
    ones: exponents up to 32, MagSgn fields of up to 32 bits."""
    rng = np.random.default_rng(seed)
    mag = np.minimum(np.exp2(rng.uniform(24, 31, size=(n, bh, bw))), (1 << 31) - 1)
    c = np.where(rng.random((n, bh, bw)) < 0.5, -1, 1) * mag.astype(np.int64)
    c *= rng.random((n, bh, bw)) < 0.8
    named = [1 << 24, (1 << 30) - 1, 1 << 30, (1 << 31) - 1]
    c[1] = rng.choice(named + [-v for v in named] + [-(1 << 31)], size=(bh, bw))
    c[2, :, ::2] = rng.integers(-3, 4, size=(bh, (bw + 1) // 2))
    c[3, 0, 0] = -(1 << 31)
    return [torch.from_numpy(a.astype(np.int32)) for a in (c, np.full(n, bh), np.full(n, bw))]


def _cases():
    top = (1 << 24) - 1
    big = _batch(21, 3, 4, 64, top, 1.0)
    big[0][0] = torch.from_numpy(np.random.default_rng(22).choice(
        [top, -top, top - 1, -(top - 2)], size=(4, 64)).astype(np.int32))
    ff = np.zeros((4, 6, 8), dtype=np.int32)
    for i, k in enumerate((3, 7, 8, 15)):  # every sample -2^k: runs of ones in MagSgn
        ff[i] = -(1 << k)
    ff[3, ::2, ::3] = -(1 << 16)
    sparse = np.zeros((2, 64, 64), dtype=np.int32)
    sparse[0, 5, 7], sparse[0, 40, 3], sparse[0, 63, 63] = 3, -200, 1
    sparse[1, ::9, ::11] = 5
    full = lambda n, v: torch.full((n,), v, dtype=torch.int32)  # noqa: E731
    edge = _batch(18, 6, 5, 9, 500, 1.0)
    edge[1] = torch.tensor([1, 1, 5, 2, 5, 3], dtype=torch.int32)
    edge[2] = torch.tensor([1, 9, 1, 1, 7, 2], dtype=torch.int32)
    for i, (eh, ew) in enumerate(zip(edge[1].tolist(), edge[2].tolist())):
        edge[0][i, eh:] = 0
        edge[0][i, :, ew:] = 0
    return {
        "ragged 16x16, warps of 4": (*_batch(11, 6, 16, 16, 300, 0.7, ragged=True), 4),
        "wide 4x130: chunked rows, an odd count of quads": (*_batch(12, 2, 4, 130, 90, 0.8), 1),
        "wide 2x96, ragged": (*_batch(15, 3, 2, 96, 20, 0.9, ragged=True), 3),
        "odd 5x67, zero blocks among full": (*_batch(13, 5, 5, 67, 40, 0.6, zero=(1, 3)), 2),
        "tall 70x4": (*_batch(14, 2, 70, 4, 1000, 0.9), 1),
        "25-bit MagSgn fields": (*big, 1),
        "32-bit MagSgn fields: 2^24 to 2^31 - 1 and INT32_MIN": (*wide_batch(23), 2),
        "MagSgn 0xFF": (torch.from_numpy(ff), full(4, 6), full(4, 8), 2),
        "MEL runs": (torch.from_numpy(sparse), full(2, 64), full(2, 64), 1),
        "VLC 0x8F/0x7F": (vlc_stress(1, 8, 64), full(1, 8), full(1, 64), 1),
        "the wrapper's blocks: 20 ragged 8x8, the second block part-filled":
            (*_batch(17, 20, 8, 8, 60, 0.7, ragged=True), None),
        "the wrapper's blocks: 1x1, 1-high and 1-wide codeblocks":
            (*edge, None),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_device_code_equals_plain(host_lib, case):
    c, h, w, warps = _cases()[case]
    buf, lengths, energy, stats = _host_encode(host_lib, c, h, w, warps)
    mmax = max((2 * hc.largest_magnitude(c) - 1).bit_length(), 1)
    rbuf, rlen = hc.ht_cleanup_enc_plain(c, h, w, hc.segment_capacity(*c.shape[1:], mmax)[0])
    assert torch.equal(lengths, rlen)
    assert torch.equal(buf, rbuf)
    assert torch.equal(energy, hc.block_energy_plain(c, h, w))
    if case.endswith("MagSgn fields"):  # sums past 2^53: only the reference's order agrees
        assert float(energy[0]) != float(int((c[0].to(torch.int64) ** 2).sum()))
    if case == "MagSgn 0xFF":
        assert int(stats[:, 1].sum()) > 0
    if case == "MEL runs":
        assert int(stats[:, 0].sum()) > 1000
    if case == "VLC 0x8F/0x7F":
        assert int(stats[:, 2].sum()) >= 5


# ----------------------------------------------- the wrapper's host logic
def test_constants_match_the_source():
    """The wrapper's limits and table layout are the kernel's."""
    import re

    src = (kernels.CSRC / "ht_enc.cu").read_text()
    define = {m[0]: int(m[1]) for m in re.findall(r"#define (\w+) (\d+)", src)}
    assert define["MAX_WARPS"] >= hc.ENC_WARPS
    assert define["T_MEL_EXP"] == 6144 and define["T_U_PRE"] == 6157
    assert define["T_U_SUF_LEN"] + 33 == hc.TABLE_SIZE
    assert 2 * define["NQW_MAX"] == 1024


def test_largest_magnitude():
    """One min/max pass: the largest |v|, 2^31 for INT32_MIN, 0 when empty."""
    f = hc.largest_magnitude
    assert f(torch.tensor([[-5, 3], [2, 1]], dtype=torch.int32)) == 5
    assert f(torch.tensor([7, -1], dtype=torch.int32)) == 7
    assert f(torch.tensor([-(1 << 31)], dtype=torch.int32)) == 1 << 31
    assert f(torch.zeros((0, 4, 4), dtype=torch.int32)) == 0

