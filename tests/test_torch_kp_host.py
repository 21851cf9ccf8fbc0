"""K-p's device code (csrc/ebcot_dist.cu) compiled for the host and held to
its plain version on the CPU: every pass's float64 distortion, exactly.

The kernel's source up to its host entry point is built by g++ against the
shim of tests/cuda_host_shim.py (a std::thread a CUDA thread, one block
after another), launched as the C entry launches it (one block a codeblock,
``dist_threads`` threads, ``dist_smem`` bytes of shared memory), into a
``dist`` filled with NaN (the kernel writes every entry). The records come
from K-c's plain scan. The cases put planes on both sides of the bound
below which a pass's sum is an exact int64 reduction
(``npos * 4^(p+2) <= 2^53``); above it the kernel keeps the ordered chain.
What this cannot show: timing, occupancy, and anything nvcc compiles
differently from g++; the `cuda` tests of tests/test_torch_cuda.py hold the
card."""

import ctypes

import numpy as np
import pytest
import torch

from cuda_host_shim import SHIM_GLOBALS, build
from grok_tpu_torch import kernels
from grok_tpu_torch.t1 import ebcot_cuda as ec
from grok_tpu_torch.t1.ebcot import lane_numbps

HARNESS = r"""
#include "shim.h"
#include "kernel.inc"
""" + SHIM_GLOBALS + r"""alignas(16) uint32_t smem[1 << 16];
extern "C" int host_dist(const void* sym, long long sym_bytes, const void* coeffs,
                         const void* numbps, void* dist, int n, int pmaxc, int s_pad, int h,
                         int w, int max_passes) {
    auto R = [](const void* p, size_t b) { return Range{(const char*)p, (const char*)p + b}; };
    g_ranges = {R(sym, sym_bytes), R(coeffs, 4LL * n * h * w), R(numbps, 4 * n)};
    const int threads = dist_threads(h, w);
    if (dist_smem(h, w, max_passes, threads) > sizeof(smem)) return 1;
    blockDim = {(unsigned)threads, 1, 1};
    for (int b = 0; b < n; ++b) {
        Barrier blk;
        blk.n = threads;
        g_block = &blk;
        std::vector<Barrier> wb(threads / 32);
        std::vector<Exch> ex(threads / 32);
        for (auto& x : wb) x.n = 32;
        std::vector<std::thread> th;
        for (int t = 0; t < threads; ++t)
            th.emplace_back([&, t] {
                threadIdx = {(unsigned)t, 0, 0};
                blockIdx = {(unsigned)b, 0, 0};
                t_warp = &wb[t / 32];
                t_exch = &ex[t / 32];
                ebcot_dist_kernel((const uint8_t*)sym, (const int32_t*)coeffs,
                                  (const int32_t*)numbps, (double*)dist, pmaxc, s_pad, h, w,
                                  max_passes);
            });
        for (auto& x : th) x.join();
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("kp_host"), (kernels.CSRC / "ebcot_dist.cu").read_text(),
                "extern \"C\" int ebcot_dist_occupancy", HARNESS, "kp")
    lib.host_dist.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 6
    lib.ebcot_dist_exact.argtypes = [ctypes.c_int] * 2
    return lib


def _batch(seed, n, h, w, bits, styles, ragged=False):
    """n codeblocks of h x w with magnitudes below 2^bits (codeblock 0
    empty, codeblock 1 at 2^bits - 1 somewhere), their lanes and pmax."""
    rng = np.random.default_rng(seed)
    mags = rng.integers(1, 1 << bits, size=n)
    c = (rng.standard_normal((n, h, w)) * mags[:, None, None] / 3).astype(np.int64)
    c = np.clip(c, -(1 << bits) + 1, (1 << bits) - 1).astype(np.int32)
    c[0] = 0  # no passes
    if n > 1:
        c[1, 0, 0] = -((1 << bits) - 1)
    hh = rng.integers(1, h + 1, size=n) if ragged else np.full(n, h)
    ww = rng.integers(1, w + 1, size=n) if ragged else np.full(n, w)
    hh[:2], ww[:2] = h, w
    for i in range(n):
        c[i, hh[i]:] = 0
        c[i, :, ww[i]:] = 0
    ct, ht, wt = (torch.from_numpy(a) for a in (c, hh, ww))
    nb = lane_numbps(ct.abs(), ht, wt)
    st = torch.from_numpy(np.asarray(styles)[np.arange(n) % len(styles)])
    lanes = torch.stack([nb, ht, wt, torch.from_numpy(rng.integers(0, 4, size=n)), st])
    return ct, lanes.to(torch.int32).contiguous(), int(nb.max())


# (n, h, w, bits, styles, ragged); the chain runs where a plane is above the
# bound: 16x16 (256 positions) above plane 20, 13x16 (256) too. SPP and CUP
# decreases are multiples of 2^p and their sums stay exact far longer; the
# refinements' integer sums round once past 2^53: the 2^30 case holds
# passes where an int64 sum differs from the ordered one
_CASES = {
    "64x64 exact, styles 0x00 0x01 0x08 0x3F": (5, 64, 64, 12, [0x00, 0x01, 0x08, 0x3F], False),
    "16x16 exact and chain, 2^30": (4, 16, 16, 30, [0x00, 0x3F], False),
    "13x16 ragged, exact and chain, 2^28": (5, 13, 16, 28, [0x01, 0x08], True),
    "7x5 ragged exact, style 0x3F": (6, 7, 5, 10, [0x3F], True),
    "32x4 exact, style 0x08": (3, 32, 4, 9, [0x08], False),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_device_code_equals_plain(host_lib, case):
    n, h, w, bits, styles, ragged = _CASES[case]
    c, lanes, pmax = _batch(len(case) + bits, n, h, w, bits, styles, ragged)
    pmaxc = -(-pmax // 4) * 4
    tab = ec.device_tables(torch.device("cpu"))
    sym = ec.ebcot_symbols_plain(c, lanes, tab["ctx"], pmaxc)
    nb = lanes[0].contiguous()
    max_passes = max(3 * pmax - 2, 1)
    dist = torch.full((n, max_passes), float("nan"), dtype=torch.float64)
    rc = host_lib.host_dist(sym.data_ptr(), sym.numel(), c.data_ptr(), nb.data_ptr(),
                            dist.data_ptr(), n, pmaxc, sym.shape[3], h, w, max_passes)
    assert rc == 0
    ref = ec.pass_dist_from_records(sym, c, nb, pmax)
    assert torch.equal(dist, ref)
    assert not dist[0].any(), "a codeblock with no passes has zero distortions"
    npos = -(-h // 4) * 4 * w
    regimes = {host_lib.ebcot_dist_exact(p, npos) for p in range(pmax)}
    assert regimes == ({1, 0} if "chain" in case else {1})
    if "chain" in case:  # codeblock 1's cleanup pass sits above the bound
        assert host_lib.ebcot_dist_exact(int(nb[1]) - 1, npos) == 0 and float(dist[1, 0]) > 0


@pytest.mark.parametrize("npos", [16, 256, 4096])
def test_exact_bound(host_lib, npos):
    """The C entry's bound: npos * 4^(p+2) <= 2^53, for 64x64 up to plane
    18, for 16x16 up to 20."""
    want = [npos * 4 ** (p + 2) <= 2 ** 53 for p in range(32)]
    assert [bool(host_lib.ebcot_dist_exact(p, npos)) for p in range(32)] == want
    assert want.index(False) - 1 == {16: 22, 256: 20, 4096: 18}[npos]
