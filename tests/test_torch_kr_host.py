"""K-r's and K-s's device code (csrc/mct_custom.cu, ``mct_fwd`` and
``mct_inv``) and the C entry's parameters (``make_args``) compiled for the
host and held to their plain versions on the CPU, on the float32 bits.

The kernels' source up to their launch is built by g++ against the shim of
tests/cuda_host_shim.py and run as the C entry launches them: every block
of the grid in turn, a std::thread a CUDA thread (the blocks that copy the
per-component parameters to shared memory wait at a barrier), K-r
instantiated for N up to 8. The outputs are
written into planes with a border of sentinels that must stay as they
were; every load is checked against the launch's buffers, and a 16-byte
load or store for its alignment. The cases: N = 1, 3, 4, 6, 17 and 127 on
planes of a size off a multiple of 4, all planes at 16-byte boundaries,
all one sample past them (the 16-byte path with quads shifted), and planes
at different alignments (sample by sample); K-s with NaN and infinities
through its finish; and the parameters' size at the largest N. What this
cannot show: timing, and anything nvcc compiles differently from g++; the
`cuda` tests of tests/test_torch_cuda.py hold the card."""

import ctypes
import functools
import re

import numpy as np
import pytest
import torch

from cuda_host_shim import SHIM_GLOBALS, build
from grok_tpu_torch import kernels
from grok_tpu_torch.ops import transform as tr

HARNESS = r"""
#include "shim.h"
#define __grid_constant__
dim3_ gridDim;
inline float __int_as_float(int32_t x) { float f; memcpy(&f, &x, 4); return f; }
// a 16-byte access on the card faults unless its address is a multiple of 16
inline void aligned16(const void* p) {
    if ((uintptr_t)p & 15) { fprintf(stderr, "misaligned 16-byte access: %p\n", p); abort(); }
}
inline uint4 __ldg(const uint4* p) { aligned16(p); chk(p, 16); return *p; }
inline void __stwb(uint4* p, uint4 v) { aligned16(p); *p = v; }
#include "kernel.inc"
""" + SHIM_GLOBALS + r"""
extern "C" int host_args_size() { return (int)sizeof(MctArgs); }
// one launch; returns 16 * vec + shift, or -1 for arguments make_args refuses
extern "C" int host_run(int fwd, const int64_t* ptrs, const float* m, const void* p0,
                        const void* p1, const void* p2, long long n, int N,
                        const int64_t* ranges, int nr) {
    MctArgs a;
    const void* per[3] = {p0, p1, p2};
    if (make_args(a, ptrs, m, per, fwd ? 1 : 3, n, N)) return -1;
    g_ranges.clear();
    for (int i = 0; i < nr; ++i)
        g_ranges.push_back(Range{(const char*)ranges[2 * i], (const char*)ranges[2 * i + 1]});
    blockDim = {THREADS, 1, 1};
    gridDim = {fwd ? grid_for((n + a.shift + 3) / 4) : grid_for(n), 1, 1};
    for (unsigned b = 0; b < gridDim.x; ++b) {
        Barrier blk;
        blk.n = THREADS;
        g_block = &blk;
        std::vector<std::thread> th;
        for (unsigned t = 0; t < THREADS; ++t)
            th.emplace_back([&, t] {
                blockIdx = {b, 0, 0};
                threadIdx = {t, 0, 0};
                if (!fwd) { mct_inv(a); return; }
                switch (N) {
                    case 1: mct_fwd<1>(a); break;
                    case 2: mct_fwd<2>(a); break;
                    case 3: mct_fwd<3>(a); break;
                    case 4: mct_fwd<4>(a); break;
                    case 5: mct_fwd<5>(a); break;
                    case 6: mct_fwd<6>(a); break;
                    case 7: mct_fwd<7>(a); break;
                    case 8: mct_fwd<8>(a); break;
                    default: mct_fwd<0>(a);
                }
            });
        for (auto& x : th) x.join();
    }
    return 16 * a.vec + a.shift;
}
"""
SHAPE = (7, 9)  # 63 samples: a partial quad at the end
SENTINEL = 0x5A5A5A5A


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("kr_host"), (kernels.CSRC / "mct_custom.cu").read_text(),
                "static int launch(", HARNESS, "kr")
    lib.host_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    return lib


def test_parameters_fit_a_launch(host_lib):
    """MctArgs holds the largest N's addresses and constants by value, within
    the 4 KB a launch's parameters may take; its N limit is the wrapper's."""
    src = (kernels.CSRC / "mct_custom.cu").read_text()
    define = {m[0]: int(m[1]) for m in re.findall(r"#define (\w+) (\d+)", src)}
    assert define["MAX_COMPS"] == tr.MCT_MAX_COMPS == 127
    size = host_lib.host_args_size()
    assert 28 * 127 <= size <= 4096


def _placed(t, shift):
    """A copy of t, with a sentinel border of 8 samples on each side, whose
    address is ``shift`` samples past 16-byte alignment; returns (the view,
    the whole buffer)."""
    buf = torch.full((t.numel() + 24,), SENTINEL, dtype=torch.int32).view(t.dtype)
    k = (8 + shift - (buf.data_ptr() >> 2)) & 3
    out = buf[8 + k:8 + k + t.numel()].view(t.shape)
    out.copy_(t)
    return out, buf


def _matrix(n):
    rng = np.random.default_rng(n + 7)
    return (np.eye(n) + rng.uniform(-0.4, 0.4, (n, n))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fwd_case(n):
    """The inputs, DC shifts and the plain version's outputs of K-r at N."""
    rng = np.random.default_rng(n)
    planes = [torch.from_numpy(rng.integers(0, 1 << 12, SHAPE).astype(np.int32))
              for _ in range(n)]
    dcs = [int(v) for v in rng.integers(0, 1 << 11, n)]
    return planes, dcs, tr.dc_mct_fwd_plain(planes, dcs, _matrix(n))


def _run(lib, fwd, ins, outs, m, per):
    ptrs = np.array([p.data_ptr() for p in ins] + [o.data_ptr() for o in outs], dtype=np.int64)
    ranges = np.array([(p.data_ptr(), p.data_ptr() + 4 * p.numel()) for p in ins]
                      + [(m.ctypes.data, m.ctypes.data + m.nbytes)], dtype=np.int64)
    per = list(per) + [None] * (3 - len(per))
    return lib.host_run(fwd, ptrs.ctypes.data, m.ctypes.data,
                        *(None if a is None else a.ctypes.data for a in per),
                        ins[0].numel(), len(ins), ranges.ctypes.data, len(ranges))


_LAYOUTS = {"aligned": lambda k: 0, "one sample past": lambda k: 1, "mixed": lambda k: k % 4 + 1}


@pytest.mark.parametrize("layout", list(_LAYOUTS))
@pytest.mark.parametrize("n", [1, 3, 4, 6, 17, 127])
def test_forward_equals_plain(host_lib, n, layout):
    planes, dcs, want = _fwd_case(n)
    at = _LAYOUTS[layout]
    ins = [_placed(p, at(k))[0] for k, p in enumerate(planes)]
    placed = [_placed(torch.zeros(SHAPE, dtype=torch.float32), at(n + k)) for k in range(n)]
    m = _matrix(n)
    got = _run(host_lib, 1, ins, [o for o, _ in placed], m, [np.array(dcs, dtype=np.int32)])
    # every plane at one alignment moves in 16-byte quads, planes at mixed
    # ones sample by sample; quads start where the first output's do
    assert got == (16 if layout != "mixed" else 0) + at(n) % 4
    for (o, buf), w in zip(placed, want):
        assert torch.equal(o.view(torch.int32), w.view(torch.int32))
        border = torch.ones(buf.numel(), dtype=torch.bool)
        start = (o.data_ptr() - buf.data_ptr()) // 4
        border[start:start + o.numel()] = False
        assert bool((buf.view(torch.int32)[border] == SENTINEL).all())


@pytest.mark.parametrize("n", [1, 3, 17, 127])
def test_inverse_equals_plain(host_lib, n):
    """K-s through the same parameters: its finish (floor, clip, NaN to the
    low end) on the plain version's output of K-r, three samples made NaN,
    +inf and -1e30."""
    planes, dcs, fwd = _fwd_case(n)
    fwd = [f.clone() for f in fwd]
    fwd[0].view(-1)[:3] = torch.tensor([float("nan"), float("inf"), -1e30])
    inv = np.linalg.inv(_matrix(n).astype(np.float64)).astype(np.float32)
    offs, ranges = [float(d) for d in dcs], [(0, 4095)] * n
    want = tr.mct_inv_round_clip_plain(fwd, inv, offs, ranges)
    ins = [_placed(f, k % 4)[0] for k, f in enumerate(fwd)]
    outs = [_placed(torch.zeros(SHAPE, dtype=torch.int32), 0) for _ in range(n)]
    add = np.array([0.5 + o for o in offs], dtype=np.float32)
    lo, hi = (np.array(v, dtype=np.int32) for v in zip(*ranges))
    assert _run(host_lib, 0, ins, [o for o, _ in outs], inv, [add, lo, hi]) >= 0
    for (o, _), w in zip(outs, want):
        assert torch.equal(o, w)


def test_make_args_refuses_n_out_of_range(host_lib):
    p = torch.zeros(4, dtype=torch.int32)
    m = np.ones((1, 1), dtype=np.float32)
    dc = np.zeros(128, dtype=np.int32)
    ptrs = np.array([p.data_ptr()] * 256, dtype=np.int64)
    for n in (0, 128):
        assert host_lib.host_run(1, ptrs.ctypes.data, m.ctypes.data, dc.ctypes.data, None, None,
                                 4, n, None, 0) == -1
