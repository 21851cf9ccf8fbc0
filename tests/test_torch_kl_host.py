"""K-l and K-m's device code (csrc/quant97.cu, ``band_kernel``) and the C
entry's parameters (``make_args``) compiled for the host and held to their
plain versions on the CPU, bit for bit.

The kernel's source up to its launch is built by g++ against the shim of
tests/cuda_host_shim.py and run as the C entry launches it: every block of
the grid, every thread of a block in turn (the kernel has no barrier and
no warp operation). Each launch takes a group of ``transform.quant_plan``.
Outputs are written into planes with a border of sentinels that must stay
as they were, and every load is checked against the input planes (and a
16-byte load for its alignment). The
cases: odd sizes and band origins, planes whose addresses differ from their
outputs' modulo 16 (the sample-by-sample path), outputs at each of the four
alignments, and more components than one launch takes. What this cannot
show: timing, and anything nvcc compiles differently from g++; the `cuda`
tests of tests/test_torch_cuda.py hold the card."""

import ctypes
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
inline float __int2float_rn(int x) { return (float)x; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
// a 16-byte load on the card faults unless its address is a multiple of 16
inline uint4 __ldg(const uint4* p) {
    if ((uintptr_t)p & 15) { fprintf(stderr, "misaligned 16-byte load: %p\n", p); abort(); }
    chk(p, 16);
    return *p;
}
#include "kernel.inc"
""" + SHIM_GLOBALS + r"""
extern "C" long long host_run(int quant, const int64_t* comps, const int32_t* bands, int nc,
                              int nb, const int64_t* ranges, int nr) {
    QArgs a;
    const int64_t total = make_args(a, comps, bands, nc, nb);
    if (total < 0) return -1;
    g_ranges.clear();
    for (int i = 0; i < nr; ++i)
        g_ranges.push_back(Range{(const char*)ranges[2 * i], (const char*)ranges[2 * i + 1]});
    blockDim = {QX, QY, 1};
    for (int64_t b = 0; b < total; ++b)
        for (unsigned y = 0; y < QY; ++y)
            for (unsigned x = 0; x < QX; ++x) {
                blockIdx = {(unsigned)b, 0, 0};
                threadIdx = {x, y, 0};
                if (quant) band_kernel<true>(a); else band_kernel<false>(a);
            }
    return total;
}
"""
SENTINEL = 0x5A5A5A5A


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("kl_host"), (kernels.CSRC / "quant97.cu").read_text(),
                "static int launch(", HARNESS, "kl")
    lib.host_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.host_run.restype = ctypes.c_longlong
    return lib


def test_launch_limits_match_the_wrapper():
    src = (kernels.CSRC / "quant97.cu").read_text()
    define = {m[0]: int(m[1]) for m in re.findall(r"#define (\w+) (\d+)", src)}
    assert (define["MAX_COMPS"], define["MAX_BANDS"]) == (tr.QUANT_MAX_COMPS,
                                                          tr.QUANT_MAX_BANDS)


def _mallat(h, w, nl, y0, x0, seed):
    """(oy, ox, h, w, step) of each band of an h x w tile-component at
    origin (y0, x0) with nl levels in its packed plane, coarsest first."""
    rng = np.random.default_rng(seed)
    dims = [(h, w, y0, x0)]
    for _ in range(nl):
        ch, cw, cy, cx = dims[-1]
        dims.append((-(-(cy + ch) // 2) - -(-cy // 2), -(-(cx + cw) // 2) - -(-cx // 2),
                     -(-cy // 2), -(-cx // 2)))
    bands = [(0, 0, dims[-1][0], dims[-1][1])]
    for lv in range(nl, 0, -1):
        fh, fw, fy, fx = dims[lv - 1]
        lh, lw = dims[lv][0], dims[lv][1]
        bands += [(0, lw, lh, fw - lw), (lh, 0, fh - lh, lw), (lh, lw, fh - lh, fw - lw)]
    return [(*b, float(rng.uniform(0.01, 9.0))) for b in bands]


def _planes(shapes, seed, quant):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in shapes:
        if quant:
            a = (rng.standard_normal((h, w)) * 300).astype(np.float32)
        else:
            a = rng.integers(-5000, 5000, size=(h, w)).astype(np.int32)
            a[rng.random((h, w)) < 0.2] = 0
        out.append(torch.from_numpy(a))
    return out


def _placed(t, shift):
    """A copy of t whose address is ``shift`` samples past 16-byte alignment."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    k = (shift - (buf.data_ptr() >> 2)) & 3
    out = buf[k:k + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _run(lib, quant, planes, bands, out_shift):
    """The kernel over ``planes`` as the wrapper launches it, into outputs
    at ``out_shift`` samples past 16-byte alignment with SENTINEL around
    them; returns (outputs, launches) after checking the sentinels."""
    dtype = torch.int32 if quant else torch.float32
    outs, frames = [], []
    for p in planes:
        frame = torch.full((p.numel() + 16,), SENTINEL, dtype=torch.int32)
        k = 4 + ((out_shift - (frame.data_ptr() >> 2)) & 3)
        frames.append((frame, k, p.numel()))
        outs.append(frame[k:k + p.numel()].view(dtype).view(p.shape))
    plan = tr.quant_plan([tuple(p.shape) for p in planes], bands)
    for comps, table in plan:
        ptrs = np.array([(planes[c].data_ptr(), outs[c].data_ptr(), planes[c].shape[1])
                         for c in comps], dtype=np.int64)
        ranges = np.array([(planes[c].data_ptr(), planes[c].data_ptr() + 4 * planes[c].numel())
                           for c in comps], dtype=np.int64)
        assert lib.host_run(int(quant), ptrs.ctypes.data, table.ctypes.data, len(comps),
                            len(table), ranges.ctypes.data, len(comps)) >= 0
    for frame, k, n in frames:
        assert bool((frame[:k] == SENTINEL).all() and (frame[k + n:] == SENTINEL).all())
    return outs, len(plan)


def _check(lib, shapes, bands, seed, in_shift=0, out_shift=0):
    for quant in (True, False):
        planes = [_placed(p, in_shift) for p in _planes(shapes, seed, quant)]
        plain = tr.quant_deadzone_plain if quant else tr.dequant_midbin_plain
        got, launches = _run(lib, quant, planes, bands, out_shift)
        for g, p, b in zip(got, planes, bands):
            assert torch.equal(g.view(torch.int32), plain(p, b).view(torch.int32))
    return launches


@pytest.mark.parametrize("h,w,nl,y0,x0", [(1, 1, 0, 0, 0), (1, 9, 2, 0, 1), (9, 1, 2, 1, 0),
                                          (37, 53, 3, 3, 5), (70, 131, 5, 0, 0),
                                          (64, 128, 4, 0, 0), (33, 67, 5, 1, 1)])
def test_tile_bands_equal_plain(host_lib, h, w, nl, y0, x0):
    """Three components of a tile, one launch, at the aligned addresses the
    wrapper's outputs take."""
    bands = [_mallat(h, w, nl, y0, x0, seed) for seed in range(3)]
    assert _check(host_lib, [(h, w)] * 3, bands, h * w + nl) == 1


@pytest.mark.parametrize("in_shift,out_shift", [(0, 1), (2, 2), (3, 1), (1, 3)])
def test_every_alignment_equals_plain(host_lib, in_shift, out_shift):
    """Inputs and outputs off 16-byte alignment, alike (16-byte quads
    inside a band row) and unlike (sample by sample)."""
    h, w = 45, 77
    assert _check(host_lib, [(h, w)], [_mallat(h, w, 3, 1, 2, 9)], 5, in_shift, out_shift) == 1


@pytest.mark.parametrize("nl,launches", [(1, 2), (5, 2)])
def test_components_past_one_launch(host_lib, nl, launches):
    """Ten components of subsampled sizes: at one level (4 bands each)
    eight go to the first launch (its component limit), at five levels (16
    bands each) seven (its band limit); the rest to the second."""
    shapes = [(40 + c, 47 - c) for c in range(10)]
    bands = [_mallat(h, w, nl, c & 1, c % 3, c) for c, (h, w) in enumerate(shapes)]
    plan = tr.quant_plan(shapes, bands)
    assert [len(comps) for comps, _ in plan] == ([8, 2] if nl == 1 else [7, 3])
    assert _check(host_lib, shapes, bands, 11) == launches


def test_bands_without_samples_left_out(host_lib):
    """32 levels of a 3 x 5 plane: 97 bands, most of them empty."""
    bands = [_mallat(3, 5, 32, 0, 0, c) for c in range(3)]
    assert all(len(b) == 97 for b in bands)
    plan = tr.quant_plan([(3, 5)] * 3, bands)
    assert all(t[:, 3].all() and t[:, 4].all() for _, t in plan)
    assert _check(host_lib, [(3, 5)] * 3, bands, 4) == 1


def test_out_of_range_arguments_refused(host_lib):
    table = np.zeros((1, 6), dtype=np.int32)
    table[0, 3:5] = 1
    ptrs = np.zeros((1, 3), dtype=np.int64)
    for nc, comp in ((0, 0), (tr.QUANT_MAX_COMPS + 1, 0), (1, 1), (1, -1)):
        table[0, 0] = comp
        assert host_lib.host_run(1, ptrs.ctypes.data, table.ctypes.data, nc, 1, None, 0) == -1
