"""K-n's device code (csrc/dwt97.cu, ``dwt97_inv_tile``) compiled for the
host and held to its plain version on the CPU on the float32 bits.

The kernel's source up to its host entry points is built by g++ against the
shim of tests/cuda_host_shim.py (a std::thread a CUDA thread, one block
after another) and launched as the C entry launches it: one 64-thread block
a 56 x 64 output tile. Its output goes to a buffer that overlaps neither
source, with a border of sentinels that must stay as they were. The cases:
both origin parities on each axis, lines of 1, 2 and 3 samples, sizes one
below and one above a multiple of the tile in each direction, and three
levels in the order ``inverse_transform`` calls them (``inv_ping_pong``:
each level's LL quadrant from the level before, in the other buffer). What
this cannot show: timing, occupancy, and anything nvcc compiles
differently from g++; the `cuda` tests of tests/test_torch_cuda.py hold the
card."""

import ctypes
import re

import numpy as np
import pytest
import torch

from cuda_host_shim import SHIM_GLOBALS, build
from grok_tpu_torch import kernels
from grok_tpu_torch.core.rect import Rect
from grok_tpu_torch.ops import transform as tr

HARNESS = r"""
#include "shim.h"
#include "kernel.inc"
""" + SHIM_GLOBALS + r"""alignas(16) float s_tile[TR * TP > FTR * FTP ? TR * TP : FTR * FTP];
extern "C" int host_inv(const void* ll, long long ld_ll, long long ll_n, const void* src,
                        long long ld, long long src_n, void* dst, long long ld_dst, int h,
                        int w, int py, int px) {
    auto R = [](const void* p, size_t b) { return Range{(const char*)p, (const char*)p + b}; };
    g_ranges = {R(ll, 4 * ll_n), R(src, 4 * src_n)};
    blockDim = {INV_THREADS, 1, 1};
    for (int by = 0; by < (h + TH - 1) / TH; ++by)
        for (int bx = 0; bx < (w + TW - 1) / TW; ++bx) {
            Barrier blk;
            blk.n = INV_THREADS;
            g_block = &blk;
            std::vector<Barrier> wb(INV_THREADS / 32);
            std::vector<Exch> ex(INV_THREADS / 32);
            for (auto& x : wb) x.n = 32;
            std::vector<std::thread> th;
            for (int t = 0; t < INV_THREADS; ++t)
                th.emplace_back([&, t] {
                    threadIdx = {(unsigned)t, 0, 0};
                    blockIdx = {(unsigned)bx, (unsigned)by, 0};
                    t_warp = &wb[t / 32];
                    t_exch = &ex[t / 32];
                    dwt97_inv_tile((const float*)ll, ld_ll, (const float*)src, ld, (float*)dst,
                                   ld_dst, h, w, py, px);
                });
            for (auto& x : th) x.join();
        }
    return 0;
}
"""
SENTINEL = -12345.5


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("kn_host"), (kernels.CSRC / "dwt97.cu").read_text(),
                "// ---------------------------------------------------------------- the C "
                "entries", HARNESS, "kn")
    lib.host_inv.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 4
    return lib


def _host_launch(lib):
    """A launch taking what ``tr.level_launcher``'s launch takes for K-n, on
    CPU tensors: dst must hold h x w; the sources are read whole."""
    def launch(ll, src, dst, h, w, py, px):
        assert lib.host_inv(ll.data_ptr(), ll.stride(0), ll.numel(), src.data_ptr(),
                            src.stride(0), src.numel(), dst.data_ptr(), dst.stride(0),
                            h, w, py, px) == 0
    return launch


def _plane(seed, h, w):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((h, w)) * 400).astype(np.float32))


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_tile_constants_match_the_launch():
    """The launch above and the C entry share the tile: 56 x 64 outputs,
    64 threads, a halo of 4."""
    src = (kernels.CSRC / "dwt97.cu").read_text()
    define = {m[0]: int(m[1]) for m in re.findall(r"#define (\w+) (\d+)", src)}
    assert (define["TH"], define["TW"], define["HALO"], define["INV_THREADS"]) == (56, 64, 4, 64)


# (h, w): lines of 1, 2 and 3 samples; under one tile; one below and one above
# a multiple of the tile (56 rows, 64 columns) in each direction
_SHAPES = [(1, 1), (1, 2), (2, 1), (1, 3), (3, 1), (2, 3), (3, 2), (1, 70), (70, 1), (2, 66),
           (37, 53), (55, 63), (57, 65), (111, 129), (113, 127)]


@pytest.mark.parametrize("py,px", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("h,w", _SHAPES, ids=[f"{h}x{w}" for h, w in _SHAPES])
def test_one_level_equals_plain(host_lib, h, w, py, px):
    plane = _plane(h * 1000 + w + 7 * py + 3 * px, h + 2, w + 3)  # the level is its top-left
    ref = plane.clone()
    tr.dwt97_inv_level_plain(ref, h, w, py, px)
    out = torch.full((h + 2, w + 5), SENTINEL, dtype=torch.float32)
    _host_launch(host_lib)(plane, plane, out, h, w, py, px)
    assert _same_bits(out[:h, :w], ref[:h, :w])
    assert bool((out[h:] == SENTINEL).all() and (out[:, w:] == SENTINEL).all())


@pytest.mark.parametrize("y0,x0", [(0, 0), (3, 5), (2, 7)])
def test_three_levels_in_call_order(host_lib, y0, x0):
    """inverse_transform's order: coarsest first through inv_ping_pong,
    each LL quadrant from the level before, against the plain levels in
    place."""
    rect = Rect(x0, y0, x0 + 150, y0 + 121)
    levels = [(r.height, r.width, r.y0 & 1, r.x0 & 1)
              for r in reversed(tr._levels(rect, 3))]
    plane = _plane(y0 * 10 + x0, rect.height, rect.width)
    ref = plane.clone()
    for lv in levels:
        tr.dwt97_inv_level_plain(ref, *lv)
    before = plane.clone()
    got = tr.inv_ping_pong(plane, levels, _host_launch(host_lib))
    assert _same_bits(got, ref)
    assert _same_bits(plane, before), "the packed plane is only read"
