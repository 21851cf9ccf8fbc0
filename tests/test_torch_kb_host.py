"""K-b's device code (csrc/dwt53.cu: ``dwt53_fwd_tile``) and the strip
half's "scratch" form (csrc/strip53_h.cu ``dwt53_horz``) compiled for the
host and held to their plain versions on the CPU, exactly; and the plain
version held to the JAX package's forward 5/3 where the sums wrap.

The kernel's source up to its host entry points is built by g++ against the
shim of tests/cuda_host_shim.py (a std::thread a CUDA thread, one block
after another) and launched as the C entry launches it: one 96-thread block
a 60 x 64 input tile. Its output goes to buffers that overlap the input
nowhere, with a border of sentinels that must stay as they were. The cases:
both origin parities on each axis, lines of 1, 2 and 3 samples, sizes one
below and one above a multiple of the tile in each direction, coefficients
within a few units of +-2^31 (the sums wrap, as the reference's wadd/wsub),
the LL quadrant into a buffer of its own, and three levels in the order
``forward_transform`` calls them (``fwd_ping_pong``: each level's input the
LL quadrant of the level before, in the other buffer). What this cannot
show: timing, occupancy, and anything nvcc compiles differently from g++;
the `cuda` tests of tests/test_torch_cuda.py hold the card."""

import ctypes
import re

import numpy as np
import pytest
import torch

from cuda_host_shim import SHIM_GLOBALS, build
from test_torch_kg_host import _plane  # seeded int32 planes, +-2^16 or within 8 of +-2^31
from test_torch_strip53_host import strip_lib  # the strip halves built for the host
from grok_tpu.core.rect import Rect as RefRect
from grok_tpu.ops import dwt as ref_dwt
from grok_tpu_torch import kernels
from grok_tpu_torch.core.rect import Rect
from grok_tpu_torch.ops import transform as tr

HARNESS = r"""
#include "shim.h"
#include "kernel.inc"
""" + SHIM_GLOBALS + r"""alignas(16) int32_t s_tile[FTR * FTP];
extern "C" int host_fwd(const void* src, long long ld, long long src_n, void* ll,
                        long long ld_ll, void* dst, long long ld_dst, int h, int w, int py,
                        int px) {
    g_ranges = {Range{(const char*)src, (const char*)src + 4 * src_n}};
    blockDim = {FWD_THREADS, 1, 1};
    for (int by = 0; by < (h + FTH - 1) / FTH; ++by)
        for (int bx = 0; bx < (w + FTW - 1) / FTW; ++bx) {
            Barrier blk;
            blk.n = FWD_THREADS;
            g_block = &blk;
            std::vector<Barrier> wb(FWD_THREADS / 32);
            std::vector<Exch> ex(FWD_THREADS / 32);
            for (auto& x : wb) x.n = 32;
            std::vector<std::thread> th;
            for (int t = 0; t < FWD_THREADS; ++t)
                th.emplace_back([&, t] {
                    threadIdx = {(unsigned)t, 0, 0};
                    blockIdx = {(unsigned)bx, (unsigned)by, 0};
                    t_warp = &wb[t / 32];
                    t_exch = &ex[t / 32];
                    dwt53_fwd_tile((const int32_t*)src, ld, (int32_t*)ll, ld_ll, (int32_t*)dst,
                                   ld_dst, h, w, py, px);
                });
            for (auto& x : th) x.join();
        }
    return 0;
}
"""
SENTINEL = -123456789


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("kb_host"), (kernels.CSRC / "dwt53.cu").read_text(),
                "// ---------------------------------------------------------------- the C "
                "entries", HARNESS, "kb")
    lib.host_fwd.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                             ctypes.c_longlong] + [ctypes.c_int] * 4
    return lib


def _host_launch(lib):
    """A launch taking what ``tr.level_launcher``'s launch takes for K-b, on
    CPU tensors: the natural-order src (read whole), the packed LL quadrant
    ll and the rest dst."""
    def launch(src, ll, dst, h, w, py, px):
        assert lib.host_fwd(src.data_ptr(), src.stride(0), src.numel(), ll.data_ptr(),
                            ll.stride(0), dst.data_ptr(), dst.stride(0), h, w, py, px) == 0
    return launch


def test_tile_constants_match_the_launch():
    """The launch above and the C entry share the tile: 60 x 64 inputs,
    96 threads, a halo of 2."""
    src = (kernels.CSRC / "dwt53.cu").read_text()
    define = {m[0]: int(m[1]) for m in re.findall(r"#define (\w+) (\d+)", src)}
    assert (define["FTH"], define["FTW"], define["HALO"], define["FWD_THREADS"]) == (60, 64, 2,
                                                                                    96)


# (h, w): lines of 1, 2 and 3 samples; under one tile; one below and one above
# a multiple of the tile (60 rows, 64 columns) in each direction
_SHAPES = [(1, 1), (1, 2), (2, 1), (1, 3), (3, 1), (2, 3), (3, 2), (1, 70), (70, 1), (2, 66),
           (37, 53), (59, 63), (61, 65), (119, 129), (121, 127)]


@pytest.mark.parametrize("py,px", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("h,w", _SHAPES, ids=[f"{h}x{w}" for h, w in _SHAPES])
def test_one_level_equals_plain(host_lib, h, w, py, px):
    """The LL quadrant and the rest into one buffer, as the in-place entry
    and the coarsest level of fwd_ping_pong launch it."""
    plane = _plane(h * 1000 + w + 7 * py + 3 * px, h + 2, w + 3)  # the level is its top-left
    ref = plane.clone()
    tr.dwt53_fwd_level_plain(ref, h, w, py, px)
    out = torch.full((h + 2, w + 5), SENTINEL, dtype=torch.int32)
    _host_launch(host_lib)(plane, out, out, h, w, py, px)
    assert torch.equal(out[:h, :w], ref[:h, :w])
    assert bool((out[h:] == SENTINEL).all() and (out[:, w:] == SENTINEL).all())


@pytest.mark.parametrize("py,px", [(0, 0), (1, 1), (0, 1)])
@pytest.mark.parametrize("h,w", [(1, 1), (1, 5), (4, 1), (3, 3), (61, 65)])
def test_wrapping_sums_equal_plain(host_lib, h, w, py, px):
    """Samples within 8 of +-2^31: the kernel's sums wrap as the plain
    version's int32 sums do."""
    plane = _plane(h * 100 + w + py + 2 * px, h, w, wrap=True)
    ref = plane.clone()
    tr.dwt53_fwd_level_plain(ref, h, w, py, px)
    out = torch.full((h + 1, w + 1), SENTINEL, dtype=torch.int32)
    _host_launch(host_lib)(plane, out, out, h, w, py, px)
    assert torch.equal(out[:h, :w], ref)
    # some sum wrapped before a shift, so in int64 the level differs (unless
    # an axis of one sample at odd origin doubles every sample, which cancels
    # the 2^31 a wrapped sum's shift leaves)
    if h * w > 1 and not (h == 1 and py) and not (w == 1 and px):
        wide = plane.long()
        tr.dwt53_fwd_level_plain(wide, h, w, py, px)
        assert not torch.equal(wide.to(torch.int32), ref)


@pytest.mark.parametrize("h,w,py,px", [(61, 65, 0, 0), (61, 65, 1, 1), (121, 127, 1, 0),
                                       (3, 2, 0, 1), (1, 4, 1, 0)])
def test_ll_quadrant_to_its_own_buffer(host_lib, h, w, py, px):
    """The LL quadrant goes to ll alone, the detail bands to dst alone."""
    plane = _plane(h + w + py, h, w)
    ref = plane.clone()
    tr.dwt53_fwd_level_plain(ref, h, w, py, px)
    snv, snh = (h + 1 - py) // 2, (w + 1 - px) // 2
    ll = torch.full((snv + 1, snh + 3), SENTINEL, dtype=torch.int32)
    dst = torch.full((h + 1, w + 2), SENTINEL, dtype=torch.int32)
    _host_launch(host_lib)(plane, ll, dst, h, w, py, px)
    assert torch.equal(ll[:snv, :snh], ref[:snv, :snh])
    assert bool((ll[snv:] == SENTINEL).all() and (ll[:, snh:] == SENTINEL).all())
    assert bool((dst[:snv, :snh] == SENTINEL).all()), "the LL quadrant is not in dst"
    got = dst[:h, :w].clone()
    got[:snv, :snh] = ref[:snv, :snh]
    assert torch.equal(got, ref)
    assert bool((dst[h:] == SENTINEL).all() and (dst[:, w:] == SENTINEL).all())


@pytest.mark.parametrize("y0,x0", [(0, 0), (3, 5), (2, 7)])
def test_three_levels_in_call_order(host_lib, y0, x0):
    """forward_transform's order: finest first through fwd_ping_pong, each
    level's input the LL quadrant of the level before (two scratches, apart
    from the buffer returned), against the plain levels in place; the plane
    is two rows and three columns larger than the rect, and the buffer
    returned keeps that border as it was."""
    rect = Rect(x0, y0, x0 + 150, y0 + 121)
    levels = [(r.height, r.width, r.y0 & 1, r.x0 & 1) for r in tr._levels(rect, 3)]
    plane = _plane(y0 * 10 + x0, rect.height + 2, rect.width + 3)
    plane[rect.height:] = SENTINEL
    plane[:, rect.width:] = SENTINEL
    ref = plane.clone()
    for lv in levels:
        tr.dwt53_fwd_level_plain(ref, *lv)
    before = plane.clone()
    got = tr.fwd_ping_pong(plane, levels, _host_launch(host_lib))
    assert torch.equal(got, ref)
    assert bool((got[rect.height:] == SENTINEL).all() and (got[:, rect.width:] == SENTINEL).all())
    assert torch.equal(plane, before), "the natural-order plane is only read"


@pytest.mark.parametrize("wrap", [False, True], ids=["16-bit", "near 2^31"])
@pytest.mark.parametrize("h,w,px", [(1, 1, 1), (3, 1, 0), (5, 2, 1), (9, 37, 0), (10, 70, 1)])
def test_strip_half_equals_plain(strip_lib, h, w, px, wrap):
    """dwt53_fwd_h's "scratch" form, lift_out with its sums in uint32_t:
    the plane's sub-block copied to a compact scratch and each row lifted
    back into the plane, as the plain version."""
    plane = _plane(h * 7 + w + px, h + 1, w + 2, wrap)
    ref = plane.clone()
    tr.dwt53_fwd_h_plain(ref, h, w, px)
    got = plane.clone()
    ptrs = np.array([got.data_ptr()], dtype=np.int64)
    tmp = torch.empty(h * w, dtype=torch.int32)
    assert strip_lib.host_scratch(1, ptrs.ctypes.data, 1, got.stride(0), h, w, px,
                                  tmp.data_ptr()) == 0
    assert torch.equal(got, ref)


def test_levels_on_the_cpu_equal_the_level_loop():
    """dwt53_fwd_levels on a CPU plane: the plain levels in place, the
    plane itself returned, as the one-level loop that forward_transform
    ran before."""
    rect = Rect(1, 2, 1 + 77, 2 + 45)
    levels = [(r.height, r.width, r.y0 & 1, r.x0 & 1) for r in tr._levels(rect, 4)]
    plane = _plane(9, rect.height, rect.width)
    ref = plane.clone()
    for lv in levels:
        tr.dwt53_fwd_level(ref, *lv)
    got = tr.dwt53_fwd_levels(plane, levels)
    assert got is plane and torch.equal(got, ref)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("wrap", [False, True], ids=["16-bit", "near 2^31"])
@pytest.mark.parametrize("x0,y0", [(0, 0), (1, 0), (0, 1), (3, 5)])
def test_plain_levels_equal_reference_forward(monkeypatch, x0, y0, wrap, native):
    """The plain levels against grok_tpu/ops/dwt.py forward with numpy, its
    native host path (wadd/wsub) or its int32 numpy lifting (which wraps as
    they do), three levels of a 29x38 rect at each origin parity."""
    monkeypatch.setenv("GROK_TPU_NATIVE_OPS", "1" if native else "0")
    h, w = 29, 38
    plane = _plane(x0 * 31 + y0 + 100 * wrap, h, w, wrap)
    want = ref_dwt.forward(np, plane.numpy().copy(), RefRect(x0, y0, x0 + w, y0 + h), 3, False)
    levels = [(r.height, r.width, r.y0 & 1, r.x0 & 1)
              for r in tr._levels(Rect(x0, y0, x0 + w, y0 + h), 3)]
    got = tr.dwt53_fwd_levels(plane.clone(), levels)
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
