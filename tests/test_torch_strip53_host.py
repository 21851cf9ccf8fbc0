"""The 5/3 strip halves' device code (csrc/strip_h.cu: the "smem" form's
``dwt53_fwd_rows`` and ``dwt53_inv_rows``, the "scratch" form's
``dwt53_horz`` and ``dwt53_inv_horz``) and their launch parameters
(``make_args``) compiled for the host and held exactly to the plain
versions on the CPU; the plain versions held to the JAX package's strip
halves where the sums wrap.

The source up to its C entries is built by g++ against the shim of
tests/cuda_host_shim.py (a std::thread a CUDA thread, one block after
another) and launched as the C entries launch it: the "smem" form one
256-thread block for every R rows of every plane (``make_args``), the
"scratch" form each sub-block copied to a compact scratch and lifted back
(forward) or lifted into it and copied back (inverse). Each sub-block sits
inside a buffer at row 1, column ``col0``, with a border of sentinels that
must stay as it was; every cp.async source is checked against the buffers.
The cases: both origin parities, widths 1, 2, 3, 5, 37, 70, 71 and 73,
rows whose address is 16-byte aligned and rows off it (a row stride that
is not a multiple of 4), samples within 8 of +-2^31 (the sums wrap), a row
count that is not a multiple of R, two
and four planes in one launch, and the "scratch" form at short lengths.
What this cannot show: timing, occupancy, and anything nvcc compiles
differently from g++; the `cuda` tests of tests/test_torch_cuda.py hold
the card."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_host_shim import SHIM_GLOBALS, build
from test_torch_kg_host import _plane  # seeded int32 planes, +-2^16 or within 8 of +-2^31
from grok_tpu.parallel import mesh as ref_mesh
from grok_tpu_torch import kernels
from grok_tpu_torch.ops import transform as tr

HARNESS = r"""
#include "shim.h"
#define __grid_constant__
#include "kernel.inc"
""" + SHIM_GLOBALS + r"""alignas(16) int32_t s_rows[H_MAX_LINE + 8];  // rows * pitch words at most
// the "smem" form of half 0 .. 3 (dwt53_fwd_h, dwt53_inv_h, dwt97_fwd_h,
// dwt97_inv_h) as the C entries launch it; returns the rows a block
extern "C" int host_rows(int half, const int64_t* planes, int n, long long ld, int h, int w,
                         int px, const int64_t* ranges, int nr) {
    HArgs a;
    if (!make_args(a, planes, n, ld, h, w, px) || w > H_MAX_LINE) return -1;
    g_ranges.clear();
    for (int i = 0; i < nr; ++i)
        g_ranges.push_back(Range{(const char*)ranges[2 * i], (const char*)ranges[2 * i + 1]});
    blockDim = {H_THREADS, 1, 1};
    for (int b = 0; b < n * a.bps; ++b) {
        Barrier blk;
        blk.n = H_THREADS;
        g_block = &blk;
        std::vector<Barrier> wb(H_THREADS / 32);
        std::vector<Exch> ex(H_THREADS / 32);
        for (auto& x : wb) x.n = 32;
        std::vector<std::thread> th;
        for (int t = 0; t < H_THREADS; ++t)
            th.emplace_back([&, t] {
                threadIdx = {(unsigned)t, 0, 0};
                blockIdx = {(unsigned)b, 0, 0};
                t_warp = &wb[t / 32];
                t_exch = &ex[t / 32];
                switch (half) {
                    case 0: dwt53_fwd_rows(a); break;
                    case 1: dwt53_inv_rows(a); break;
                    case 2: dwt97_rows<true>(a); break;
                    default: dwt97_rows<false>(a);
                }
            });
        for (auto& x : th) x.join();
    }
    return a.rows;
}
// the "scratch" form as the C entries run it, through tmp (n * h * w words)
extern "C" int host_scratch(int fwd, const int64_t* planes, int n, long long ld, int h, int w,
                            int px, int32_t* tmp) {
    HArgs a;
    if (!make_args(a, planes, n, ld, h, w, px)) return -1;
    auto copy = [&](bool to_tmp) {
        for (int i = 0; i < n; ++i)
            for (int y = 0; y < h; ++y) {
                int32_t* p = (int32_t*)planes[i] + y * ld;
                int32_t* t = tmp + ((int64_t)i * h + y) * w;
                memcpy(to_tmp ? t : p, to_tmp ? p : t, 4 * (size_t)w);
            }
    };
    if (fwd) copy(true);
    blockDim = {32, 8, 1};
    for (unsigned z = 0; z < (unsigned)n; ++z)
        for (unsigned by = 0; by < (unsigned)(h + 7) / 8; ++by)
            for (unsigned bx = 0; bx < (unsigned)(w + 31) / 32; ++bx)
                for (unsigned ty = 0; ty < 8; ++ty)
                    for (unsigned tx = 0; tx < 32; ++tx) {
                        blockIdx = {bx, by, z};
                        threadIdx = {tx, ty, 0};
                        if (fwd) dwt53_horz(tmp, a); else dwt53_inv_horz(tmp, a);
                    }
    if (!fwd) copy(false);
    return 0;
}
"""
SENTINEL = -123456789
# each half: its index in host_rows and its plain version
HALVES = {"fwd": (0, tr.dwt53_fwd_h_plain), "inv": (1, tr.dwt53_inv_h_plain),
          "fwd97": (2, tr.dwt97_fwd_h_plain), "inv97": (3, tr.dwt97_inv_h_plain)}


@pytest.fixture(scope="module")
def strip_lib(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("strip53"), (kernels.CSRC / "strip_h.cu").read_text(),
                "// ---------------------------------------------------------------- the C "
                "entries", HARNESS, "strip53")
    lib.host_rows.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
    lib.host_scratch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def _bufs(seed, n, h, w, ld, col0, wrap):
    """n buffers of (h + 2) x ld sentinels, each with a seeded h x w
    sub-block at row 1, column col0."""
    bufs = []
    for i in range(n):
        b = torch.full((h + 2, ld), SENTINEL, dtype=torch.int32)
        b[1:1 + h, col0:col0 + w] = _plane(seed + 17 * i, h, w, wrap)
        bufs.append(b)
    return bufs


def _run(lib, half, form, bufs, h, w, px, col0):
    """The half in ``form`` over the buffers' sub-blocks in one launch, then each
    buffer against the plain version of its copy on the bits, border
    included; returns the rows a block of the "smem" form."""
    ld, (index, plain) = bufs[0].shape[1], HALVES[half]
    refs = [b.clone() for b in bufs]
    for r in refs:
        plain(r[1:, col0:], h, w, px)
    ptrs = np.array([b.data_ptr() + 4 * (ld + col0) for b in bufs], dtype=np.int64)
    if form == "smem":
        ranges = np.array([(b.data_ptr(), b.data_ptr() + 4 * b.numel()) for b in bufs],
                          dtype=np.int64)
        rows = lib.host_rows(index, ptrs.ctypes.data, len(bufs), ld, h, w, px,
                             ranges.ctypes.data, len(bufs))
    else:
        tmp = torch.empty(len(bufs) * h * w, dtype=torch.int32)
        rows = lib.host_scratch(int(half == "fwd"), ptrs.ctypes.data, len(bufs), ld, h, w, px,
                                tmp.data_ptr())
    assert rows >= 0
    for b, r in zip(bufs, refs):
        assert torch.equal(b.view(torch.int32), r.view(torch.int32))
    return rows


def test_constants_match_the_wrapper():
    """The source and the wrapper agree on the planes a launch and the
    longest "smem" line; a block is 256 threads. The form: "smem" up to
    MAX_LINE samples, but "scratch" for a launch of fewer lines past
    SHORT_LINE than a fifth of the SMs (132 on an H100). A launch of any
    half takes up to H_MAX_PLANES planes."""
    src = (kernels.CSRC / "strip_h.cu").read_text()
    define = {m[0]: m[1] for m in re.findall(r"#define (H_\w+) (\S+(?: \* \d+\))?)", src)}
    assert int(define["H_PLANES"]) == tr.H_MAX_PLANES
    assert define["H_MAX_LINE"] == "(50 * 1024)" and tr.MAX_LINE == 50 * 1024
    assert int(define["H_THREADS"]) == 256
    assert [tr.h_form("dwt53_fwd_h", w, 27, 132)
            for w in (1, tr.MAX_LINE, tr.MAX_LINE + 1)] == ["smem", "smem", "scratch"]
    assert [tr.h_form("dwt53_inv_h", w, 26, 132)
            for w in (1, tr.SHORT_LINE, tr.SHORT_LINE + 1)] == ["smem", "smem", "scratch"]
    assert tr.h_lines([None] * 4, 16) == 64
    assert tr.h_lines([None] * 9, 2) == 2 * tr.H_MAX_PLANES


@pytest.mark.parametrize("wrap", [False, True], ids=["16-bit", "near 2^31"])
@pytest.mark.parametrize("w", [1, 2, 3, 5, 37, 70, 71, 73])
@pytest.mark.parametrize("px", [0, 1])
@pytest.mark.parametrize("half", ["fwd", "inv"])
def test_rows_equal_plain(strip_lib, half, px, w, wrap):
    """Five rows of one plane: rows 16-byte aligned (a row stride that is a
    multiple of 4 from an aligned base), then rows off it (column 1, a
    stride that is not). At 71 (parity 0) and 73 (parity 1) columns the s
    run has a multiple of 4 samples, so aligned rows store eight samples a
    thread and the last few one at a time."""
    for col0, ld in ((0, -(-(w + 1) // 4) * 4), (1, w + 2 + (w % 4 == 2))):
        assert _run(strip_lib, half, "smem", _bufs(w * 10 + px, 1, 5, w, ld, col0, wrap),
                    5, w, px, col0) == 5


@pytest.mark.parametrize("w,col0,want", [(1024, 0, 4), (1027, 1, 4), (4096, 0, 1),
                                          (2051, 1, 2)])
@pytest.mark.parametrize("px", [0, 1])
@pytest.mark.parametrize("half", ["fwd", "inv"])
def test_rows_not_a_multiple_of_r(strip_lib, half, px, w, col0, want):
    """Seven rows at 1,024 columns (and 1,027, off alignment): four rows a
    block, so the last block has three; at 2,051 columns (off alignment)
    two rows a block, the last block one; at the strip's 4,096 columns one
    row a block."""
    assert _run(strip_lib, half, "smem", _bufs(w + px, 1, 7, w, w + 4, col0, False),
                7, w, px, col0) == want


@pytest.mark.parametrize("n,h,w", [(2, 6, 70), (4, 9, 37), (4, 4, 4096)])
@pytest.mark.parametrize("half", ["fwd", "inv"])
def test_planes_in_one_launch(strip_lib, half, n, h, w):
    """Two and four planes of one shape, each its own data, in one launch
    (the shards of one card)."""
    _run(strip_lib, half, "smem", _bufs(n * 100 + w, n, h, w, w + 4, 0, True), h, w, 0, 0)


@pytest.mark.parametrize("wrap", [False, True], ids=["16-bit", "near 2^31"])
@pytest.mark.parametrize("w", [1, 2, 5, 70])
@pytest.mark.parametrize("px", [0, 1])
@pytest.mark.parametrize("half", ["fwd", "inv"])
def test_scratch_form_equals_plain(strip_lib, half, px, w, wrap):
    """The long-line form at short lengths, called directly: three planes
    through one compact scratch, rows off 16-byte alignment."""
    _run(strip_lib, half, "scratch", _bufs(w * 3 + px, 3, 4, w, w + 3, 1, wrap), 4, w, px, 1)


def test_list_form_on_the_cpu():
    """The wrappers take a plane or a list of planes of one shape on one
    device; on the CPU each plane gets the plain version."""
    planes = [_plane(s, 6, 10) for s in (1, 2, 3)]
    for fn, plain in ((tr.dwt53_fwd_h, tr.dwt53_fwd_h_plain),
                      (tr.dwt53_inv_h, tr.dwt53_inv_h_plain)):
        got = [p.clone() for p in planes]
        refs = [p.clone() for p in planes]
        fn(got, 5, 8, 1)
        for r in refs:
            plain(r, 5, 8, 1)
        assert all(torch.equal(g, r) for g, r in zip(got, refs))
        with pytest.raises(ValueError, match="one shape"):
            fn([planes[0], planes[1][:5].contiguous()], 5, 8, 0)
        with pytest.raises(ValueError, match="exceeds"):
            fn(planes, 7, 8, 0)


@pytest.mark.parametrize("wrap", [False, True], ids=["16-bit", "near 2^31"])
@pytest.mark.parametrize("w", [2, 8, 70])
def test_plain_halves_equal_reference(w, wrap):
    """The plain halves against grok_tpu/parallel/mesh.py _fwd53_h_local and
    _inv53_h_local (JAX on the CPU, int32, parity 0 and even widths as the
    strip runs them), where every sum of two neighbours wraps."""
    x = _plane(w + wrap, 6, w, wrap)
    got = x.clone()
    tr.dwt53_fwd_h_plain(got, 6, w, 0)
    want = np.asarray(ref_mesh._fwd53_h_local(jnp.asarray(x.numpy())))
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = got.clone()
    tr.dwt53_inv_h_plain(back, 6, w, 0)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(ref_mesh._inv53_h_local(jnp.asarray(want))))
    assert torch.equal(back, x)
