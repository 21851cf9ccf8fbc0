"""The 9/7 strip halves' "smem" form (csrc/strip_h.cu ``dwt97_rows``: rows
staged in shared memory, each quad lifted in registers with a halo of four
samples a side) compiled for the host and held to the plain versions on the
CPU, on the float32 bits; the plain versions held to the JAX package's
strip halves on the bits.

The source up to its C entries is built by g++ against the shim of
tests/cuda_host_shim.py (the 5/3 halves' harness of
tests/test_torch_strip53_host.py, which builds the same source) and
launched as the C entries launch it: one 256-thread block for every R rows
of every plane (``make_args``). Each sub-block sits inside a buffer at row
1, column ``col0``, with a border of sentinels that must stay as it was;
every cp.async source is checked against the buffers and, with its
destination, for its alignment. The cases: both origin parities, widths 1,
2, 3, 5, 37, 70, 71, 73 and 4,096, rows whose address is 16-byte aligned
and rows off it (a row stride that is not a multiple of 4), samples of
+-1e30 mixed with subnormals, a plane of NaN and +-inf among finite
samples, a row count that is not a multiple of R, and two and four planes
in one launch. What this cannot show: timing, occupancy, a vector load or
store off its alignment (the host takes it), and anything nvcc compiles
differently from g++; the `cuda` tests of tests/test_torch_cuda.py hold the
card, rows off alignment included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_strip53_host import _run, strip_lib  # noqa: F401 (the halves built for the host)
from grok_tpu.parallel import mesh as ref_mesh
from grok_tpu_torch.ops import transform as tr

SENTINEL = -12345.5
# x86's default NaN, the one inf - inf gives: every NaN of a run then has
# these bits whatever the order of a sum's operands
NAN = np.array([0xFFC00000], dtype=np.uint32).view(np.float32)[0]


def _plane(seed, h, w, kind="normal"):
    """A seeded float32 h x w plane: samples of about +-300 ("normal"),
    +-1e30 among subnormals ("extreme"), or +-300 with NaN, +inf and -inf
    at a tenth of the places each ("special")."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((h, w)) * 300).astype(np.float32)
    pick = rng.integers(0, 10, (h, w))
    if kind == "extreme":
        sub = (rng.integers(1, 1 << 23, (h, w)).astype(np.uint32)
               | (rng.integers(0, 2, (h, w)).astype(np.uint32) << 31)).view(np.float32)
        big = np.where(rng.integers(0, 2, (h, w)) == 1, np.float32(1e30), np.float32(-1e30))
        x = np.where(pick < 5, big, sub).astype(np.float32)
    elif kind == "special":
        x = np.where(pick == 0, NAN, np.where(pick == 1, np.float32(np.inf),
                                              np.where(pick == 2, np.float32(-np.inf), x)))
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _bufs(seed, n, h, w, ld, col0, kind="normal"):
    """n buffers of (h + 2) x ld sentinels, each with a seeded h x w
    sub-block at row 1, column col0."""
    bufs = []
    for i in range(n):
        b = torch.full((h + 2, ld), SENTINEL, dtype=torch.float32)
        b[1:1 + h, col0:col0 + w] = _plane(seed + 17 * i, h, w, kind)
        bufs.append(b)
    return bufs


@pytest.mark.parametrize("kind", ["normal", "extreme"])
@pytest.mark.parametrize("w", [1, 2, 3, 5, 37, 70, 71, 73, 4096])
@pytest.mark.parametrize("px", [0, 1])
@pytest.mark.parametrize("half", ["fwd97", "inv97"])
def test_rows_equal_plain(strip_lib, half, px, w, kind):
    """Three rows of one plane: rows 16-byte aligned (a row stride that is a
    multiple of 4 from an aligned base), then rows off it (column 1, a
    stride that is not), so the 16- and 8-byte accesses and their
    word-by-word forms both run. A window reaches past a line's end within
    four samples of it: under 12 columns every window is reflected, and at
    odd widths the s and d runs differ in length."""
    for col0, ld in ((0, -(-(w + 1) // 4) * 4), (1, w + 2 + (w % 4 == 2))):
        rows = _run(strip_lib, half, "smem", _bufs(w * 10 + px, 1, 3, w, ld, col0, kind),
                    3, w, px, col0)
        assert rows == (1 if w == 4096 else 3)


@pytest.mark.parametrize("w", [70, 71])
@pytest.mark.parametrize("px", [0, 1])
@pytest.mark.parametrize("half", ["fwd97", "inv97"])
def test_nan_and_inf(strip_lib, half, px, w):
    """NaN, +inf and -inf among finite samples, aligned and off alignment:
    the same bits as the plain version's, sign and payload of every NaN
    included."""
    for col0, ld in ((0, 72), (1, w + 3)):
        _run(strip_lib, half, "smem", _bufs(w + px, 1, 4, w, ld, col0, "special"), 4, w, px,
             col0)


@pytest.mark.parametrize("w,col0,want", [(1024, 0, 4), (1027, 1, 4), (4096, 0, 1),
                                          (2051, 1, 2)])
@pytest.mark.parametrize("px", [0, 1])
@pytest.mark.parametrize("half", ["fwd97", "inv97"])
def test_rows_not_a_multiple_of_r(strip_lib, half, px, w, col0, want):
    """Seven rows at 1,024 columns (and 1,027, off alignment): four rows a
    block, so the last block has three; at 2,051 columns (off alignment)
    two rows a block, the last block one; at the strip's 4,096 columns one
    row a block."""
    assert _run(strip_lib, half, "smem", _bufs(w + px, 1, 7, w, w + 4, col0),
                7, w, px, col0) == want


@pytest.mark.parametrize("n,h,w", [(2, 6, 70), (4, 9, 37), (4, 2, 4096)])
@pytest.mark.parametrize("half", ["fwd97", "inv97"])
def test_planes_in_one_launch(strip_lib, half, n, h, w):
    """Two and four planes of one shape, each its own data, in one launch
    (the shards of one card)."""
    _run(strip_lib, half, "smem", _bufs(n * 100 + w, n, h, w, w + 4, 0), h, w, 0, 0)


def test_list_form_on_the_cpu():
    """The wrappers take a plane or a list of planes of one shape on one
    device; on the CPU each plane gets the plain version."""
    planes = [_plane(s, 6, 10) for s in (1, 2, 3)]
    for fn, plain in ((tr.dwt97_fwd_h, tr.dwt97_fwd_h_plain),
                      (tr.dwt97_inv_h, tr.dwt97_inv_h_plain)):
        got = [p.clone() for p in planes]
        refs = [p.clone() for p in planes]
        fn(got, 5, 8, 1)
        for r in refs:
            plain(r, 5, 8, 1)
        assert all(torch.equal(g.view(torch.int32), r.view(torch.int32))
                   for g, r in zip(got, refs))
        with pytest.raises(ValueError, match="one shape"):
            fn([planes[0], planes[1][:5].contiguous()], 5, 8, 0)


@pytest.mark.parametrize("h,w", [(4, 8), (7, 70), (3, 4096)])
def test_plain_halves_equal_reference(h, w):
    """The plain halves against grok_tpu/parallel/mesh.py _fwd97_h_local and
    _inv97_h_local (JAX on the CPU, float32, parity 0 and even widths as the
    strip runs them), on the bits."""
    x = _plane(h * w, h, w)
    got = x.clone()
    tr.dwt97_fwd_h_plain(got, h, w, 0)
    want = np.asarray(ref_mesh._fwd97_h_local(jnp.asarray(x.numpy())))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    back = got.clone()
    tr.dwt97_inv_h_plain(back, h, w, 0)
    np.testing.assert_array_equal(
        back.numpy().view(np.int32),
        np.asarray(ref_mesh._inv97_h_local(jnp.asarray(want))).view(np.int32))
