"""K-i's device code (csrc/ebcot_dec.cu) compiled for the host and held to
its plain version on the CPU, exactly.

There is no nvcc here, so the kernel's source up to its host entry points
is built by g++ against the shim of tests/cuda_host_shim.py (a std::thread
a CUDA thread, barriers for __syncthreads and __syncwarp, every global load
and atomic checked against the launch's buffers). The launch follows the
wrapper's layout (ec.dec_layout, ec.dec_flat). What this cannot show:
timing, occupancy, and anything nvcc compiles differently from g++; the
`cuda` tests of tests/test_torch_cuda.py hold the card."""

import ctypes

import numpy as np
import pytest
import torch

from cuda_host_shim import SHIM_GLOBALS, build
from grok_tpu_torch import kernels
from grok_tpu_torch.t1 import ebcot_cuda as ec

HARNESS = r"""
#include "shim.h"
#include "kernel.inc"
""" + SHIM_GLOBALS + r"""alignas(16) uint8_t s_dyn[1 << 20];
extern "C" int host_decode(const void* data, int64_t nbytes, const void* starts, const void* lanes,
                           const void* segl, const void* ctx_tab, const void* mq_tab,
                           const void* order, void* out, int n, int max_segs, int bh, int bw,
                           int warps, int warp_bytes, int col_stripes) {
    auto R = [](const void* p, size_t b) { return Range{(const char*)p, (const char*)p + b}; };
    g_ranges = {R(data, nbytes), R(starts, 8 * n), R(lanes, 28 * n), R(segl, 4 * n * max_segs),
                R(ctx_tab, 198 * 4), R(mq_tab, 188 * 4), R(out, 4LL * n * bh * bw)};
    if (order) g_ranges.push_back(R(order, 4 * n));
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
                ebcot_dec_kernel((const uint8_t*)data, (const int64_t*)starts,
                                 (const int32_t*)lanes, (const int32_t*)segl,
                                 (const int32_t*)ctx_tab, (const int32_t*)mq_tab,
                                 (const int32_t*)order, (int32_t*)out, n, max_segs, bh, bw,
                                 warp_bytes, col_stripes);
            });
        for (auto& x : th) x.join();
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("ki_host"), (kernels.CSRC / "ebcot_dec.cu").read_text(),
                "static cudaError_t dec_attributes", HARNESS, "ki")
    lib.host_decode.argtypes = ([ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 7
                                + [ctypes.c_int] * 7)
    return lib


def _host_decode(lib, data, starts, lanes, seg, bh, bw, warps=None, order=None):
    """A launch as the wrapper lays it out: ``warps`` codeblocks a block
    (ec.dec_block_warps of a 132-SM card by default), ``order`` the
    codeblock each warp decodes."""
    n = lanes.shape[1]
    hw = lanes[2:4].to(torch.int64)
    stripes = (hw[0] + 3) // 4
    lay = ec.dec_layout(int((hw[0] * hw[1]).max()), int((stripes * hw[1]).max()),
                        int(torch.where(hw[1] <= 64, stripes, 0).max()),
                        warps or ec.dec_block_warps(n, 132))
    out = torch.zeros((n, bh, bw), dtype=torch.int32)
    tabs = ec.device_tables("cpu")
    flat = ec.dec_flat(data)
    lib.host_decode(flat.data_ptr(), flat.numel(), starts.data_ptr(), lanes.data_ptr(),
                    seg.data_ptr(), tabs["ctx"].data_ptr(), tabs["mq"].data_ptr(),
                    0 if order is None else order.data_ptr(), out.data_ptr(), n, seg.shape[1],
                    bh, bw, lay.warps, lay.warp_bytes, lay.col_stripes)
    return out


def _coded(n, bh, bw, bits, style, seed, cut, roi=False):
    """A seeded batch coded by the port's plain encoder, as K-i's inputs."""
    from test_torch_part1_decode import kernel_inputs

    rng = np.random.default_rng(seed)
    coeffs = np.clip(rng.laplace(size=(n, bh, bw)) * (1 << bits) / 12,
                     -(1 << bits) + 1, (1 << bits) - 1).astype(np.int32)
    coeffs[0, 0, 0] = (1 << bits) - 1
    hs, ws = rng.integers(1, bh + 1, n), rng.integers(1, bw + 1, n)
    hs[0], ws[0] = bh, bw
    ors, styles = rng.integers(0, 4, n), np.full(n, style)
    res = ec.encode_cblks(torch.from_numpy(coeffs), hs, ws, ors, styles=styles, want_dist=False)
    npasses = res.npasses.numpy()
    flat, starts, lens, keep, seg = kernel_inputs(
        res.data.numpy(), res.lengths.numpy(), npasses, res.pass_rates.numpy(), styles,
        rng.integers(0, npasses + 1) if cut else None, rng.integers(0, npasses + 1) if cut else None)
    sty = styles | (rng.integers(1, 8, n) << 8) if roi else styles
    lanes = np.stack([res.numbps.numpy(), keep, hs, ws, ors, sty, lens]).astype(np.int32)
    return [torch.from_numpy(flat), torch.from_numpy(starts.astype(np.int64)),
            torch.from_numpy(lanes), torch.from_numpy(seg)]


def _plain(args, bh, bw):
    tabs = ec.device_tables("cpu")
    return ec.ebcot_decode_plain(*args, tabs["ctx"], tabs["mq"], bh, bw)


@pytest.mark.parametrize("style,cut", [(0, False), (0x3F, False), (0x01, True), (0x08, True),
                                       (0x3F, True)])
def test_device_code_equals_plain(host_lib, style, cut):
    """Styles on partial stripes (13 rows), whole and stopped early with
    TERMALL/BYPASS segments merged across a layer boundary: decoded as the
    plain version decodes them."""
    args = _coded(8, 13, 16, 10, style, 1000 + style + cut, cut)
    assert torch.equal(_host_decode(host_lib, *args, 13, 16), _plain(args, 13, 16))


def test_device_code_roi_and_blocks_of_warps(host_lib):
    """ROI shifts 1..7 in the style bits, in blocks of four warps launched
    longest first (ec.dec_order): the plain version's samples."""
    args = _coded(10, 12, 8, 11, 0x3F, 1100, True, roi=True)
    got = _host_decode(host_lib, *args, 12, 8, warps=4, order=ec.dec_order(args[2][6], 2))
    assert torch.equal(got, _plain(args, 12, 8))


@pytest.mark.parametrize("style", [0, 0x3F, 0x05])
def test_device_code_on_garbage(host_lib, style):
    """Random segments, runs of 0xFF and marker codes (bytes above 0x8F)
    with random merged segment lengths: the same 0xFF rule and readers."""
    rng = np.random.default_rng(1200 + style)
    n, bh, bw = 12, 8, 12
    lens = rng.integers(0, 60, n)
    chunks = []
    for i in range(n):
        b = rng.integers(0, 256, lens[i]).astype(np.uint8)
        if i % 3 == 1:
            b[:] = 0xFF
        elif i % 3 == 2:
            b = np.where(rng.random(lens[i]) < 0.3, 0xFF,
                         rng.integers(0x90, 0x100, lens[i])).astype(np.uint8)
        chunks.append(b)
    nb = rng.integers(1, 12, n)
    segs = np.zeros((n, 6), dtype=np.int32)
    if style & 0x05:
        for i in range(n):
            cuts = np.sort(rng.integers(0, lens[i] + 1, 5))
            segs[i] = np.diff(np.concatenate([[0], cuts, [lens[i]]]))
    lanes = np.stack([nb, rng.integers(0, 3 * nb - 1), rng.integers(1, bh + 1, n),
                      rng.integers(1, bw + 1, n), rng.integers(0, 4, n), np.full(n, style), lens])
    args = [torch.from_numpy(np.concatenate(chunks)),
            torch.from_numpy((np.cumsum(lens) - lens).astype(np.int64)),
            torch.from_numpy(lanes.astype(np.int32)), torch.from_numpy(segs)]
    assert torch.equal(_host_decode(host_lib, *args, bh, bw), _plain(args, bh, bw))
