"""The 9/7 strip halves' "scratch" form (csrc/strip_h.cu ``scratch_lines``:
``dwt97_scratch_in``, four ``dwt97_scratch_step`` launches and
``dwt97_scratch_out``), which takes lines longer than shared memory holds,
compiled for the host and held to the plain versions on the CPU, on the
float32 bits.

The source up to its host entry points is built by g++ against the shim of
tests/cuda_host_shim.py, and ``scratch_lines`` runs as the C entry runs it,
with a launch that steps every thread of a 256-thread block through each
kernel (none has a barrier). The form is called directly at lines of 7 and
300 samples, both origin parities, forward and inverse, on a sub-block off
16-byte alignment inside a border of sentinels that must stay as it was.
What this cannot show: timing, and anything nvcc compiles differently from
g++; the `cuda` tests of tests/test_torch_cuda.py hold the card at 65,536
samples a line. The C entry runs ``scratch_lines`` on each plane of a
launch in turn, through its own h x w part of the scratch."""

import ctypes

import numpy as np
import pytest
import torch

from cuda_host_shim import SHIM_GLOBALS, build
from grok_tpu_torch import kernels
from grok_tpu_torch.ops import transform as tr

HARNESS = r"""
#include "shim.h"
#define __grid_constant__
#include "kernel.inc"
""" + SHIM_GLOBALS + r"""alignas(16) int32_t s_rows[H_MAX_LINE + 8];
// a launch on the host: every thread of a 1-d grid of 256-thread blocks, in turn
struct HostLaunch {
    template <class... P, class... A>
    int operator()(void (*kernel)(P...), int64_t items, A... args) const {
        blockDim = {256, 1, 1};
        for (int64_t b = 0; b < (items + 255) / 256; ++b)
            for (unsigned t = 0; t < 256; ++t) {
                blockIdx = {(unsigned)b, 0, 0};
                threadIdx = {t, 0, 0};
                kernel(args...);
            }
        return 0;
    }
};
extern "C" int host_scratch(int fwd, float* plane, float* tmp, long long ld, int h, int n,
                            int par) {
    return fwd ? scratch_lines<true>(HostLaunch{}, plane, tmp, ld, h, n, par)
               : scratch_lines<false>(HostLaunch{}, plane, tmp, ld, h, n, par);
}
"""
SENTINEL = -12345.5


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("strip97_long"), (kernels.CSRC / "strip_h.cu").read_text(),
                "// ---------------------------------------------------------------- the C "
                "entries", HARNESS, "strip97_long")
    lib.host_scratch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong] + [ctypes.c_int] * 3
    return lib


@pytest.mark.parametrize("fwd", [True, False], ids=["forward", "inverse"])
@pytest.mark.parametrize("par", [0, 1])
@pytest.mark.parametrize("n", [7, 300])
def test_scratch_form_equals_plain(host_lib, n, par, fwd):
    h, ld = 5, n + 3
    rng = np.random.default_rng(n * 4 + par * 2 + fwd)
    buf = torch.full((h + 2, ld), SENTINEL, dtype=torch.float32)
    buf[1:1 + h, 1:1 + n] = torch.from_numpy((rng.standard_normal((h, n)) * 300)
                                             .astype(np.float32))
    ref = buf.clone()
    (tr.dwt97_fwd_h_plain if fwd else tr.dwt97_inv_h_plain)(ref[1:, 1:], h, n, par)
    tmp = torch.empty(h * n, dtype=torch.float32)
    assert host_lib.host_scratch(int(fwd), buf.data_ptr() + 4 * (ld + 1), tmp.data_ptr(), ld, h,
                                 n, par) == 0
    assert torch.equal(buf.view(torch.int32), ref.view(torch.int32))


def test_forms_by_line_length():
    """Lines up to MAX_LINE take the shared-memory form, longer ones the
    scratch form, and so do a few lines past SHORT_LINE (a 9/7 launch is
    the rows of up to H_MAX_PLANES planes); the halves' source takes "smem"
    lines of up to MAX_LINE samples."""
    src = (kernels.CSRC / "strip_h.cu").read_text()
    assert "#define H_MAX_LINE (50 * 1024)" in src and tr.MAX_LINE == 50 * 1024
    assert (tr.h_form("dwt97_fwd_h", tr.MAX_LINE, 132, 132),
            tr.h_form("dwt97_fwd_h", 65536, 1024, 132)) == ("smem", "scratch")
    few = -(-132 // tr.FEW_LINES_DIV["dwt97"]) - 1  # the most lines a "scratch" launch
    lines = tr.h_lines([None] * 4, few // 4)
    assert lines == few // 4 * 4 and lines * tr.FEW_LINES_DIV["dwt97"] < 132
    assert (tr.h_form("dwt97_inv_h", tr.SHORT_LINE, lines, 132),
            tr.h_form("dwt97_inv_h", tr.SHORT_LINE + 1, lines, 132),
            tr.h_form("dwt97_inv_h", tr.SHORT_LINE + 1, few + 1, 132)) == (
                "smem", "scratch", "smem")
