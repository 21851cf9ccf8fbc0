"""grok_tpu_torch's CUDA kernels against their plain torch versions, on the
card. Every test here is marked ``cuda`` and skips where no card is
present; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q

All four kernels are integer-only, so every comparison is exact."""

import numpy as np
import pytest
import torch

import grok_tpu_torch as gt
from grok_tpu_torch.ops import transform as tr
from grok_tpu_torch.t1 import ebcot_cuda as ec
from grok_tpu_torch.t1.ebcot import lane_numbps

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _launches(name):
    return gt.launch_counts()[name]


@pytest.mark.parametrize("nc", [1, 3, 4])
def test_dc_rct_kernel_equals_plain(cuda, nc):
    rng = np.random.default_rng(nc)
    planes = [torch.from_numpy(rng.integers(0, 4096, size=(67, 131)).astype(np.int32))
              for _ in range(nc)]
    dcs = [2048] * nc
    before = _launches("dc_rct_fwd")
    got = tr.dc_rct_fwd([p.to(cuda) for p in planes], dcs, nc >= 3)
    torch.cuda.synchronize()
    assert _launches("dc_rct_fwd") > before
    for g, r in zip(got, tr.dc_rct_fwd_plain(planes, dcs, nc >= 3)):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("h,w,py,px", [(1, 1, 0, 0), (1, 9, 1, 0), (2, 2, 1, 1),
                                       (37, 53, 0, 1), (64, 33, 1, 1), (129, 256, 0, 0)])
def test_dwt53_level_kernel_equals_plain(cuda, h, w, py, px):
    rng = np.random.default_rng(h * w)
    plane = torch.from_numpy(rng.integers(-(1 << 16), 1 << 16, size=(h + 3, w + 5))
                             .astype(np.int32))
    ref = plane.clone()
    tr.dwt53_fwd_level_plain(ref, h, w, py, px)
    got = plane.to(cuda)
    tr.dwt53_fwd_level(got, h, w, py, px)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


def _batch(seed, n, h, w, styles):
    rng = np.random.default_rng(seed)
    mags = rng.integers(1, 1 << 12, size=n)
    coeffs = (rng.standard_normal((n, h, w)) * mags[:, None, None] / 3).astype(np.int32)
    coeffs[0] = 0  # a lane with nothing to code
    heights = rng.integers(1, h + 1, size=n)
    widths = rng.integers(1, w + 1, size=n)
    heights[1], widths[1] = h, w
    c = torch.from_numpy(coeffs)
    hh, ww = torch.from_numpy(heights), torch.from_numpy(widths)
    nb = lane_numbps(c.abs(), hh, ww)
    lanes = torch.stack([nb, hh, ww, torch.from_numpy(rng.integers(0, 4, size=n)),
                         torch.from_numpy(np.asarray(styles)[rng.integers(0, len(styles), n)])])
    return c, lanes.to(torch.int32).contiguous(), int(nb.max())


@pytest.mark.parametrize("h,w", [(64, 64), (16, 16), (32, 16), (7, 5)])
def test_ebcot_kernels_equal_plain(cuda, h, w):
    c, lanes, pmax = _batch(h + w, 24, h, w, [0x00, 0x3F, 0x01, 0x28, 0x04, 0x12])
    pmaxc = -(-pmax // 4) * 4
    tab = ec.device_tables(torch.device("cpu"))
    ref_sym = ec.ebcot_symbols_plain(c, lanes, tab["ctx"], pmaxc)
    dt = ec.device_tables(cuda)
    sym = ec.ebcot_symbols(c.to(cuda), lanes.to(cuda), dt["ctx"], pmaxc)
    torch.cuda.synchronize()
    assert torch.equal(sym.cpu(), ref_sym)
    ref = ec.mq_pack_plain(ref_sym, lanes[0].contiguous(), lanes[4].contiguous(), tab["mq"],
                           h, w, pmax)
    got = ec.mq_pack(sym, lanes[0].to(cuda).contiguous(), lanes[4].to(cuda).contiguous(),
                     dt["mq"], h, w, pmax)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def test_compress_on_card_equals_plain_path(cuda):
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, size=(45, 70, 3)).astype(np.int32)
    params = dict(num_resolutions=4, cblk_width=32, cblk_height=32, cblk_style=0x3F)
    gt.reset_launch_counts()
    on_card = gt.compress(gt.Image.from_array(arr, prec=8), gt.CompressParams(**params))
    counts = gt.launch_counts()
    plain = gt.compress(gt.Image.from_array(arr, prec=8), gt.CompressParams(**params),
                        device="cpu")
    assert on_card == plain
    assert all(v > 0 for v in counts.values()), counts
