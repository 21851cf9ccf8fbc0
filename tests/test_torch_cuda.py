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


def _batch(seed, n, h, w, styles, bits=12):
    rng = np.random.default_rng(seed)
    mags = rng.integers(1, 1 << bits, size=n)
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


def _kernels_equal_plain(cuda, c, lanes, pmax, h, w):
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


# (64, 64): two codeblocks a warp; (16, 16), (32, 32): several; (7, 5),
# (13, 16): partial stripes; (4, 16), (3, 9): one stripe (ns = 1); (64, 4),
# (64, 1): narrower than 2*ns; (256, 16): ns = 64, stripes in two rounds.
# Magnitudes below 1 << 12 (pmaxc 16) for the first four shapes, 1 << 9 for
# the rest, which keeps their plain runs on the CPU short.
_SHAPES = [(64, 64, 12), (16, 16, 12), (32, 16, 12), (7, 5, 12), (32, 32, 9), (13, 16, 9),
           (4, 16, 9), (3, 9, 9), (64, 4, 9), (64, 1, 9), (256, 16, 9)]
_STYLES = [0x00, 0x3F, 0x01, 0x28, 0x04, 0x12]


@pytest.mark.parametrize("h,w,bits", _SHAPES, ids=[f"{h}-{w}" for h, w, _ in _SHAPES])
def test_ebcot_kernels_equal_plain(cuda, h, w, bits):
    c, lanes, pmax = _batch(h + w, 24, h, w, _STYLES, bits=bits)
    _kernels_equal_plain(cuda, c, lanes, pmax, h, w)


# K-c's shared memory past the 48 KB default. (64, 64) at pmaxc 20: two
# codeblocks a warp take 50.6 KB, which the launcher opts in to. (8, 512),
# (4, 1024) at pmaxc 16: 16 and 32 codeblocks a warp would take 385 KB and
# 801 KB, more than an SM holds, so the launcher gives each warp fewer.
@pytest.mark.parametrize("h,w,bits", [(64, 64, 17), (8, 512, 12), (4, 1024, 12)])
def test_ebcot_kernels_equal_plain_large_smem(cuda, h, w, bits):
    c, lanes, pmax = _batch(h * w + bits, 24, h, w, _STYLES, bits=bits)
    if (h, w) == (64, 64):
        assert pmax > 16
    _kernels_equal_plain(cuda, c, lanes, pmax, h, w)


@pytest.mark.parametrize("style", [0x08, 0x01, 0x04, 0x3F])
@pytest.mark.parametrize("h,w", [(32, 32), (13, 16)])
def test_ebcot_kernels_equal_plain_one_style(cuda, style, h, w):
    c, lanes, pmax = _batch(style + h, 12, h, w, [style], bits=14)
    _kernels_equal_plain(cuda, c, lanes, pmax, h, w)


def _near_capacity_records(h, w, pmax, n_raw, seed):
    """Records of one lane coding pmax planes: a few hundred MQ decisions,
    then n_raw raw bits whose every eighth bit is 0 (so no 0xFF and exactly
    one byte per eight bits), spread over every pass with gaps."""
    pmaxc = -(-pmax // 4) * 4
    ns = -(-h // 4)
    s_spp, s_mrp, s_cup, s_pad = ec.slot_counts(ns, w)
    rng = np.random.default_rng(seed)
    sym = np.zeros((pmaxc, 3, s_pad), dtype=np.uint8)
    slots = []
    for plane in range(pmax - 1, -1, -1):
        p = pmaxc - 1 - plane
        if plane < pmax - 1:
            slots += [(p, 0, i) for i in range(s_spp)] + [(p, 1, i) for i in range(s_mrp)]
        slots += [(p, 2, i) for i in range(s_cup)]
    keep = np.sort(rng.choice(len(slots), size=300 + n_raw, replace=False))
    for j, k in enumerate(keep):
        p, kind, i = slots[k]
        if j < 300:
            sym[p, kind, i] = 0x80 | (int(rng.integers(0, 2)) << 5) | int(rng.integers(0, 19))
        else:
            bit = 0 if (j - 300) % 8 == 0 else int(rng.integers(0, 2))
            sym[p, kind, i] = 0xC0 | (bit << 5)
    return sym


@pytest.mark.parametrize("extra,overflows", [(0, False), (64, True)])
def test_mq_pack_near_segment_capacity(cuda, extra, overflows):
    """Valid records over many 1 KB chunks and a segment that ends within a
    few bytes of max_bytes_for (past the coder's 2 KB shared window), then
    one that overflows: the kernel raises where the plain version does."""
    h, w, pmax = 64, 64, 2
    max_bytes = ec.max_bytes_for(pmax, h, w)  # 2176
    n_raw = 8 * (max_bytes - 300 // 8 - 6) + 8 * extra
    lane0 = _near_capacity_records(h, w, pmax, n_raw, seed=1)
    lane1 = _near_capacity_records(h, w, pmax, 4000, seed=2)
    sym = torch.from_numpy(np.stack([lane0, lane1, np.zeros_like(lane0)]))
    numbps = torch.tensor([pmax, pmax, 0], dtype=torch.int32)
    styles = torch.tensor([0, 0x3F, 0], dtype=torch.int32)
    tab = ec.device_tables(torch.device("cpu"))["mq"]
    dt = ec.device_tables(cuda)["mq"]
    if overflows:
        with pytest.raises(RuntimeError, match="overflow"):
            ec.mq_pack_plain(sym, numbps, styles, tab, h, w, pmax)
        with pytest.raises(RuntimeError, match="overflow"):
            ec.mq_pack(sym.to(cuda), numbps.to(cuda), styles.to(cuda), dt, h, w, pmax)
        return
    ref = ec.mq_pack_plain(sym, numbps, styles, tab, h, w, pmax)
    assert max_bytes - 16 <= int(ref[1][0]) <= max_bytes
    got = ec.mq_pack(sym.to(cuda), numbps.to(cuda), styles.to(cuda), dt, h, w, pmax)
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
