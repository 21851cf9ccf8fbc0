"""grok_tpu_torch's CUDA kernels against their plain torch versions, on the
card. Every test here is marked ``cuda`` and skips where no card is
present; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q

Every comparison is exact: the nine kernels of the lossless paths, K-t
and K6's 5/3 steps, packing and block maxima are integer-only, the six of the 9/7 path (K-j ... K-o) round every
float product and sum on their own, as their plain versions do, and K-r
and K-s round each fused multiply-add once, as theirs do, so they are
compared on their float32 bits (K6's 9/7 steps and horizontal halves too),
and the float64 sums of rate control (K-p, K-e's energy, K-q) run in their
plain versions' order; K-w's float64 sum of squares is exact in any order."""

import functools

import numpy as np
import pytest
import torch

import grok_tpu_torch as gt
from grok_tpu_torch import kernels
from grok_tpu_torch.ops import transform as tr
from grok_tpu_torch.t1 import ebcot_cuda as ec
from grok_tpu_torch.t1 import ht as port_ht
from grok_tpu_torch.t1 import ht_cuda as hc
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


# K-b through every level as forward_transform calls it (one launch a level,
# out of place): a dist53 tile, a 4K plane, a height one above a multiple of
# K-b's 60-row tile at odd origins, and that with samples within 8 of +-2^31
# (every sum of two neighbours wraps)
@pytest.mark.parametrize("h,w,y0,x0,nl,wrap", [(1024, 1024, 0, 0, 5, False),
                                               (2160, 3840, 0, 0, 5, False),
                                               (121, 200, 1, 3, 3, False),
                                               (121, 200, 1, 3, 3, True),
                                               (61, 1, 0, 1, 2, False)],
                         ids=["1024x1024 tile", "2160x3840 plane", "121 rows, odd origin",
                              "121 rows, odd origin, near 2^31", "one column, odd origin"])
def test_dwt53_fwd_levels_kernel_equals_plain(cuda, h, w, y0, x0, nl, wrap):
    from grok_tpu_torch.core.rect import Rect

    rect = Rect(x0, y0, x0 + w, y0 + h)
    levels = [(r.height, r.width, r.y0 & 1, r.x0 & 1) for r in tr._levels(rect, nl)]
    rng = np.random.default_rng(h + w + nl)
    if wrap:
        near = rng.integers(0, 8, size=(h, w))
        odd = (np.arange(h)[:, None] + np.arange(w)[None, :]) & 1
        vals = np.where(odd, -(1 << 31) + near, (1 << 31) - 1 - near)
    else:
        vals = rng.integers(-(1 << 16), 1 << 16, size=(h, w))
    plane = torch.from_numpy(vals.astype(np.int32))
    ref = plane.clone()
    for lv in levels:
        tr.dwt53_fwd_level_plain(ref, *lv)
    on_card = plane.to(cuda)
    before = _launches("dwt53_fwd_level")
    got = tr.dwt53_fwd_levels(on_card, levels)
    torch.cuda.synchronize()
    assert _launches("dwt53_fwd_level") == before + len(levels)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(on_card.cpu(), plane), "the natural-order plane is only read"


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
    for name in ("dc_rct_fwd", "dwt53_fwd_level", "ebcot_symbols", "mq_pack"):
        assert counts[name] > 0, counts


# ------------------------------------------------------------ HT, inverse


def _ht_batch(seed, n, bh, bw, mag, density=0.5, ragged=False):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, mag + 1, size=(n, bh, bw)) * (rng.random((n, bh, bw)) < density)
    c = np.where(rng.random((n, bh, bw)) < 0.5, -c, c)
    h = rng.integers(1, bh + 1, size=n) if ragged else np.full(n, bh)
    w = rng.integers(1, bw + 1, size=n) if ragged else np.full(n, bw)
    c[0] = 0  # an all-zero codeblock has an empty segment
    for i in range(n):
        c[i, h[i]:] = 0
        c[i, :, w[i]:] = 0
    return (torch.from_numpy(c.astype(np.int32)), torch.from_numpy(h.astype(np.int32)),
            torch.from_numpy(w.astype(np.int32)))


def _ht_cases():
    stress = np.full((6, 64, 64), -((1 << 20) - 1), dtype=np.int32)
    stress[1] = (1 << 15) - 1
    stress[2] = np.random.default_rng(5).choice([-4095, 4095], size=(64, 64))
    stress[3, ::2] = 0
    stress[4, :, ::3] = 0
    full = torch.full((6,), 64, dtype=torch.int32)
    return {
        "64x64": _ht_batch(1, 16, 64, 64, 200),
        "32x32": _ht_batch(2, 16, 32, 32, 65000, 0.6),
        "16x16": _ht_batch(3, 16, 16, 16, (1 << 23) - 1, 0.3),
        "4x4": _ht_batch(4, 16, 4, 4, 3, 0.9),
        "8x32": _ht_batch(5, 16, 8, 32, 255, 1.0),
        "ragged": _ht_batch(6, 24, 64, 64, 500, 0.7, ragged=True),
        "odd": _ht_batch(7, 16, 7, 5, 100),
        "stuffing": (torch.from_numpy(stress), full, full.clone()),
    }


def _ht_encode_both(cuda, c, h, w):
    mmax = max((2 * int(c.abs().max()) - 1).bit_length(), 1)
    ref = hc.ht_cleanup_enc(c, h, w, hc.ht_tables(torch.device("cpu")), mmax)
    got = hc.ht_cleanup_enc(c.to(cuda), h.to(cuda), w.to(cuda), hc.ht_tables(cuda), mmax)
    torch.cuda.synchronize()
    return ref, got


@pytest.mark.parametrize("case", list(_ht_cases()))
def test_ht_kernels_equal_plain(cuda, case):
    c, h, w = _ht_cases()[case]
    before = (_launches("ht_cleanup_enc"), _launches("ht_cleanup_dec"))
    (rbuf, rlen), (gbuf, glen) = _ht_encode_both(cuda, c, h, w)
    assert torch.equal(glen.cpu(), rlen) and torch.equal(gbuf.cpu(), rbuf)
    data = rbuf[:, :max(int(rlen.max()), 2)].contiguous()
    bh, bw = c.shape[1:]
    ref = hc.ht_cleanup_dec(data, rlen.to(torch.int32), h, w, hc.ht_tables(torch.device("cpu")),
                            bh, bw)
    got = hc.ht_cleanup_dec(data.to(cuda), rlen.to(torch.int32).to(cuda), h.to(cuda), w.to(cuda),
                            hc.ht_tables(cuda), bh, bw)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    assert not bool(ref[1].any()) and torch.equal(ref[0], c)
    assert (_launches("ht_cleanup_enc"), _launches("ht_cleanup_dec")) > before


def test_ht_encode_kernel_raises_on_overflow(cuda):
    """A capacity sized for 1-bit MagSgn fields: the kernel flags the
    segments that do not fit and the wrapper raises, as the plain one does."""
    c, h, w = _ht_cases()["stuffing"]
    with pytest.raises(RuntimeError, match="overflow"):
        hc.ht_cleanup_enc(c, h, w, hc.ht_tables(torch.device("cpu")), 1)
    with pytest.raises(RuntimeError, match="overflow"):
        hc.ht_cleanup_enc(c.to(cuda), h.to(cuda), w.to(cuda), hc.ht_tables(cuda), 1)


@functools.lru_cache(maxsize=1)
def _ht_stress_cases():
    """Cases of K-e's warp design: rows of several 32-quad chunks (up to 512
    quads), tall narrow codeblocks, 25-bit MagSgn fields whose energies pass
    2^53, runs of 0xFF in MagSgn, VLC bytes stuffed after bytes above 0x8F,
    long MEL runs, all-zero codeblocks among full ones, and a batch larger
    than one wave of the card."""
    from test_torch_ke_host import vlc_stress, wide_batch

    rng = np.random.default_rng(40)
    top = (1 << 24) - 1
    big = rng.choice([top, -top, top - 1, -(top - 3), top - 7], size=(4, 64, 64))
    ff = np.zeros((8, 64, 64), dtype=np.int64)
    for i, k in enumerate((1, 3, 7, 8, 12, 15, 20, 23)):
        ff[i] = -(1 << k)
    ff[4::2, ::3, ::5] = -(1 << 6)
    sparse = np.zeros((6, 64, 64), dtype=np.int64)
    sparse[0, 5, 7], sparse[0, 40, 3], sparse[0, 63, 63] = 3, -200, 1
    sparse[1, ::9, ::11] = 5
    sparse[2:] = rng.integers(-40, 41, (4, 64, 64)) * (rng.random((4, 64, 64)) < 0.01)
    mixed = _ht_batch(41, 12, 64, 64, 900, 0.9)
    for i in (1, 4, 5, 9):
        mixed[0][i] = 0
    full = lambda n, v: torch.full((n,), v, dtype=torch.int32)  # noqa: E731
    as32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    return {
        "4x1024": _ht_batch(42, 4, 4, 1024, 500, 0.7),
        "1024x4": _ht_batch(43, 3, 1024, 4, 500, 0.7),
        "2x1024 ragged": _ht_batch(44, 6, 2, 1024, 60, 0.8, ragged=True),
        "25-bit MagSgn": (as32(big), full(4, 64), full(4, 64)),
        "32-bit MagSgn": tuple(wide_batch(46, 24, 64, 64)),
        "MagSgn 0xFF": (as32(ff), full(8, 64), full(8, 64)),
        "VLC 0x8F/0x7F": (vlc_stress(16, 64, 64), full(16, 64), full(16, 64)),
        "MEL runs": (as32(sparse), full(6, 64), full(6, 64)),
        "zero among full": tuple(mixed),
        "more than a wave": _ht_batch(45, 9000, 8, 8, 40, 0.6, ragged=True),
    }


@pytest.mark.parametrize("case", ["4x1024", "1024x4", "2x1024 ragged", "25-bit MagSgn",
                                  "32-bit MagSgn", "MagSgn 0xFF", "VLC 0x8F/0x7F", "MEL runs",
                                  "zero among full", "more than a wave"])
def test_ht_encode_kernel_equals_plain_stress(cuda, case):
    """K-e's segments, lengths and energies equal the plain version's, and
    K-f gives the samples back."""
    c, h, w = _ht_stress_cases()[case]
    bh, bw = c.shape[1:]
    mmax = max((2 * hc.largest_magnitude(c) - 1).bit_length(), 1)
    c_d, h_d, w_d, tab = c.to(cuda), h.to(cuda), w.to(cuda), hc.ht_tables(cuda)
    buf, lens, energy = hc.ht_cleanup_enc(c_d, h_d, w_d, tab, mmax, want_energy=True)
    rbuf, rlen = hc.ht_cleanup_enc(c, h, w, hc.ht_tables(torch.device("cpu")), mmax)
    assert torch.equal(lens.cpu(), rlen) and torch.equal(buf.cpu(), rbuf)
    assert torch.equal(energy.cpu(), hc.block_energy_plain(c, h, w))
    if case in ("25-bit MagSgn", "32-bit MagSgn"):
        assert float(energy.max()) > 2.0 ** 53
    # the kernel's stats (MEL events, stuffed MagSgn and VLC bytes) through
    # its C entry, with buffers of its own
    cap, aux = hc.segment_capacity(bh, bw, mmax)
    out, scratch = (torch.empty((c.shape[0], k), dtype=torch.uint8, device=cuda)
                    for k in (cap, aux))
    lengths = torch.empty(c.shape[0], dtype=torch.int32, device=cuda)
    stats = torch.zeros((c.shape[0], 3), dtype=torch.int32, device=cuda)
    kernels.KERNELS["ht_cleanup_enc"].call(
        c_d.data_ptr(), h_d.data_ptr(), w_d.data_ptr(), tab.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), lengths.data_ptr(), None, c.shape[0], bh, bw, cap, aux,
        hc.ENC_WARPS, stats.data_ptr(), kernels.stream_ptr(cuda))
    assert torch.equal(out, buf) and torch.equal(lengths.to(torch.int64), lens)
    stats = stats.sum(0).tolist()
    assert {"MagSgn 0xFF": stats[1], "VLC 0x8F/0x7F": stats[2],
            "MEL runs": stats[0]}.get(case, 1) > 0, stats
    data = buf[:, :max(int(rlen.max()), 2)].contiguous()
    dec, stopped = hc.ht_cleanup_dec(data, lens.to(torch.int32), h.to(cuda), w.to(cuda),
                                     hc.ht_tables(cuda), bh, bw)
    assert not bool(stopped.any()) and torch.equal(dec.cpu(), c)


@functools.lru_cache(maxsize=1)
def _kf_cases():
    """K-f's cases beyond random bytes: clean 64x64 segments cut at seeded
    lengths; invalid codewords at a pair's first and second quad (under
    tables that make every rho-15 codeword invalid: the reference's have
    none); 1024-wide rows whole, cut and with bytes flipped; and a batch of
    8x8 codeblocks, a third of them corrupted, larger than one wave of the
    card. name -> (segments, heights, widths, bh, bw, invalid tables)."""
    from test_torch_kf_host import (_blocks, cut_segments, encode_blocks, flip_bytes,
                                    invalid_codeword_case)

    c64 = _blocks(120, 24, 64, 64, 400, 0.7)
    inv = invalid_codeword_case()
    wide = _blocks(121, 3, 4, 1024, 90, 0.8)
    wsegs = encode_blocks(*wide)
    wsegs = wsegs + cut_segments(wsegs, 122) + flip_bytes(wsegs, 123)
    many = _blocks(124, 9000, 8, 8, 40, 0.6, ragged=True)
    msegs = encode_blocks(*many)
    msegs[::3] = flip_bytes(msegs[::3], 125, flips=1)
    return {
        "truncated": (cut_segments(encode_blocks(*c64), 126), *c64[1:], 64, 64, False),
        "invalid codeword at a pair's second quad": (encode_blocks(*inv[:3]), *inv[1:3], 8, 80,
                                                     True),
        "1024-wide rows": (wsegs, np.tile(wide[1], 3), np.tile(wide[2], 3), 4, 1024, False),
        "more than a wave": (msegs, *many[1:], 8, 8, False),
    }


@pytest.mark.parametrize("case", [109, 110, "truncated",
                                  "invalid codeword at a pair's second quad", "1024-wide rows",
                                  "more than a wave"])
def test_ht_decode_kernel_equals_plain_on_garbage(cuda, monkeypatch, case):
    tab_cpu, tab = hc.ht_tables(torch.device("cpu")), hc.ht_tables(cuda)
    if isinstance(case, int):
        rng = np.random.default_rng(case)
        n, L, bh, bw = 32, 400, 32, 32
        data = torch.from_numpy(rng.integers(0, 256, size=(n, L), dtype=np.uint8))
        lens = torch.from_numpy(rng.integers(0, L + 1, size=n).astype(np.int32))
        hw = torch.from_numpy(rng.integers(1, 33, size=(2, n)).astype(np.int32))
        h, w = hw[0].contiguous(), hw[1].contiguous()
    else:
        from test_torch_kf_host import invalid_rho15_tables, pack_segments

        segs, h, w, bh, bw, invalid = _kf_cases()[case]
        data, lens = pack_segments(segs, seed=127)
        h, w = (torch.tensor(np.asarray(a), dtype=torch.int32) for a in (h, w))
        if invalid:
            dec_tbl, tab_cpu = invalid_rho15_tables()
            monkeypatch.setattr(port_ht, "DEC_TBL", dec_tbl)
            tab = tab_cpu.to(cuda)
    ref = hc.ht_cleanup_dec(data, lens, h, w, tab_cpu, bh, bw)
    got = hc.ht_cleanup_dec(data.to(cuda), lens.to(cuda), h.to(cuda), w.to(cuda), tab, bh, bw)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    if not isinstance(case, int):
        assert bool(ref[1].any()) and (case == "invalid codeword at a pair's second quad"
                                       or not bool(ref[1].all()))
    if case == "1024-wide rows":  # the launch took over 48 KB of shared memory a block
        assert hc.dec_occupancy(bw)[1] > 48 * 1024


def test_ht_decode_kernel_flags_wide_fields(cuda):
    """MagSgn fields of 31 and 32 bits, a quad that stops at its second
    field (33 bits) after a 32-bit first, and random bytes: the kernel
    writes what the plain version writes (grok_tpu's default decoder's
    values, wrapped to int32, kept where a corrupt segment stops the
    decode) and flags the same codeblocks as stopped."""
    c = np.zeros((4, 32, 32), dtype=np.int64)
    c[0, :4, :4] = (1 << 29) + 12345
    c[1, 2, 2] = -(1 << 30)
    c[1, 5, 5] = (1 << 31) + 5  # alone in its quad: a 32-bit field
    c[2] = 77
    c[3, 0, 0], c[3, 0, 1], c[3, 1, 1] = (1 << 31) + 7, 5, 5
    segs = [port_ht.encode_cleanup(b, 32, 32) for b in c]
    rng = np.random.default_rng(109)
    segs += [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(2, 400, size=13)]
    n = len(segs)
    data = torch.zeros((n, max(map(len, segs))), dtype=torch.uint8)
    for i, s in enumerate(segs):
        data[i, :len(s)] = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    lens = torch.tensor([len(s) for s in segs], dtype=torch.int32)
    hw = torch.full((n,), 32, dtype=torch.int32)
    ref = hc.ht_cleanup_dec(data, lens, hw, hw, hc.ht_tables(torch.device("cpu")), 32, 32)
    got = hc.ht_cleanup_dec(data.to(cuda), lens.to(cuda), hw.to(cuda), hw.to(cuda),
                            hc.ht_tables(cuda), 32, 32)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    assert not bool(ref[1][:3].any()) and bool(ref[1][3]) and bool(ref[1][4:].any())
    assert int(ref[0][1, 5, 5]) == -2147483643
    assert int(ref[0][3, 0, 0]) == (1 << 31) + 7 - (1 << 32)
    assert int(ref[0][3].count_nonzero()) == 1


@pytest.mark.parametrize("h,w,py,px", [(1, 1, 0, 0), (1, 9, 1, 0), (2, 2, 1, 1),
                                       (37, 53, 0, 1), (64, 33, 1, 1), (129, 256, 0, 0)])
def test_dwt53_inv_level_kernel_equals_plain(cuda, h, w, py, px):
    rng = np.random.default_rng(h * w + 1)
    plane = torch.from_numpy(rng.integers(-(1 << 16), 1 << 16, size=(h + 3, w + 5))
                             .astype(np.int32))
    ref = plane.clone()
    tr.dwt53_inv_level_plain(ref, h, w, py, px)
    got = plane.to(cuda)
    tr.dwt53_inv_level(got, h, w, py, px)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


# K-g through every level as inverse_transform calls it (one launch a level,
# out of place): a dist53 tile, a 4K plane, a height one above a multiple of
# K-g's 60-row tile at odd origins, and that with coefficients within 8 of
# +-2^31 (every sum of two neighbours wraps)
@pytest.mark.parametrize("h,w,y0,x0,nl,wrap", [(1024, 1024, 0, 0, 5, False),
                                               (2160, 3840, 0, 0, 5, False),
                                               (121, 200, 1, 3, 3, False),
                                               (121, 200, 1, 3, 3, True)],
                         ids=["1024x1024 tile", "2160x3840 plane", "121 rows, odd origin",
                              "121 rows, odd origin, near 2^31"])
def test_dwt53_inv_levels_kernel_equals_plain(cuda, h, w, y0, x0, nl, wrap):
    from grok_tpu_torch.core.rect import Rect

    rect = Rect(x0, y0, x0 + w, y0 + h)
    levels = [(r.height, r.width, r.y0 & 1, r.x0 & 1) for r in reversed(tr._levels(rect, nl))]
    rng = np.random.default_rng(h + w + nl)
    if wrap:
        near = rng.integers(0, 8, size=(h, w))
        odd = (np.arange(h)[:, None] + np.arange(w)[None, :]) & 1
        vals = np.where(odd, -(1 << 31) + near, (1 << 31) - 1 - near)
    else:
        vals = rng.integers(-(1 << 16), 1 << 16, size=(h, w))
    plane = torch.from_numpy(vals.astype(np.int32))
    ref = plane.clone()
    for lv in levels:
        tr.dwt53_inv_level_plain(ref, *lv)
    on_card = plane.to(cuda)
    before = _launches("dwt53_inv_level")
    got = tr.dwt53_inv_levels(on_card, levels)
    torch.cuda.synchronize()
    assert _launches("dwt53_inv_level") == before + len(levels)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(on_card.cpu(), plane), "the packed plane is only read"


@pytest.mark.parametrize("nc,prec,signed", [(1, 8, False), (3, 8, False), (3, 12, True),
                                            (4, 16, False)])
def test_rct_inv_kernel_equals_plain(cuda, nc, prec, signed):
    rng = np.random.default_rng(nc * prec)
    planes = [torch.from_numpy(rng.integers(-(1 << prec), 1 << prec, size=(67, 131))
                               .astype(np.int32)) for _ in range(nc)]
    dcs = [0 if signed else 1 << (prec - 1)] * nc
    rng_ = [(-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if signed else (0, (1 << prec) - 1)] * nc
    ref = tr.rct_inv_dc_clip_plain([p.clone() for p in planes], dcs, rng_, nc >= 3)
    before = _launches("rct_inv_dc_clip")
    got = tr.rct_inv_dc_clip([p.to(cuda) for p in planes], dcs, rng_, nc >= 3)
    torch.cuda.synchronize()
    assert _launches("rct_inv_dc_clip") > before
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def test_ht_roundtrip_on_card_equals_plain_path(cuda):
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 256, size=(45, 70, 3)).astype(np.int32)
    params = dict(num_resolutions=4, cblk_width=32, cblk_height=32, ht=True)
    gt.reset_launch_counts()
    on_card = gt.compress(gt.Image.from_array(arr, prec=8), gt.CompressParams(**params))
    back = gt.decompress(on_card)
    counts = gt.launch_counts()
    plain = gt.compress(gt.Image.from_array(arr, prec=8), gt.CompressParams(**params),
                        device="cpu")
    assert on_card == plain
    for c, comp in enumerate(back.components):
        assert np.array_equal(comp.data, arr[:, :, c])
    for name in ("dc_rct_fwd", "dwt53_fwd_level", "ht_cleanup_enc", "ht_cleanup_dec",
                 "dwt53_inv_level", "rct_inv_dc_clip"):
        assert counts[name] > 0, counts


# ------------------------------------------------------- K-i ebcot_decode
def _decode_case(dev, n, bh, bw, bits, style, seed, cut):
    """K-i and its plain version on a seeded batch that the port's encoder
    wrote on the card; ``cut`` stops each codeblock at a seeded pass and
    splits its segments at a seeded layer boundary. Returns the batch and
    the card's result, checked equal to the plain one."""
    from test_torch_part1_decode import kernel_inputs

    rng = np.random.default_rng(seed)
    coeffs = np.clip(rng.laplace(size=(n, bh, bw)) * (1 << bits) / 12,
                     -(1 << bits) + 1, (1 << bits) - 1).astype(np.int32)
    coeffs[0, 0, 0] = (1 << bits) - 1  # numbps reaches bits
    hs, ws = rng.integers(1, bh + 1, n), rng.integers(1, bw + 1, n)
    hs[0], ws[0] = bh, bw
    ors, styles = rng.integers(0, 4, n), np.full(n, style)
    res = ec.encode_cblks(torch.from_numpy(coeffs).to(dev), hs, ws, ors, styles=styles)
    npasses = res.npasses.cpu().numpy()
    cutv = rng.integers(0, npasses + 1) if cut else None
    split = rng.integers(0, npasses + 1) if cut else None
    flat, starts, lens, keep, seg_arr = kernel_inputs(
        res.data.cpu().numpy(), res.lengths.cpu().numpy(), npasses,
        res.pass_rates.cpu().numpy(), styles, cutv, split)
    lanes = np.stack([res.numbps.cpu().numpy(), keep, hs, ws, ors, styles, lens])
    args = [torch.from_numpy(flat), torch.from_numpy(starts.astype(np.int64)),
            torch.from_numpy(lanes.astype(np.int32)), torch.from_numpy(seg_arr)]
    tabs = ec.device_tables(dev)
    before = _launches("ebcot_decode")
    got = ec.ebcot_decode(*(a.to(dev) for a in args), tabs["ctx"], tabs["mq"], bh, bw)
    torch.cuda.synchronize()
    assert _launches("ebcot_decode") == before + 1
    want = ec.ebcot_decode_plain(*args, tabs["ctx"].cpu(), tabs["mq"].cpu(), bh, bw)
    assert torch.equal(got.cpu(), want)
    inside = (np.arange(bh)[:, None] < hs[:, None, None]) & (np.arange(bw) < ws[:, None, None])
    return np.where(inside, coeffs, 0), got.cpu().numpy()


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
@pytest.mark.parametrize("style", [0, 0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x3F])
def test_ebcot_decode_kernel_equals_plain(cuda, style, cut):
    """Every style on partial stripes (13 rows), whole and stopped early
    with segments merged across a layer boundary."""
    want, got = _decode_case(cuda, 8, 13, 16, 10, style, style + 40 * cut, cut)
    if not cut:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("bh,bw,bits,style", [(3, 8, 12, 0x3F), (10, 6, 12, 0x3F),
                                              (64, 64, 19, 0), (64, 64, 20, 0x3F),
                                              (4, 1024, 6, 0x3F), (1024, 4, 6, 0x3F)])
def test_ebcot_decode_kernel_shapes(cuda, bh, bw, bits, style):
    """Short and narrow codeblocks, 64x64 at 19-20 planes, and the widest
    and tallest codeblocks (the largest flag planes in shared memory)."""
    want, got = _decode_case(cuda, 2, bh, bw, bits, style, bh * bw + bits, False)
    assert np.array_equal(got, want)
    _decode_case(cuda, 2, bh, bw, bits, style, bh + bw + bits, True)


def test_ebcot_decode_kernel_refuses_bad_inputs(cuda):
    tabs = ec.device_tables(cuda)
    data = torch.zeros(4, dtype=torch.uint8, device=cuda)
    starts = torch.zeros(1, dtype=torch.int64, device=cuda)
    seg = torch.zeros((1, 1), dtype=torch.int32, device=cuda)

    def lanes(**kw):
        row = dict(numbps=3, npasses=7, height=8, width=8, orient=0, style=0, length=4)
        row.update(kw)
        return torch.tensor(list(row.values()), dtype=torch.int32, device=cuda)[:, None]

    before = _launches("ebcot_decode")
    with pytest.raises(gt.UnsupportedFeatureError):
        ec.ebcot_decode(data, starts, lanes(numbps=31), seg, tabs["ctx"], tabs["mq"], 8, 8)
    with pytest.raises(ValueError):  # over 4096 samples: flag planes too large
        ec.ebcot_decode(data, starts, lanes(height=100, width=120), seg, tabs["ctx"],
                        tabs["mq"], 100, 120)
    with pytest.raises(ValueError):
        ec.ebcot_decode(data, starts, lanes().to(torch.int64), seg, tabs["ctx"], tabs["mq"],
                        8, 8)
    with pytest.raises(ValueError):
        ec.ebcot_decode(data, starts, lanes()[:6].contiguous(), seg, tabs["ctx"], tabs["mq"],
                        8, 8)
    with pytest.raises(ValueError):
        ec.ebcot_decode(data.cpu(), starts, lanes(), seg, tabs["ctx"], tabs["mq"], 8, 8)
    assert _launches("ebcot_decode") == before


def _garbage_batch(rng, n, bh, bw, style):
    """Random codeblock bytes: uniform, runs of 0xFF, and bytes above 0x8F
    (marker codes) with 0xFF among them; random numbps, passes, extents
    and, for TERMALL or BYPASS, random merged segment lengths."""
    lens = rng.integers(0, 90, n)
    chunks = []
    for i in range(n):
        b = rng.integers(0, 256, lens[i]).astype(np.uint8)
        if i % 4 == 1:
            b[:] = 0xFF
        elif i % 4 == 2:
            b = np.where(rng.random(lens[i]) < 0.3, 0xFF,
                         rng.integers(0x90, 0x100, lens[i])).astype(np.uint8)
        elif i % 4 == 3 and lens[i]:
            b[rng.integers(0, lens[i], 3)] = 0xFF
        chunks.append(b)
    nb = rng.integers(1, 16, n)
    npass = rng.integers(0, 3 * nb - 1)
    segs = np.zeros((n, 6), dtype=np.int32)
    if style & 0x05:
        for i in range(n):
            cuts = np.sort(rng.integers(0, lens[i] + 1, 5))
            segs[i] = np.diff(np.concatenate([[0], cuts, [lens[i]]]))
    lanes = np.stack([nb, npass, rng.integers(1, bh + 1, n), rng.integers(1, bw + 1, n),
                      rng.integers(0, 4, n), np.full(n, style), lens])
    return [torch.from_numpy(np.concatenate(chunks)),
            torch.from_numpy((np.cumsum(lens) - lens).astype(np.int64)),
            torch.from_numpy(lanes.astype(np.int32)), torch.from_numpy(segs)]


@pytest.mark.parametrize("style", [0, 0x01, 0x04, 0x08, 0x20, 0x3F])
def test_ebcot_decode_kernel_equals_plain_on_garbage(cuda, style):
    """Random and corrupt segments (0xFF runs, marker codes) decode on the
    card exactly as in the plain version: the same 0xFF rule past each
    segment, the same raw and MQ readers on garbage."""
    rng = np.random.default_rng(300 + style)
    args = _garbage_batch(rng, 24, 12, 20, style)
    tabs = ec.device_tables(cuda)
    got = ec.ebcot_decode(*(a.to(cuda) for a in args), tabs["ctx"], tabs["mq"], 12, 20)
    torch.cuda.synchronize()
    want = ec.ebcot_decode_plain(*args, tabs["ctx"].cpu(), tabs["mq"].cpu(), 12, 20)
    assert torch.equal(got.cpu(), want)


def _coded_full(dev, bh, bw, bits, style, seed, cut):
    """Two full codeblocks of bh x bw written by the port's encoder on the
    card, as K-i's inputs (numpy; ``cut`` stops each at a seeded pass)."""
    from test_torch_part1_decode import kernel_inputs

    rng = np.random.default_rng(seed)
    coeffs = np.clip(rng.laplace(size=(2, bh, bw)) * (1 << bits) / 12,
                     -(1 << bits) + 1, (1 << bits) - 1).astype(np.int32)
    coeffs[0, 0, 0] = (1 << bits) - 1
    hs, ws = np.full(2, bh), np.full(2, bw)
    ors, styles = rng.integers(0, 4, 2), np.full(2, style)
    res = ec.encode_cblks(torch.from_numpy(coeffs).to(dev), hs, ws, ors, styles=styles)
    npasses = res.npasses.cpu().numpy()
    flat, starts, lens, keep, seg = kernel_inputs(
        res.data.cpu().numpy(), res.lengths.cpu().numpy(), npasses,
        res.pass_rates.cpu().numpy(), styles, rng.integers(1, npasses + 1) if cut else None)
    lanes = np.stack([res.numbps.cpu().numpy(), keep, hs, ws, ors, styles, lens])
    return flat[:-1], starts, lanes.astype(np.int32), seg


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
def test_ebcot_decode_kernel_mixed_shapes_one_launch(cuda, cut):
    """64x64, 4x1024, 1024x4 and 3x8 codeblocks in one launch (a warp's
    shared state sized by the largest) decode as each shape does in a
    launch of its own, which equals the plain version."""
    tabs = ec.device_tables(cuda)
    T = torch.from_numpy
    shapes = [(64, 64, 14), (4, 1024, 6), (1024, 4, 6), (3, 8, 12)]
    parts, flats, starts, lanes, segs, total = [], [], [], [], [], 0
    for j, (bh, bw, bits) in enumerate(shapes):
        flat, st, ln, seg = _coded_full(cuda, bh, bw, bits, 0x3F if j % 2 else 0x08,
                                        500 + 7 * j + cut, cut)
        args = [T(np.concatenate([flat, np.zeros(1, np.uint8)])), T(st.astype(np.int64)),
                T(ln), T(seg)]
        own = ec.ebcot_decode(*(a.to(cuda) for a in args), tabs["ctx"], tabs["mq"], bh, bw)
        want = ec.ebcot_decode_plain(*args, tabs["ctx"].cpu(), tabs["mq"].cpu(), bh, bw)
        assert torch.equal(own.cpu(), want)
        parts.append(want.numpy())
        flats.append(flat)
        starts.append(st + total)
        total += len(flat)
        lanes.append(ln)
        segs.append(seg)
    ms = max(s.shape[1] for s in segs)
    seg_arr = np.concatenate([np.pad(s, ((0, 0), (0, ms - s.shape[1]))) for s in segs])
    got = ec.ebcot_decode(T(np.concatenate(flats)).to(cuda),
                          T(np.concatenate(starts).astype(np.int64)).to(cuda),
                          T(np.concatenate(lanes, 1)).to(cuda), T(seg_arr).to(cuda),
                          tabs["ctx"], tabs["mq"], 1024, 1024).cpu().numpy()
    for j, (bh, bw, _) in enumerate(shapes):
        blk = got[2 * j:2 * j + 2]
        assert np.array_equal(blk[:, :bh, :bw], parts[j])
        assert not blk[:, bh:].any() and not blk[:, :, bw:].any()


def test_ebcot_decode_kernel_batch_over_one_wave(cuda):
    """More codeblocks than the card holds at once: the launch takes them
    longest first (ec.dec_order) and equals the plain version, whole and
    cut; the whole decode equals the coefficients."""
    bh = bw = 8
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    layout = ec.dec_layout(bh * bw, 2 * bw, 2)  # the batch's largest codeblock is 8x8
    per_wave = layout.warps * ec.dec_blocks_per_sm(layout) * sms
    n = 2 * per_wave + 17
    assert ec.dec_waves(n, layout.warps, ec.dec_blocks_per_sm(layout), sms) == 3
    for cut in (False, True):
        want, got = _decode_case(cuda, n, bh, bw, 9, 0x3F if cut else 0, 620 + cut, cut)
        if not cut:
            assert np.array_equal(got, want)


@pytest.mark.parametrize("style", [0, 0x3F])
def test_ebcot_decode_kernel_30_planes(cuda, style):
    """numbps = 30 at 64x64, the largest the wrapper takes: magnitudes up
    to 3 << 29 in the scaled domain, whole and cut."""
    want, got = _decode_case(cuda, 2, 64, 64, 30, style, 700 + style, False)
    assert np.array_equal(got, want)
    _decode_case(cuda, 2, 64, 64, 30, style, 701 + style, True)


def test_ebcot_decode_kernel_empty_codeblocks(cuda):
    """Codeblocks with no passes, no planes or no bytes among full ones:
    theirs stay zero, the others decode as in the plain version."""
    from test_torch_part1_decode import kernel_inputs

    n, bh, bw, bits = 12, 16, 16, 9
    rng = np.random.default_rng(800)
    coeffs = np.clip(rng.laplace(size=(n, bh, bw)) * (1 << bits) / 12,
                     -(1 << bits) + 1, (1 << bits) - 1).astype(np.int32)
    coeffs[3] = 0  # no planes
    hs, ws = np.full(n, bh), np.full(n, bw)
    ors, styles = rng.integers(0, 4, n), np.full(n, 0x3F)
    res = ec.encode_cblks(torch.from_numpy(coeffs).to(cuda), hs, ws, ors, styles=styles)
    npasses = res.npasses.cpu().numpy()
    cut = npasses.copy()
    cut[[1, 6]] = 0  # no passes kept
    flat, starts, lens, keep, seg_arr = kernel_inputs(
        res.data.cpu().numpy(), res.lengths.cpu().numpy(), npasses,
        res.pass_rates.cpu().numpy(), styles, cut)
    lanes = np.stack([res.numbps.cpu().numpy(), keep, hs, ws, ors, styles, lens])
    lanes[1, 9] = 5  # passes but no bytes: every byte reads 0xFF
    lanes[6, 9] = 0
    args = [torch.from_numpy(flat), torch.from_numpy(starts.astype(np.int64)),
            torch.from_numpy(lanes.astype(np.int32)), torch.from_numpy(seg_arr)]
    tabs = ec.device_tables(cuda)
    got = ec.ebcot_decode(*(a.to(cuda) for a in args), tabs["ctx"], tabs["mq"], bh, bw).cpu()
    want = ec.ebcot_decode_plain(*args, tabs["ctx"].cpu(), tabs["mq"].cpu(), bh, bw)
    assert torch.equal(got, want)
    assert not got[[1, 3, 6]].any()
    full = [i for i in range(n) if i not in (1, 3, 6, 9)]
    assert np.array_equal(got[full].numpy(), coeffs[full])


def test_part1_layers_on_card_equal_plain_path(cuda):
    """grok_tpu's 0x3F three-layer stream, decoded on the card and with the
    plain versions at every max_layers."""
    import grok_tpu as gk

    arr = np.random.default_rng(6).integers(0, 256, size=(40, 36, 3)).astype(np.int32)
    stream = gk.compress(gk.Image.from_array(arr), gk.CompressParams(
        num_resolutions=3, num_layers=3, layer_rates=[20, 5, 1], cblk_style=0x3F,
        progression=gk.ProgressionOrder.RLCP))
    for ml in range(4):
        gt.reset_launch_counts()
        card = gt.decompress(stream, gt.DecompressParams(max_layers=ml))
        counts = gt.launch_counts()
        plain = gt.decompress(stream, gt.DecompressParams(max_layers=ml), device="cpu")
        for a, b in zip(card.components, plain.components):
            assert np.array_equal(a.data, b.data)
        if ml in (0, 3):
            assert all(np.array_equal(c.data, arr[:, :, k]) for k, c in enumerate(card.components))
        for name in ("ebcot_decode", "dwt53_inv_level", "rct_inv_dc_clip"):
            assert counts[name] > 0, counts



# ================================================================ 9/7 + ICT
def _same_bits(a, b):
    a, b = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (a, b))
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("nc", [1, 3, 4])
def test_dc_ict_kernel_equals_plain(cuda, nc):
    rng = np.random.default_rng(nc)
    planes = [torch.from_numpy(rng.integers(0, 4096, size=(67, 131)).astype(np.int32))
              for _ in range(nc)]
    dcs = [2048] * nc
    before = _launches("dc_ict_fwd")
    got = tr.dc_ict_fwd([p.to(cuda) for p in planes], dcs, nc >= 3)
    torch.cuda.synchronize()
    assert _launches("dc_ict_fwd") > before
    for g, r in zip(got, tr.dc_ict_fwd_plain(planes, dcs, nc >= 3)):
        assert _same_bits(g, r)


@pytest.mark.parametrize("h,w,py,px", [(1, 1, 0, 0), (1, 9, 1, 0), (9, 1, 0, 1), (2, 2, 1, 1),
                                       (3, 3, 0, 1), (37, 53, 0, 1), (64, 33, 1, 1),
                                       (129, 256, 0, 0), (2160, 3840, 0, 0)])
def test_dwt97_levels_kernel_equal_plain(cuda, h, w, py, px):
    """K-k then K-n, one level each, at odd and even origins, lines of one
    to three samples and a whole 4K plane."""
    rng = np.random.default_rng(h + w)
    plane = torch.from_numpy((rng.standard_normal((h + 3, w + 5)) * 400).astype(np.float32))
    ref = plane.clone()
    tr.dwt97_fwd_level_plain(ref, h, w, py, px)
    got = plane.to(cuda)
    before = _launches("dwt97_fwd_level")
    tr.dwt97_fwd_level(got, h, w, py, px)
    torch.cuda.synchronize()
    assert _launches("dwt97_fwd_level") == before + 1
    assert _same_bits(got, ref)
    tr.dwt97_inv_level_plain(ref, h, w, py, px)
    tr.dwt97_inv_level(got, h, w, py, px)
    torch.cuda.synchronize()
    assert _same_bits(got, ref)


def _fma_fwd97_row(x: np.ndarray) -> np.ndarray:
    """One forward 9/7 row (parity 0) with every x + c * (l + r) fused, as
    a contracting compiler emits it: c * sum is not rounded before the add
    (float64 holds the float32 product exactly)."""
    from grok_tpu_torch.ops.transform import ALPHA, BETA, DELTA, GAMMA, INV_K97, K97
    s, d = x[0::2].astype(np.float32), x[1::2].astype(np.float32)
    sn, dn = len(s), len(d)
    f32 = np.float32

    def fma(c, t, acc):
        return f32(np.float64(f32(c)) * np.float64(t) + np.float64(acc))
    for c, tgt in ((ALPHA, "d"), (BETA, "s"), (GAMMA, "d"), (DELTA, "s")):
        if tgt == "d":
            d = np.array([fma(c, f32(s[j] + s[min(j + 1, sn - 1)]), d[j]) for j in range(dn)])
        else:
            s = np.array([fma(c, f32(d[max(i - 1, 0)] + d[min(i, dn - 1)]), s[i])
                          for i in range(sn)])
    return np.concatenate([s * f32(INV_K97), d * f32(K97)]).astype(np.float32)


def test_dwt97_kernel_rounds_each_product_and_sum(cuda):
    """A row whose fused multiply-add result differs from the two-rounding
    one: K-k (built with -fmad=false) must give the two-rounding one."""
    for seed in range(100):
        row = (np.random.default_rng(seed).standard_normal((1, 64)) * 1000).astype(np.float32)
        ref = torch.from_numpy(row.copy())
        tr.dwt97_fwd_level_plain(ref, 1, 64, 0, 0)
        if not np.array_equal(_fma_fwd97_row(row[0]).view(np.int32), ref[0].numpy().view(np.int32)):
            break
    else:
        pytest.fail("no row tells a fused multiply-add from two roundings")
    got = torch.from_numpy(row).to(cuda)
    tr.dwt97_fwd_level(got, 1, 64, 0, 0)
    torch.cuda.synchronize()
    assert _same_bits(got, ref)


# K-k through every level as forward_transform calls it (one launch a
# level, out of place): a dist97 tile, a 4K plane, and a height one above a
# multiple of K-k's 56-row tile at odd origins
@pytest.mark.parametrize("h,w,y0,x0,nl", [(1024, 1024, 0, 0, 5), (2160, 3840, 0, 0, 5),
                                          (113, 200, 1, 3, 3)],
                         ids=["1024x1024 tile", "2160x3840 plane", "113 rows, odd origin"])
def test_dwt97_fwd_levels_kernel_equals_plain(cuda, h, w, y0, x0, nl):
    from grok_tpu_torch.core.rect import Rect

    rect = Rect(x0, y0, x0 + w, y0 + h)
    levels = [(r.height, r.width, r.y0 & 1, r.x0 & 1) for r in tr._levels(rect, nl)]
    rng = np.random.default_rng(h + w + nl)
    plane = torch.from_numpy((rng.standard_normal((h, w)) * 400).astype(np.float32))
    ref = plane.clone()
    for lv in levels:
        tr.dwt97_fwd_level_plain(ref, *lv)
    on_card = plane.to(cuda)
    before = _launches("dwt97_fwd_level")
    got = tr.dwt97_fwd_levels(on_card, levels)
    torch.cuda.synchronize()
    assert _launches("dwt97_fwd_level") == before + len(levels)
    assert _same_bits(got, ref)
    assert _same_bits(on_card, plane), "the natural-order plane is only read"


# K-n through every level as inverse_transform calls it (one launch a
# level, out of place): a dist97 tile, a 4K plane, and a height one above a
# multiple of K-n's 56-row tile at odd origins
@pytest.mark.parametrize("h,w,y0,x0,nl", [(1024, 1024, 0, 0, 5), (2160, 3840, 0, 0, 5),
                                          (113, 200, 1, 3, 3)],
                         ids=["1024x1024 tile", "2160x3840 plane", "113 rows, odd origin"])
def test_dwt97_inv_levels_kernel_equals_plain(cuda, h, w, y0, x0, nl):
    from grok_tpu_torch.core.rect import Rect

    rect = Rect(x0, y0, x0 + w, y0 + h)
    levels = [(r.height, r.width, r.y0 & 1, r.x0 & 1) for r in reversed(tr._levels(rect, nl))]
    rng = np.random.default_rng(h + w + nl)
    plane = torch.from_numpy((rng.standard_normal((h, w)) * 400).astype(np.float32))
    ref = plane.clone()
    for lv in levels:
        tr.dwt97_inv_level_plain(ref, *lv)
    on_card = plane.to(cuda)
    before = _launches("dwt97_inv_level")
    got = tr.dwt97_inv_levels(on_card, levels)
    torch.cuda.synchronize()
    assert _launches("dwt97_inv_level") == before + len(levels)
    assert _same_bits(got, ref)
    assert _same_bits(on_card, plane), "the packed plane is only read"


def _fma_inv97_row(y: np.ndarray) -> np.ndarray:
    """One inverse 9/7 row (parity 0) with every x - c * (l + r) fused, as
    a contracting compiler emits it (float64 holds the float32 product
    exactly)."""
    from grok_tpu_torch.ops.transform import ALPHA, BETA, DELTA, GAMMA, INV_K97, K97
    f32 = np.float32
    n = len(y)
    sn = (n + 1) // 2
    s, d = y[:sn].astype(np.float32) * f32(K97), y[sn:].astype(np.float32) * f32(INV_K97)
    dn = len(d)

    def fms(c, t, acc):
        return f32(np.float64(acc) - np.float64(f32(c)) * np.float64(t))
    for c, tgt in ((DELTA, "s"), (GAMMA, "d"), (BETA, "s"), (ALPHA, "d")):
        if tgt == "s":
            s = np.array([fms(c, f32(d[max(i - 1, 0)] + d[min(i, dn - 1)]), s[i])
                          for i in range(sn)])
        else:
            d = np.array([fms(c, f32(s[j] + s[min(j + 1, sn - 1)]), d[j]) for j in range(dn)])
    out = np.empty(n, dtype=np.float32)
    out[0::2], out[1::2] = s, d
    return out


def test_dwt97_inv_kernel_rounds_each_product_and_sum(cuda):
    """A row whose fused multiply-add inverse differs from the two-rounding
    one: K-n (built with -fmad=false) must give the two-rounding one."""
    for seed in range(100):
        row = (np.random.default_rng(seed).standard_normal((1, 64)) * 1000).astype(np.float32)
        ref = torch.from_numpy(row.copy())
        tr.dwt97_inv_level_plain(ref, 1, 64, 0, 0)
        if not np.array_equal(_fma_inv97_row(row[0]).view(np.int32),
                              ref[0].numpy().view(np.int32)):
            break
    else:
        pytest.fail("no row tells a fused multiply-add from two roundings")
    got = torch.from_numpy(row).to(cuda)
    tr.dwt97_inv_level(got, 1, 64, 0, 0)
    torch.cuda.synchronize()
    assert _same_bits(got, ref)


def _quant_tile(h, w, nc, levels, origin=(0, 0)):
    """(plane shapes, band tables) of a 9/7 tile of an h x w x nc image at
    origin (x0, y0), as tests/test_torch_quant_host.py makes them."""
    from grok_tpu_torch.codestream.compress import build_siz, build_tcp
    from grok_tpu_torch.tile.tile_processor import TileProcessor

    img = gt.Image.from_array(np.zeros((h, w, nc), dtype=np.uint8))
    img.x0, img.y0, img.x1, img.y1 = origin[0], origin[1], origin[0] + w, origin[1] + h
    img.finalize()
    p = gt.CompressParams(num_resolutions=levels + 1, irreversible=True)
    tp = TileProcessor(build_siz(img, p), build_tcp(img, p), 0, "cpu")
    tp._apply_band_quant()
    return [(g.rect.height, g.rect.width) for g in tp.geoms], tp.band_tables()


@pytest.mark.parametrize("h,w,nc,levels,origin", [(19, 22, 1, 1, (0, 0)),
                                                  (37, 53, 3, 3, (3, 5)),
                                                  (45, 77, 4, 5, (2, 3)),
                                                  (2160, 3840, 3, 5, (0, 0)),
                                                  (2161, 3839, 3, 5, (1, 1))])
def test_quant_kernels_equal_plain(cuda, h, w, nc, levels, origin):
    """K-l and K-m over a tile's planes, one launch each, equal their plain
    versions bit for bit."""
    shapes, bands = _quant_tile(h, w, nc, levels, origin)
    rng = np.random.default_rng(h)
    planes = [torch.from_numpy((rng.standard_normal(s) * 90).astype(np.float32))
              for s in shapes]
    before = (_launches("quant_deadzone"), _launches("dequant_midbin"))
    q = tr.quant_deadzone([p.to(cuda) for p in planes], bands)
    d = tr.dequant_midbin(q, bands)
    torch.cuda.synchronize()
    assert (_launches("quant_deadzone"), _launches("dequant_midbin")) == (before[0] + 1,
                                                                         before[1] + 1)
    q_ref = [tr.quant_deadzone_plain(p, b) for p, b in zip(planes, bands)]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(q, q_ref))
    assert all(_same_bits(a, tr.dequant_midbin_plain(b, bs))
               for a, b, bs in zip(d, q_ref, bands))


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_quant_kernels_on_views_off_alignment(cuda, shift):
    """Planes that are views of one buffer at any offset, as the decode's
    staging planes are: the outputs take the inputs' alignment."""
    shapes, bands = _quant_tile(45, 77, 3, 4, (1, 2))
    n = [h * w for h, w in shapes]
    rng = np.random.default_rng(shift)
    flat = torch.from_numpy(rng.integers(-3000, 3000, size=sum(n) + 8).astype(np.int32))
    flat = flat.to(cuda)
    views = [flat[shift + sum(n[:c]):shift + sum(n[:c + 1])].view(s)
             for c, s in enumerate(shapes)]
    d = tr.dequant_midbin(views, bands)
    q = tr.quant_deadzone(d, bands)
    torch.cuda.synchronize()
    for v, a, b, bs in zip(views, d, q, bands):
        assert a.data_ptr() % 16 == v.data_ptr() % 16
        assert _same_bits(a, tr.dequant_midbin_plain(v.cpu(), bs))
        assert torch.equal(b.cpu(), tr.quant_deadzone_plain(a.cpu(), bs))


def test_quant_kernels_past_one_launch(cuda):
    """Ten components of five levels (16 bands each): seven to a launch
    (its band limit), so two launches a direction."""
    shapes, bands = _quant_tile(70, 131, 10, 5, (1, 0))
    rng = np.random.default_rng(10)
    planes = [torch.from_numpy((rng.standard_normal(s) * 90).astype(np.float32))
              for s in shapes]
    before = _launches("quant_deadzone")
    q = tr.quant_deadzone([p.to(cuda) for p in planes], bands)
    torch.cuda.synchronize()
    assert _launches("quant_deadzone") == before + 2
    assert all(torch.equal(a.cpu(), tr.quant_deadzone_plain(p, b))
               for a, p, b in zip(q, planes, bands))


@pytest.mark.parametrize("nc", [1, 3, 4])
def test_ict_inv_kernel_equals_plain(cuda, nc):
    rng = np.random.default_rng(nc + 7)
    planes = [torch.from_numpy((rng.standard_normal((45, 77)) * 300).astype(np.float32))
              for _ in range(nc)]
    planes[0][0, :3] = torch.tensor([float("nan"), float("inf"), float("-inf")])
    dcs, ranges = [128] * nc, [(0, 255)] * nc
    got = tr.ict_inv_dc_round_clip([p.to(cuda) for p in planes], dcs, ranges, nc >= 3)
    torch.cuda.synchronize()
    for g, r in zip(got, tr.ict_inv_dc_round_clip_plain(planes, dcs, ranges, nc >= 3)):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("ht", [False, True])
def test_97_path_on_card_equals_plain_path(cuda, ht):
    """compress and decompress with irreversible=True on the card: the
    plain path's bytes and samples, and every 9/7 kernel launched."""
    rng = np.random.default_rng(5)
    arr = np.clip(rng.normal(128, 40, (40, 36, 3)), 0, 255).astype(np.int32)
    params = dict(num_resolutions=4, irreversible=True, ht=ht, cblk_width=16, cblk_height=16)
    gt.reset_launch_counts()
    on_card = gt.compress(gt.Image.from_array(arr), gt.CompressParams(**params))
    plain = gt.compress(gt.Image.from_array(arr), gt.CompressParams(**params), device="cpu")
    assert on_card == plain
    a = gt.decompress(on_card)
    b = gt.decompress(on_card, device="cpu")
    for x, y in zip(a.components, b.components):
        np.testing.assert_array_equal(x.data, y.data)
    counts = gt.launch_counts()
    assert all(counts[k] > 0 for k in ("dc_ict_fwd", "dwt97_fwd_level", "quant_deadzone",
                                       "dequant_midbin", "dwt97_inv_level",
                                       "ict_inv_dc_round_clip"))


# ------------------------------------- rate control: K-p, K-e's energy, K-q
# K-p sums a pass as an exact int64 reduction while npos * 4^(p+2) <= 2^53
# and keeps the plain version's order above: (24, 16, 16, 24) reaches planes
# above that bound (20 for 256 positions); at (12, 16, 16, 30) the
# refinements' sums pass 2^53 and round, so only the ordered sum agrees
@pytest.mark.parametrize("n,h,w,bits", [(24, 64, 64, 12), (24, 13, 16, 9), (24, 7, 5, 12),
                                        (12, 32, 32, 17), (24, 16, 16, 24),
                                        (12, 16, 16, 30)])
def test_pass_dist_kernel_equals_plain(cuda, n, h, w, bits):
    c, lanes, pmax = _batch(h * w + bits + 3, n, h, w, _STYLES, bits=bits)
    pmaxc = -(-pmax // 4) * 4
    sym = ec.ebcot_symbols(c.to(cuda), lanes.to(cuda), ec.device_tables(cuda)["ctx"], pmaxc)
    before = _launches("ebcot_pass_dist")
    got = ec.ebcot_pass_dist(sym, c.to(cuda), lanes[0].contiguous().to(cuda), pmax)
    torch.cuda.synchronize()
    assert _launches("ebcot_pass_dist") == before + 1
    ref = ec.pass_dist_from_records(sym.cpu(), c, lanes[0], pmax)
    assert got.dtype == torch.float64 and tuple(got.shape) == (n, max(3 * pmax - 2, 1))
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("case", ["64x64", "16x16", "ragged", "odd", "stuffing"])
def test_ht_energy_kernel_equals_plain(cuda, case):
    """K-e with its energy output: the energies equal the plain sums and
    the segments are those of K-e without it."""
    c, h, w = _ht_cases()[case]
    mmax = max((2 * int(c.abs().max()) - 1).bit_length(), 1)
    before = _launches("ht_cleanup_enc")
    buf, lens, energy = hc.ht_cleanup_enc(c.to(cuda), h.to(cuda), w.to(cuda),
                                          hc.ht_tables(cuda), mmax, want_energy=True)
    torch.cuda.synchronize()
    assert _launches("ht_cleanup_enc") == before + 1
    assert energy.dtype == torch.float64
    assert torch.equal(energy.cpu(), hc.block_energy_plain(c, h, w))
    rbuf, rlen = hc.ht_cleanup_enc(c, h, w, hc.ht_tables(torch.device("cpu")), mmax)
    assert torch.equal(lens.cpu(), rlen) and torch.equal(buf.cpu(), rbuf)


def _hull_inputs(seed, n=300, p=40):
    """Integer rates with zero-length steps, distortions with zeros, repeats
    and real values, and rows with no passes: ties everywhere."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(0, 4, size=(n, p))
    steps[rng.random((n, p)) < 0.3] = 0
    rates = np.cumsum(steps, axis=1).astype(np.int64)
    dists = rng.integers(0, 5, size=(n, p)).astype(np.float64) * 4.0
    dists[rng.random((n, p)) < 0.25] = 0.0
    dists[n // 2:] *= rng.random((n - n // 2, p))
    npasses = rng.integers(0, p + 1, size=n).astype(np.int32)
    npasses[:5] = 0
    npasses[5:10] = p
    return torch.from_numpy(rates), torch.from_numpy(dists), torch.from_numpy(npasses)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_hull_kernel_equals_plain(cuda, seed):
    from grok_tpu_torch.t2 import rate_control as rc

    rates, dists, npasses = _hull_inputs(seed)
    before = _launches("hull_slopes")
    got = rc.hull_slopes(rates.to(cuda), dists.to(cuda), npasses.to(cuda))
    torch.cuda.synchronize()
    assert _launches("hull_slopes") == before + 1
    assert torch.equal(got.cpu(), rc.hull_slopes(rates, dists, npasses))


@pytest.mark.parametrize("kw", [
    dict(irreversible=True, num_layers=3, layer_rates=[32, 16, 8]),
    dict(num_layers=2, layer_rates=[16, 1], cblk_style=0x3F),
    dict(irreversible=True, num_layers=2, layer_psnrs=[30, 40]),
    dict(ht=True, irreversible=True, num_layers=2, layer_rates=[20, 1]),
], ids=["97_rates", "53_0x3f_rates", "97_psnrs", "ht_rates"])
def test_rate_control_on_card_equals_plain_path(cuda, kw):
    """compress with layers and targets on the card: the plain path's
    bytes, through K-p (Part-1) or K-e's energy (HT) and K-q; and the
    layer-limited decodes equal."""
    rng = np.random.default_rng(8)
    arr = np.clip(rng.normal(128, 40, (40, 48, 3)), 0, 255).astype(np.int32)
    params = dict(num_resolutions=3, cblk_width=16, cblk_height=16, **kw)
    gt.reset_launch_counts()
    on_card = gt.compress(gt.Image.from_array(arr), gt.CompressParams(**params))
    counts = gt.launch_counts()
    assert counts["hull_slopes"] == 1
    assert counts["ht_cleanup_enc" if kw.get("ht") else "ebcot_pass_dist"] == 1
    assert on_card == gt.compress(gt.Image.from_array(arr), gt.CompressParams(**params),
                                  device="cpu")
    for k in (0, 1):
        a = gt.decompress(on_card, gt.DecompressParams(max_layers=k))
        b = gt.decompress(on_card, gt.DecompressParams(max_layers=k), device="cpu")
        for x, y in zip(a.components, b.components):
            np.testing.assert_array_equal(x.data, y.data)


# ------------------------------ the Part-2 MCT (K-r, K-s) and ROI (K-t, K-i)
def _bits32(t):
    return t.cpu().view(torch.int32)


@pytest.mark.parametrize("n", [1, 3, 4, 6, 17, 127])
def test_mct_kernels_equal_plain(cuda, n):
    """K-r and K-s against their plain versions on float32 bits, NaN and
    infinities through K-s's finish included (127 components on a small
    plane: the plain versions take 2 N^2 tensor steps)."""
    rng = np.random.default_rng(n + 50)
    shape = (61, 97) if n <= 17 else (5, 13)
    planes = [torch.from_numpy(rng.integers(0, 4096, shape).astype(np.int32))
              for _ in range(n)]
    m = np.eye(n) + rng.uniform(-0.4, 0.4, (n, n))
    dcs = [2048] * n
    before = _launches("dc_mct_fwd")
    fwd = tr.dc_mct_fwd([p.to(cuda) for p in planes], dcs, m)
    torch.cuda.synchronize()
    assert _launches("dc_mct_fwd") == before + 1
    want = tr.dc_mct_fwd_plain(planes, dcs, m)
    for g, w in zip(fwd, want):
        assert torch.equal(_bits32(g), w.view(torch.int32))
    fwd[0][0, :3] = torch.tensor([float("nan"), float("inf"), -1e30])
    inv = np.linalg.inv(m)
    offs, ranges = [2048.0] * n, [(0, 4095)] * n
    before = _launches("mct_inv_round_clip")
    got = tr.mct_inv_round_clip(fwd, inv, offs, ranges)
    torch.cuda.synchronize()
    assert _launches("mct_inv_round_clip") == before + 1
    for g, w in zip(got, tr.mct_inv_round_clip_plain([f.cpu() for f in fwd], inv, offs, ranges)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("mixed", [False, True], ids=["one alignment", "mixed alignments"])
@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("n", [1, 3, 4, 6, 17, 127])
def test_mct_kernels_on_views_off_alignment(cuda, n, shift, mixed):
    """Planes that are views of one buffer, the first ``shift`` samples past
    16-byte alignment, the others at its alignment (4K samples a plane: K-r's
    16-byte path) or not (4K + 1: sample by sample): K-r's outputs take the
    first input's alignment, both kernels equal their plain versions, one
    launch a call, and a call once the matrix is on the card allocates its
    outputs and nothing else."""
    rng = np.random.default_rng(n + 10 * shift)
    shape = ((37, 40) if n <= 17 else (3, 8)) if not mixed else ((37, 41) if n <= 17 else (3, 7))
    size = shape[0] * shape[1]
    flat = torch.from_numpy(rng.integers(0, 4096, n * size + 8).astype(np.int32)).to(cuda)
    base = (shift - (flat.data_ptr() >> 2)) & 3
    views = [flat[base + k * size:base + (k + 1) * size].view(shape) for k in range(n)]
    m = (np.eye(n) + rng.uniform(-0.4, 0.4, (n, n))).astype(np.float32)
    inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
    dcs, offs, ranges = [2048] * n, [2048.0] * n, [(0, 4095)] * n
    tr.mct_inv_round_clip(tr.dc_mct_fwd(views, dcs, m), inv, offs, ranges)  # the matrices cached
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    before = (_launches("dc_mct_fwd"), _launches("mct_inv_round_clip"))
    fwd = tr.dc_mct_fwd(views, dcs, m)
    got = tr.mct_inv_round_clip(fwd, inv, offs, ranges)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] - allocs == 2 * n
    assert (_launches("dc_mct_fwd"), _launches("mct_inv_round_clip")) == (before[0] + 1,
                                                                         before[1] + 1)
    cpu = [v.cpu() for v in views]
    for f, w in zip(fwd, tr.dc_mct_fwd_plain(cpu, dcs, m)):
        assert f.data_ptr() % 16 == views[0].data_ptr() % 16
        assert torch.equal(_bits32(f), w.view(torch.int32))
    for g, w in zip(got, tr.mct_inv_round_clip_plain([f.cpu() for f in fwd], inv, offs, ranges)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("shift", [1, 4, 6, 30])
@pytest.mark.parametrize("shape,offset", [((53, 77), 0), ((1, 1), 1), ((1, 3), 1), ((1, 5), 1),
                                          ((7, 573), 1), ((7, 573), 0)])
def test_roi_kernels_equal_plain(cuda, shift, shape, offset):
    """K-t on planes of 4K + 1 and 4K + 3 samples and of 1, 3 and 5, at a
    16-byte aligned base and one element past it (roi_up's scalar head and
    tail), on values that wrap when shifted."""
    rng = np.random.default_rng(shift)
    a = rng.integers(-(1 << 20), 1 << 20, shape).astype(np.int32)
    a.reshape(-1)[:5] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1,
                         -(1 << shift)][:a.size]
    t = torch.from_numpy(a)
    for name, fn, plain in (("roi_up", tr.roi_up, tr.roi_up_plain),
                            ("roi_down", tr.roi_down, tr.roi_down_plain)):
        buf = torch.empty(a.size + offset, dtype=torch.int32, device=cuda)
        x = buf[offset:].view(shape)
        x.copy_(t)
        before = _launches(name)
        got = fn(x, shift)
        torch.cuda.synchronize()
        assert _launches(name) == before + 1
        assert torch.equal(got.cpu(), plain(t.clone(), shift))


@pytest.mark.parametrize("style", [0, 0x08, 0x3F])
def test_ebcot_decode_kernel_roi_writeout_equals_plain(cuda, style):
    """K-i with ROI shifts 1..7 in style bits 8-15 on codeblocks stopped at
    seeded passes: the card's writeout equals the plain version's."""
    from test_torch_part1_decode import kernel_inputs

    n, bh, bw, bits = 8, 13, 16, 10
    rng = np.random.default_rng(style + 70)
    coeffs = np.clip(rng.laplace(size=(n, bh, bw)) * (1 << bits) / 12,
                     -(1 << bits) + 1, (1 << bits) - 1).astype(np.int32)
    hs, ws = rng.integers(1, bh + 1, n), rng.integers(1, bw + 1, n)
    ors, styles = rng.integers(0, 4, n), np.full(n, style)
    res = ec.encode_cblks(torch.from_numpy(coeffs).to(cuda), hs, ws, ors, styles=styles)
    npasses = res.npasses.cpu().numpy()
    flat, starts, lens, keep, seg_arr = kernel_inputs(
        res.data.cpu().numpy(), res.lengths.cpu().numpy(), npasses,
        res.pass_rates.cpu().numpy(), styles, rng.integers(0, npasses + 1))
    roi = styles | (rng.integers(1, 8, n) << 8)
    lanes = np.stack([res.numbps.cpu().numpy(), keep, hs, ws, ors, roi, lens])
    args = [torch.from_numpy(flat), torch.from_numpy(starts.astype(np.int64)),
            torch.from_numpy(lanes.astype(np.int32)), torch.from_numpy(seg_arr)]
    tabs = ec.device_tables(cuda)
    got = ec.ebcot_decode(*(a.to(cuda) for a in args), tabs["ctx"], tabs["mq"], bh, bw)
    torch.cuda.synchronize()
    want = ec.ebcot_decode_plain(*args, tabs["ctx"].cpu(), tabs["mq"].cpu(), bh, bw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kw", [
    dict(mct_matrix=[[0.6, 0.3, 0.1], [-0.3, 0.5, -0.2], [0.1, -0.4, 0.5]]),
    dict(mct_matrix=[[0.6, 0.3, 0.1], [-0.3, 0.5, -0.2], [0.1, -0.4, 0.5]], ht=True,
         num_layers=2, layer_rates=[20, 8]),
    dict(roi_comp=0, roi_shift=4, ht=True),
    dict(roi_comp=1, roi_shift=6, irreversible=True, num_layers=3, layer_rates=[32, 16, 8]),
    dict(roi_comp=2, roi_shift=5, tile_size=(24, 24)),
], ids=["mct_97", "mct_97_ht_rates", "roi_53_ht", "roi_97_layers", "roi_53_tiles"])
def test_mct_roi_on_card_equals_plain_path(cuda, kw):
    """compress and decompress with the Part-2 MCT or ROI on the card: the
    plain path's bytes and samples, max_layers 0 and 1, through K-r and K-s
    or K-t."""
    rng = np.random.default_rng(9)
    arr = np.clip(rng.normal(128, 40, (40, 48, 3)), 0, 255).astype(np.int32)
    params = dict(num_resolutions=3, **kw)
    gt.reset_launch_counts()
    on_card = gt.compress(gt.Image.from_array(arr), gt.CompressParams(**params))
    assert on_card == gt.compress(gt.Image.from_array(arr), gt.CompressParams(**params),
                                  device="cpu")
    for k in (0, 1):
        a = gt.decompress(on_card, gt.DecompressParams(max_layers=k))
        b = gt.decompress(on_card, gt.DecompressParams(max_layers=k), device="cpu")
        for x, y in zip(a.components, b.components):
            np.testing.assert_array_equal(x.data, y.data)
    counts = gt.launch_counts()
    if "mct_matrix" in kw:
        assert counts["dc_mct_fwd"] == 1 and counts["mct_inv_round_clip"] == 2
    else:
        assert counts["roi_up"] >= 1
        assert (counts["roi_down"] > 0) == bool(kw.get("ht"))


# ------------------------------------------------------------- K6
@pytest.mark.parametrize("h,w", [(2, 1), (8, 37), (64, 128), (1024, 4096)])
@pytest.mark.parametrize("update", [False, True])
@pytest.mark.parametrize("with_halo", [False, True])
def test_strip_step_kernels_equal_plain(cuda, h, w, update, with_halo):
    """K-u, every step of 5/3 and 9/7 forward and inverse, on a sub-block of
    a wider shard, with and without a halo row."""
    from grok_tpu_torch.parallel import ops as k6

    rng = np.random.default_rng(h * w + update)
    ints = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (h + 2, w + 3)).astype(np.int32))
    flts = torch.from_numpy((rng.standard_normal((h + 2, w + 3)) * 300).astype(np.float32))
    for x, fn, plain, extra in (
            (ints, k6.strip53_step, k6.strip53_step_plain, ()),
            *[(flts, k6.strip97_step, k6.strip97_step_plain, (c,)) for _, c in k6.STEPS_97]):
        for inverse in (False, True):
            halo = x[-1].clone() if with_halo else None
            ref = x.clone()
            plain(ref, h, w, halo, update, *extra, inverse)
            got = x.to(cuda)
            fn(got, h, w, None if halo is None else halo.to(cuda), update, *extra, inverse)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("h,w", [(2, 1), (10, 37), (1024, 4096), (512, 2048), (256, 1024),
                                 (128, 512), (64, 256), (8192, 8)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("col0", [0, 1])
def test_strip_pack_kernels_equal_plain(cuda, h, w, dtype, col0):
    """K-v at every level of slice_strip's shard (1024x4096 down to 64x256),
    at widths that leave a ragged band, on a sub-block of a shard whose rows
    are longer than w, a multiple of 4 samples (16-byte copies) or, with
    col0 1, from a base that is not 16-byte aligned (4-byte copies); 8192
    rows take the two-pass form. The form launched is pack_form's."""
    from grok_tpu_torch import kernels
    from grok_tpu_torch.parallel import ops as k6

    rng = np.random.default_rng(h + w)
    ld = -(-w // 4) * 4 + 4
    x = torch.from_numpy((rng.standard_normal((h + 3, ld)) * 1e4).astype(np.float32))
    x = (x.to(torch.int32) if dtype == torch.int32 else x)[:, col0:]
    form = k6.pack_form(h, w).form
    for fn, plain in ((k6.strip_pack_v, k6.strip_pack_v_plain),
                      (k6.strip_unpack_v, k6.strip_unpack_v_plain)):
        ref = x.clone()
        plain(ref, h, w)
        got = torch.empty((h + 3, ld), dtype=dtype, device=cuda)[:, col0:]
        got.copy_(x)
        before = kernels.KERNELS[fn.__name__].forms.get(form, 0)
        fn(got, h, w)
        torch.cuda.synchronize()
        assert kernels.KERNELS[fn.__name__].forms[form] == before + 1
        assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("h,w,px", [(1, 1, 0), (3, 9, 1), (64, 128, 0), (512, 4096, 0),
                                    (2, 65536, 0), (2, 65536, 1)])
def test_horizontal_halves_equal_plain(cuda, h, w, px):
    """Each horizontal half on one plane through its wrapper (the form
    h_form picks, counted), the 5/3 halves on 16-bit samples and on
    samples within 8 of +-2^31 (every sum of two neighbours wraps); on four
    planes of the card at once (one launch of each half); and in the other
    form through launch_h: the "scratch" form
    at the same width, or, past MAX_LINE, the "smem" form on the first
    MAX_LINE samples of each line."""
    rng = np.random.default_rng(h * 7 + w)
    ints = torch.from_numpy(rng.integers(-(1 << 16), 1 << 16, (h + 1, w + 3)).astype(np.int32))
    odd = (np.arange(h + 1)[:, None] + np.arange(w + 3)[None, :]) & 1
    near = rng.integers(0, 8, (h + 1, w + 3))
    wide = torch.from_numpy(np.where(odd, -(1 << 31) + near, (1 << 31) - 1 - near)
                            .astype(np.int32))
    flts = torch.from_numpy((rng.standard_normal((h + 1, w + 3)) * 300).astype(np.float32))
    for xs, fn, plain in (((ints, wide), tr.dwt53_fwd_h, tr.dwt53_fwd_h_plain),
                          ((ints, wide), tr.dwt53_inv_h, tr.dwt53_inv_h_plain),
                          ((flts,), tr.dwt97_fwd_h, tr.dwt97_fwd_h_plain),
                          ((flts,), tr.dwt97_inv_h, tr.dwt97_inv_h_plain)):
        k = kernels.KERNELS[fn.__name__]
        form = tr.h_form(fn.__name__, w, h, tr.sm_count(cuda))
        other, w_other = (("scratch", w) if form == "smem" else ("smem", tr.MAX_LINE))
        for x in xs:
            group = [x.roll(i, 1) for i in range(4)]
            refs = [g.clone() for g in group]
            for r in refs:
                plain(r, h, w, px)
            got = [g.to(cuda) for g in group]
            before, before_form = k.launches, k.forms.get(form, 0)
            fn(got[0], h, w, px)
            torch.cuda.synchronize()
            assert (k.launches, k.forms[form]) == (before + 1, before_form + 1)
            assert torch.equal(got[0].cpu().view(torch.int32), refs[0].view(torch.int32))
            got = [g.to(cuda) for g in group]
            fn(got, h, w, px)
            torch.cuda.synchronize()
            assert k.launches == before + 2
            for g, r in zip(got, refs):
                assert torch.equal(g.cpu().view(torch.int32), r.view(torch.int32))
            ref = x.clone()
            plain(ref, h, w_other, px)
            got = x.to(cuda)
            tr.launch_h(fn.__name__, [got], h, w_other, px, other)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))


def _rows_after_occupancy_query(cuda, names, x):
    """Each half's occupancy query (which chip_smoke.py makes) leaves every
    later launch of the "smem" form possible: at 4,096 and 2,048 columns,
    and at 16,384 and 51,200 (a row past 48 KB of shared memory), each
    equal to the plain version on the bits."""
    import ctypes

    for name in names:
        query = getattr(kernels.library(kernels.KERNELS[name].source), f"{name}_occupancy")
        query.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4
        outs = [ctypes.c_int(0) for _ in range(4)]
        assert query(64, 4096, *(ctypes.byref(v) for v in outs)) == 0
        assert outs[1].value == 1 and outs[3].value >= 4  # a row a block, 4+ blocks an SM
        for w in (4096, 2048, 16384, tr.MAX_LINE):
            ref = x.clone()
            getattr(tr, f"{name}_plain")(ref, 64, w, 0)
            got = x.to(cuda)
            tr.launch_h(name, [got], 64, w, 0, "smem")
            torch.cuda.synchronize()
            assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))


def test_strip53_rows_after_occupancy_query(cuda):
    """The 5/3 halves after their occupancy queries (_rows_after_occupancy_query)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-(1 << 16), 1 << 16, (64, tr.MAX_LINE)).astype(np.int32))
    _rows_after_occupancy_query(cuda, ("dwt53_fwd_h", "dwt53_inv_h"), x)


def test_strip97_rows_after_occupancy_query(cuda):
    """The 9/7 halves after their occupancy queries (_rows_after_occupancy_query)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy((rng.standard_normal((64, tr.MAX_LINE)) * 300).astype(np.float32))
    _rows_after_occupancy_query(cuda, ("dwt97_fwd_h", "dwt97_inv_h"), x)


@pytest.mark.parametrize("irreversible", [False, True])
def test_long_line_strip_equals_unsharded(cuda, irreversible):
    """A 128 x 65,536 plane of DC-shifted 8-bit samples (slice_strip's
    range) through make_sharded_strip_dwt on a virtual 4-shard mesh of the
    card, 3 levels: level 0's lines take the horizontal halves' "scratch"
    form, the coarser levels' the form h_form picks for their launch (a
    launch a level of each half for the card's four shards). The bridged
    forward equals
    K-b or K-k unsharded on the bits, the inverse the unsharded inverse of
    that on the bits and the input (5/3 exactly, 9/7 within slice_strip's
    1e-3)."""
    from grok_tpu_torch.parallel import mesh as pm

    H, W, LV = 128, 65536, 3
    x = np.random.default_rng(11).integers(-128, 128, (H, W))
    x = x.astype(np.float32 if irreversible else np.int32)
    fwd, inv = gt.make_sharded_strip_dwt(gt.make_mesh(4, device=cuda), LV, irreversible)
    gt.reset_launch_counts()
    shards = fwd(x)
    torch.cuda.synchronize()
    fwd_level = tr.dwt97_fwd_level if irreversible else tr.dwt53_fwd_level
    ref = torch.from_numpy(x).to(cuda)
    for lvl in range(LV):
        fwd_level(ref, H >> lvl, W >> lvl, 0, 0)
    bridged = pm.strip_to_mallat(pm.join_rows(shards), 4, LV)
    assert torch.equal(bridged.view(torch.int32), ref.view(torch.int32))
    back = pm.join_rows(inv(shards)).cpu()
    inv_level = tr.dwt97_inv_level if irreversible else tr.dwt53_inv_level
    for lvl in range(LV, 0, -1):
        inv_level(ref, H >> (lvl - 1), W >> (lvl - 1), 0, 0)
    assert torch.equal(back.view(torch.int32), ref.cpu().view(torch.int32))
    err = float((back.double() - torch.from_numpy(x).double()).abs().max())
    assert err < 1e-3 if irreversible else err == 0
    forms = kernels.form_counts()
    for half in (("dwt97_fwd_h", "dwt97_inv_h") if irreversible
                 else ("dwt53_fwd_h", "dwt53_inv_h")):
        want = {}  # a launch a level for the card's four shards
        for lvl in range(LV):
            lines = tr.h_lines([None] * 4, (H // 4) >> lvl)
            form = tr.h_form(half, W >> lvl, lines, tr.sm_count(cuda))
            want[form] = want.get(form, 0) + 1
        assert want["scratch"] >= 1
        assert {f: c for f, c in forms[half].items() if c} == want


@pytest.mark.parametrize("shape", [(1, 1, 64, 64), (3, 3, 128, 192), (8, 3, 1024, 960)])
def test_blk_stats_kernel_equals_plain(cuda, shape):
    from grok_tpu_torch.parallel import ops as k6

    rng = np.random.default_rng(shape[0])
    x = torch.from_numpy(rng.integers(-(1 << 12), 1 << 12, shape).astype(np.int32))
    x.view(-1)[0] = -(1 << 12)
    ref_max, ref_sum = k6.blk_stats_plain(x)
    got_max, got_sum = k6.blk_stats(x.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got_max.cpu(), ref_max)
    assert got_sum.dtype == torch.float64 and got_sum.item() == ref_sum.item()


@pytest.mark.parametrize("irreversible", [False, True])
def test_strip_dwt_on_card_equals_plain_mesh(cuda, irreversible):
    """The strip wavelet on a virtual 4-shard mesh of the card, forward and
    inverse, against the same on a CPU mesh of the plain versions; the
    bridged forward equals the unsharded K-b or K-k output, and the inverse
    the unsharded K-g or K-n inverse of that, on the bits."""
    from grok_tpu_torch.parallel import mesh as pm

    H, W, LV = 512, 384, 5
    rng = np.random.default_rng(4)
    x = (rng.integers(-2048, 2048, (H, W)).astype(np.float32) if irreversible
         else rng.integers(-2048, 2048, (H, W)).astype(np.int32))
    out = []
    for mesh in (gt.make_mesh(4, device=cuda), gt.make_mesh(4, device="cpu")):
        fwd, inv = gt.make_sharded_strip_dwt(mesh, LV, irreversible)
        shards = fwd(x)
        out.append((pm.join_rows(shards).cpu(), pm.join_rows(inv(shards)).cpu()))
    assert torch.equal(out[0][0].view(torch.int32), out[1][0].view(torch.int32))
    assert torch.equal(out[0][1].view(torch.int32), out[1][1].view(torch.int32))
    fwd_level, inv_level = ((tr.dwt97_fwd_level, tr.dwt97_inv_level) if irreversible
                            else (tr.dwt53_fwd_level, tr.dwt53_inv_level))
    ref = torch.from_numpy(x).to(cuda)
    for lvl in range(LV):
        fwd_level(ref, H >> lvl, W >> lvl, 0, 0)
    bridged = pm.strip_to_mallat(out[0][0].to(cuda), 4, LV)
    assert torch.equal(bridged.view(torch.int32), ref.view(torch.int32))
    for lvl in range(LV, 0, -1):
        inv_level(ref, H >> (lvl - 1), W >> (lvl - 1), 0, 0)
    assert torch.equal(out[0][1].view(torch.int32), ref.cpu().view(torch.int32))
    if not irreversible:
        assert torch.equal(out[0][1], torch.from_numpy(x))


@pytest.mark.parametrize("kw", [
    dict(num_resolutions=3, tile_size=(64, 64)),
    dict(num_resolutions=3, tile_size=(37, 37), ht=True),
    dict(num_resolutions=3, tile_size=(64, 64), irreversible=True),
])
def test_distributed_on_card_equals_compress(cuda, kw):
    """compress_distributed, decompress_distributed and compress_frames on a
    virtual 4-shard mesh of the card: compress's streams and decompress's
    planes."""
    mesh = gt.make_mesh(4, device=cuda)
    arrs = [np.random.default_rng(s).integers(0, 256, (150, 170, 3)).astype(np.int32)
            for s in range(3)]
    one = gt.compress(gt.Image.from_array(arrs[0]), gt.CompressParams(**kw))
    gt.reset_launch_counts()
    assert gt.compress_distributed(gt.Image.from_array(arrs[0]), gt.CompressParams(**kw),
                                   mesh=mesh) == one
    dec = gt.decompress_distributed(one, mesh=mesh)
    ref = gt.decompress(one)
    assert all(np.array_equal(a.data, b.data) for a, b in zip(dec.components, ref.components))
    frames = gt.compress_frames([gt.Image.from_array(a) for a in arrs],
                                gt.CompressParams(**dict(kw, tile_size=None)), mesh=mesh)
    for a, f in zip(arrs, frames):
        assert f == gt.compress(gt.Image.from_array(a),
                                gt.CompressParams(**dict(kw, tile_size=None)))
