"""grok_tpu_torch's Part-1 EBCOT encoder (t1/ebcot_cuda.py) against grok_tpu.

(a) The plain symbol scan's records against the records of the Pallas
    kernel ``_build_kernel_wide`` run in interpret mode, byte for byte.
(b) ``encode_cblks`` (plain scan + plain MQ packer + plain pass
    distortions) against ``ebcot_np.encode_cblks`` and grok_tpu's default
    native coder: segment bytes, lengths, pass rates and the float64 pass
    distortions exact (PCRD compares slopes, so a last-bit difference could
    move a layer boundary; the plain sums run in the coders' scan order).
"""

import numpy as np
import pytest
import torch

from grok_tpu.t1 import ebcot_np, ebcot_pallas
from grok_tpu.t1 import native as ref_native
from grok_tpu_torch.t1 import ebcot_cuda
from grok_tpu_torch.t1.ebcot import ctx_table, lane_numbps
from grok_tpu_torch.t1.mq import mq_table


def _lanes(coeffs, heights, widths, orients, styles):
    c = torch.from_numpy(coeffs.astype(np.int32))
    nb = lane_numbps(c.abs(), torch.from_numpy(heights), torch.from_numpy(widths))
    lanes = torch.stack([nb, *(torch.from_numpy(np.asarray(a, dtype=np.int64))
                               for a in (heights, widths, orients, styles))])
    return c, lanes.to(torch.int32).contiguous(), int(nb.max())


@pytest.mark.parametrize("seed,shape,lo,heights,widths,orients,styles", [
    # every style bit (BYPASS raw passes, RESET, TERMALL, VSC, PTERM, SEGSYM)
    (12, (2, 8, 4), 200, [8, 7], [4, 4], [2, 3], [0x3F, 0x3F]),
    # VSC | SEGSYM with partial stripes and a narrower lane
    (13, (2, 12, 4), 40, [12, 10], [4, 3], [1, 0], [0x28, 0x28]),
])
def test_symbol_records_match_pallas_interpret(monkeypatch, seed, shape, lo, heights,
                                               widths, orients, styles):
    monkeypatch.setenv("GROK_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.delenv("GROK_TPU_PALLAS_PACKER", raising=False)
    captured = []

    def capture(sym_lane_major, *args, **kwargs):
        captured.append(np.array(sym_lane_major))
        return None  # the reference then packs with its numpy packer

    monkeypatch.setattr(ebcot_pallas, "_pack_symbols_nat", capture)
    coeffs = np.random.default_rng(seed).integers(-lo, lo, size=shape).astype(np.int64)
    heights, widths = np.array(heights), np.array(widths)
    orients, styles = np.array(orients), np.array(styles, dtype=np.int64)
    ebcot_pallas.encode_cblks(coeffs, heights, widths, orients, styles=styles)
    ref = captured[0]  # [n, PMAXC, 3, S_PAD], the port's layout as it is

    c, lanes, pmax = _lanes(coeffs, heights, widths, orients, styles)
    pmaxc = -(-pmax // 4) * 4
    got = ebcot_cuda.ebcot_symbols(c, lanes, ctx_table(), pmaxc)
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def _compare_encode(coeffs, heights, widths, orients, styles=None, native=False):
    if native:
        ref = ref_native.encode_cblks(coeffs, heights, widths, orients, styles=styles)
    else:
        ref = ebcot_np.encode_cblks(coeffs, heights, widths, orients, styles=styles)
    got = ebcot_cuda.encode_cblks(torch.from_numpy(coeffs.astype(np.int32)),
                                  heights, widths, orients, styles=styles)
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)
    np.testing.assert_array_equal(got.numbps.numpy(), ref.numbps)
    np.testing.assert_array_equal(got.npasses.numpy(), ref.npasses)
    for i in range(coeffs.shape[0]):
        ln = int(ref.lengths[i])
        assert bytes(got.data[i, :ln].numpy()) == bytes(ref.data[i, :ln]), f"lane {i}"
    buf, off = got.raw_data
    assert off == 1 and torch.equal(buf[:, 1:], got.data)
    np.testing.assert_array_equal(got.pass_rates.numpy(), ref.pass_rates)
    np.testing.assert_array_equal(got.pass_dist.numpy(), ref.pass_dist)


@pytest.mark.parametrize("style", [0x00, 0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x3F, 0x05])
def test_encode_cblks_matches_ebcot_np(style):
    rng = np.random.default_rng(40 + style)
    coeffs = rng.integers(-3000, 3000, size=(4, 8, 8)).astype(np.int64)
    coeffs[1] //= 50  # fewer planes than its neighbours
    coeffs[2, 5:] = 0
    coeffs[3] = rng.integers(-2, 3, size=(8, 8))
    heights = np.array([8, 6, 8, 3])
    widths = np.array([8, 8, 5, 7])
    orients = np.array([0, 1, 2, 3])
    _compare_encode(coeffs, heights, widths, orients, np.full(4, style, dtype=np.int64))


def test_encode_cblks_mixed_geometry_default_style():
    rng = np.random.default_rng(11)
    coeffs = rng.integers(-15, 15, size=(3, 8, 6)).astype(np.int64)
    coeffs[2, 4:, :] = 0
    _compare_encode(coeffs, np.array([8, 5, 8]), np.array([6, 6, 4]), np.array([0, 1, 3]))


@pytest.mark.parametrize("style", [0x00, 0x3F])
def test_plain_stages_in_record_layout_match_ebcot_np(style):
    """The three stages by hand on [n, pmaxc, 3, s_pad] records, with a
    different height and width in every lane (partial stripes included)."""
    rng = np.random.default_rng(90 + style)
    n, h, w = 5, 13, 10
    coeffs = rng.integers(-900, 900, size=(n, h, w)).astype(np.int64)
    heights = np.array([13, 9, 4, 11, 1])
    widths = np.array([10, 7, 10, 3, 9])
    orients = np.array([0, 1, 2, 3, 1])
    styles = np.full(n, style, dtype=np.int64)
    ref = ebcot_np.encode_cblks(coeffs, heights, widths, orients, styles=styles)
    c, lanes, pmax = _lanes(coeffs, heights, widths, orients, styles)
    pmaxc = -(-pmax // 4) * 4
    sym = ebcot_cuda.ebcot_symbols_plain(c, lanes, ctx_table(), pmaxc)
    assert tuple(sym.shape) == (n, pmaxc, 3, ebcot_cuda.slot_counts(4, w)[3])
    buf, lengths, rates = ebcot_cuda.mq_pack_plain(
        sym, lanes[0].contiguous(), lanes[4].contiguous(), mq_table(), h, w, pmax)
    dist = ebcot_cuda.pass_dist_from_records(sym, c, lanes[0], pmax)
    np.testing.assert_array_equal(lengths.numpy(), ref.lengths)
    for i in range(n):
        ln = int(ref.lengths[i])
        assert bytes(buf[i, 1:1 + ln].numpy()) == bytes(ref.data[i, :ln]), f"lane {i}"
    np.testing.assert_array_equal(rates.numpy(), ref.pass_rates)
    np.testing.assert_array_equal(dist.numpy(), ref.pass_dist)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        ebcot_cuda.ebcot_pass_dist(sym, c, lanes[0].contiguous(), pmax).numpy(), ref.pass_dist)


@pytest.mark.parametrize("style", [0x00, 0x01, 0x04, 0x3F])
def test_pass_dist_equals_native_coder(style):
    """The default coder of grok_tpu (native/t1_coder.cpp), which rate
    control reads: distortions equal to the last bit, every style."""
    rng = np.random.default_rng(70 + style)
    coeffs = rng.integers(-2000, 2000, size=(4, 12, 8)).astype(np.int64)
    coeffs[1] //= 30
    coeffs[2, 7:] = 0
    _compare_encode(coeffs, np.array([12, 9, 12, 5]), np.array([8, 8, 6, 7]),
                    np.array([0, 1, 2, 3]), np.full(4, style, dtype=np.int64), native=True)


@pytest.mark.parametrize("native", [False, True], ids=["ebcot_np", "native"])
def test_pass_dist_deep_planes_every_style(native):
    """Magnitudes up to 1 << 17 (18 planes, 52 passes) under every style
    bit: the decreases reach 2^36 and their sums stay exact."""
    rng = np.random.default_rng(17)
    coeffs = rng.integers(-(1 << 17), 1 << 17, size=(3, 8, 8)).astype(np.int64)
    coeffs[0, 0, 0] = -(1 << 17)
    coeffs[2] >>= 9
    _compare_encode(coeffs, np.array([8, 7, 8]), np.array([8, 8, 5]), np.array([0, 3, 1]),
                    np.full(3, 0x3F, dtype=np.int64), native=native)


def test_encode_cblks_all_zero_batch():
    coeffs = np.zeros((3, 4, 4), dtype=np.int64)
    got = ebcot_cuda.encode_cblks(torch.zeros((3, 4, 4), dtype=torch.int32),
                                  [4, 4, 2], [4, 3, 4], [0, 1, 2])
    ref = ebcot_np.encode_cblks(coeffs, np.array([4, 4, 2]), np.array([4, 3, 4]),
                                np.array([0, 1, 2]))
    assert got.lengths.tolist() == ref.lengths.tolist() == [0, 0, 0]
    assert got.npasses.tolist() == ref.npasses.tolist() == [0, 0, 0]
    np.testing.assert_array_equal(got.pass_rates.numpy(), ref.pass_rates)


def test_zero_lanes_beside_coded_lanes():
    rng = np.random.default_rng(5)
    coeffs = np.zeros((3, 8, 8), dtype=np.int64)
    coeffs[1] = rng.integers(-100, 100, size=(8, 8))
    _compare_encode(coeffs, np.array([8, 8, 8]), np.array([8, 8, 8]), np.array([3, 0, 1]),
                    np.array([0x3F, 0x3F, 0x3F], dtype=np.int64))


def test_wrappers_refuse_bad_inputs():
    c = torch.zeros((2, 4, 4), dtype=torch.int32)
    lanes = torch.zeros((5, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        ebcot_cuda.ebcot_symbols(c.to(torch.int64), lanes, ctx_table(), 4)
    with pytest.raises(ValueError):
        ebcot_cuda.ebcot_symbols(c, lanes[:4].contiguous(), ctx_table(), 4)
    with pytest.raises(ValueError):
        ebcot_cuda.ebcot_symbols(c, lanes, ctx_table(), 3)
    with pytest.raises(ValueError):  # a device that is neither CPU nor CUDA
        ebcot_cuda.ebcot_symbols(c.to("meta"), lanes.to("meta"), ctx_table().to("meta"), 4)
