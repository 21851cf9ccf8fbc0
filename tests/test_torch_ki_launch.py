"""The host side of K-i ``ebcot_decode`` (t1/ebcot_cuda.py) on the CPU:
the shared memory a launch takes for each codeblock shape, the refusal of
codeblocks over 4096 samples, the waves and the longest-first launch
order, the flat buffer the kernel gets, and the wrapper's constants
against csrc/ebcot_dec.cu. Integer arithmetic only: every comparison is
exact."""

import re

import pytest
import torch

from grok_tpu_torch import kernels
from grok_tpu_torch.t1 import ebcot_cuda as ec

SRC = (kernels.CSRC / "ebcot_dec.cu").read_text()


def _layout(h, w, warps=ec.DEC_WARPS):
    stripes = -(-h // 4)
    return ec.dec_layout(h * w, stripes * w, stripes if w <= 64 else 0, warps)


@pytest.mark.parametrize("h,w,warp_bytes,warps", [
    # contexts 80 B, the MRP chunk 144 B, two uint64 column-bit words a
    # stripe (w <= 64), the 32-bit stripe words and a byte for each (the
    # rows whose magnitudes the lanes have added)
    (64, 64, 224 + 16 * 16 + 5 * 1024, 16),
    (64, 32, 224 + 16 * 16 + 5 * 512, 16),
    (32, 32, 224 + 16 * 8 + 5 * 256, 16),
    (4, 1024, 224 + 5 * 1024, 16),  # wider than 64: no column bits
    (16, 256, 224 + 5 * 4 * 256, 16),
    (2, 2048, 224 + 5 * 2048, 16),
    (1024, 4, 224 + 16 * 256 + 5 * 1024, 16),
    (3, 8, 224 + 16 + 5 * 8, 16),
    (13, 16, 224 + 16 * 4 + 5 * 64, 16),
    (1, 4096, 224 + 5 * 4096, 11),  # 16 warps would not fit: the block shrinks
])
def test_shared_bytes_per_shape(h, w, warp_bytes, warps):
    lay = _layout(h, w)
    assert lay.warp_bytes == -(-warp_bytes // 16) * 16
    assert lay.warps == warps
    assert lay.smem == warps * lay.warp_bytes
    assert lay.smem + ec.DEC_TAB_BYTES <= ec.DEC_SMEM_LIMIT


def test_shared_bytes_follow_the_largest_codeblock():
    """A batch's layout is its largest codeblock's: the most stripe words
    and, among codeblocks of width 64 or less, the most stripes."""
    lanes = torch.tensor([[4, 2, 1024, 3], [1024, 64, 4, 8]])  # heights, widths
    stripes = (lanes[0] + 3) // 4
    words = int((stripes * lanes[1]).max())
    cols = int(torch.where(lanes[1] <= 64, stripes, 0).max())
    lay = ec.dec_layout(int((lanes[0] * lanes[1]).max()), words, cols)
    assert (words, cols) == (1024, 256)
    assert lay.warp_bytes == 224 + 16 * 256 + 5 * 1024


@pytest.mark.parametrize("warps,blocks", [(2, 14), (4, 8), (8, 4), (12, 3), (16, 2)])
def test_shared_memory_residency_of_64x64(warps, blocks):
    """Blocks of the 4K batch's codeblocks (64x64) that an SM's 228 KB of
    shared memory holds (1 KB a block reserved): 28 to 36 codeblocks an SM,
    as many as the registers allow (64 a lane: 32 an SM) for 16-warp
    blocks."""
    lay = _layout(64, 64, warps)
    assert 228 * 1024 // (lay.smem + ec.DEC_TAB_BYTES + 1024) == blocks


@pytest.mark.parametrize("n,sms,warps", [
    (6321, 132, 16), (530, 132, 4), (131, 132, 1), (1, 132, 1), (0, 132, 1),
    (1056, 132, 8), (2112, 132, 16), (4000, 132, 16)])
def test_block_warps_spread_small_batches(n, sms, warps):
    """A batch too small to fill the card spreads over every SM: blocks of
    n // sms warps, at most DEC_WARPS."""
    assert ec.dec_block_warps(n, sms) == min(warps, ec.DEC_WARPS)


def test_refuses_over_4096_samples():
    for h, w in ((65, 64), (100, 120), (1, 4097), (8192, 1)):
        with pytest.raises(ValueError, match="4096 samples"):
            _layout(h, w)
    assert _layout(64, 64).warps == ec.DEC_WARPS  # the limit itself is taken
    assert _layout(1024, 4).warps == ec.DEC_WARPS


def test_refuses_a_state_over_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        ec.dec_layout(4096, 60000, 0)


@pytest.mark.parametrize("n,warps,blocks,sms,waves", [
    (0, 8, 5, 132, 0), (1, 8, 5, 132, 1), (5280, 8, 5, 132, 1), (5281, 8, 5, 132, 2),
    (6321, 8, 5, 132, 2), (6321, 8, 6, 132, 1), (530, 8, 6, 132, 1), (100, 4, 0, 1, 25)])
def test_waves(n, warps, blocks, sms, waves):
    assert ec.dec_waves(n, warps, blocks, sms) == waves


def test_launch_order_longest_first():
    lengths = torch.tensor([5, 900, 17, 900, 0, 33, 17], dtype=torch.int32)
    assert ec.dec_order(lengths, 1) is None  # one wave: batch order
    assert ec.dec_order(lengths, 0) is None
    order = ec.dec_order(lengths, 2)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 3, 5, 2, 6, 0, 4]  # ties keep batch order
    assert lengths[order.long()].tolist() == sorted(lengths.tolist(), reverse=True)


def test_launch_order_is_a_permutation():
    g = torch.Generator().manual_seed(5)
    lengths = torch.randint(0, 3000, (6321,), generator=g, dtype=torch.int32)
    order = ec.dec_order(lengths, 2).long()
    assert torch.equal(torch.sort(order).values, torch.arange(6321))
    assert bool((lengths[order][1:] <= lengths[order][:-1]).all())


def test_flat_buffer():
    """The kernel loads the aligned 32-bit words that hold readable bytes:
    the buffer goes as it is when it is 4-aligned and a multiple of 4 bytes
    long, else as a zero-padded copy (the padding lies past every
    codeblock's bytes, which read 0xFF there)."""
    data = torch.arange(12, dtype=torch.uint8)
    assert ec.dec_flat(data) is data
    for n in (0, 1, 3, 5, 7, 9):
        flat = ec.dec_flat(torch.arange(n, dtype=torch.uint8))
        assert flat.numel() == max(-(-n // 4) * 4, 4) and flat.data_ptr() % 4 == 0
        assert flat[:n].tolist() == list(range(n)) and not flat[n:].any()
    view = torch.arange(13, dtype=torch.uint8)[1:]  # 12 bytes off a 4-byte boundary
    flat = ec.dec_flat(view)
    assert flat is not view and flat.data_ptr() % 4 == 0 and torch.equal(flat, view)


def test_constants_match_the_source():
    """DEC_CX_BYTES, DEC_MR_BYTES and DEC_TAB_BYTES are the kernel's, DEC_WARPS
    is at most its MAX_WARPS (its launch bounds); the C entry takes the
    arguments the wrapper passes."""
    define = lambda name: int(re.search(rf"#define {name} (\d+)", SRC).group(1))  # noqa: E731
    assert define("CX_BYTES") == ec.DEC_CX_BYTES
    assert define("MR_BYTES") == ec.DEC_MR_BYTES
    assert ec.DEC_WARPS <= define("MAX_WARPS")
    tabs = {m.group(2): (m.group(1), int(eval(m.group(3))))
            for m in re.finditer(r"^__shared__ (uint32_t|uint8_t|const uint8_t\*) (s_\w+)\[([^\]]+)\];",
                                 SRC, re.M)}
    size = {"uint32_t": 4, "uint8_t": 1, "const uint8_t*": 8}
    assert sum(size[t] * k for t, k in tabs.values()) == ec.DEC_TAB_BYTES
    assert set(tabs) == {"s_mq", "s_zc", "s_sc"}
    entry = re.search(r'extern "C" int ebcot_decode\(([^)]*)\)', SRC).group(1)
    assert len(entry.split(",")) == len(kernels.KERNELS["ebcot_decode"].argtypes) == 17


def test_cpu_path_takes_any_codeblock_size():
    """On the CPU the plain version decodes; the shared-memory refusal is
    the card's alone (the plain version has no such limit)."""
    tabs = ec.device_tables("cpu")
    lanes = torch.tensor([[1, 1, 80, 80, 0, 0, 0]], dtype=torch.int32).T.contiguous()
    out = ec.ebcot_decode(torch.zeros(1, dtype=torch.uint8), torch.zeros(1, dtype=torch.int64),
                          lanes, torch.zeros((1, 1), dtype=torch.int32), tabs["ctx"],
                          tabs["mq"], 80, 80)
    assert out.shape == (1, 80, 80)
