"""grok_tpu_torch's HT cleanup coder (t1/ht_cuda.py, the plain versions of
K-e ``ht_cleanup_enc`` and K-f ``ht_cleanup_dec`` on the CPU) against
grok_tpu's scalar oracle t1/ht.py and its batch coders ht_jax (on the CPU).
Segments are bytes and coefficients integers: every comparison is exact.

The batch decoder ht_jax_dec.decode_cleanup_batch takes about 40 s to
compile on a CPU for 16x16 codeblocks and above, so it is compared on
4x4 codeblocks only; tests/test_ht_device.py holds it equal to
ht.decode_cleanup on the larger kinds of cases, and the tests below hold
the port to that oracle."""

import numpy as np
import pytest
import torch

from grok_tpu.t1 import ht, ht_jax, ht_jax_dec, native
from grok_tpu_torch.t1 import ht as port_ht
from grok_tpu_torch.t1 import ht_cuda

CPU = torch.device("cpu")


def _blocks(rng, n, bh, bw, mag, density=0.5):
    c = rng.integers(0, mag + 1, size=(n, bh, bw)) * (rng.random((n, bh, bw)) < density)
    return np.where(rng.random((n, bh, bw)) < 0.5, -c, c).astype(np.int64)


def _case(name):
    """(coeffs [n, bh, bw] int64, heights, widths) in the spirit of
    tests/test_ht_device.py."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ragged":
        n, bh, bw = 20, 64, 64
        c = _blocks(rng, n, bh, bw, 500, 0.7)
        h = rng.integers(1, bh + 1, size=n)
        w = rng.integers(1, bw + 1, size=n)
        h[:5], w[:5] = (1, 64, 1, 63, 3), (1, 1, 64, 63, 5)
        for i in range(n):
            c[i, h[i]:] = 0
            c[i, :, w[i]:] = 0
        return c, h, w
    if name == "stuffing":  # dense near-all-ones content: 0xFF and >0x8F events
        c = np.full((6, 64, 64), -((1 << 20) - 1), dtype=np.int64)
        c[1] = (1 << 15) - 1
        c[2] = rng.choice([-((1 << 12) - 1), (1 << 12) - 1], size=(64, 64))
        c[3, ::2] = 0
        c[4, :, ::3] = 0
        return c, np.full(6, 64), np.full(6, 64)
    if name == "wide":  # the widest magnitudes the encoder takes
        c = _blocks(rng, 4, 32, 32, (1 << 23) - 1, 0.3)
        return c, np.full(4, 32), np.full(4, 32)
    bh, bw = map(int, name.split("x"))
    c = _blocks(rng, 8, bh, bw, 200)
    c[2] = 0  # an all-zero codeblock has an empty segment
    return c, np.full(8, bh), np.full(8, bw)


CASES = ["64x64", "32x32", "16x16", "4x4", "8x32", "ragged", "stuffing", "wide"]


def _tensors(c, h, w):
    return (torch.from_numpy(c.astype(np.int32)), torch.from_numpy(h.astype(np.int32)),
            torch.from_numpy(w.astype(np.int32)))


def _encode(c, h, w):
    res = ht_cuda.encode_cblks(*_tensors(c, h, w))
    return res, [bytes(res.data[i, :int(res.lengths[i])].numpy()) for i in range(len(c))]


@pytest.mark.parametrize("name", CASES)
def test_plain_encode_equals_reference(name):
    c, h, w = _case(name)
    res, segs = _encode(c, h, w)
    for i in range(len(c)):
        blk = c[i, :h[i], :w[i]]
        want = ht.encode_cleanup(c[i], int(h[i]), int(w[i])) if np.abs(blk).max() else b""
        assert segs[i] == want, f"block {i}"
    # past each segment the buffer is zero; the result fields follow ht.encode_cblks
    lens = res.lengths.numpy()
    assert not res.data.numpy()[np.arange(res.data.shape[1]) >= lens[:, None]].any()
    ref = ht.encode_cblks(c, h, w, np.zeros(len(c)), device=False)
    np.testing.assert_array_equal(lens, ref.lengths)
    np.testing.assert_array_equal(res.numbps.numpy(), ref.numbps)
    np.testing.assert_array_equal(res.npasses.numpy(), ref.npasses)
    np.testing.assert_array_equal(res.pass_rates.numpy(), ref.pass_rates)
    # each codeblock's energy, what PCRD reads, summed as the reference's coder sums it
    np.testing.assert_array_equal(res.pass_dist.numpy(), ref.pass_dist)


def test_encode_cblks_equals_ht_jax_batch():
    """A batch of 8 codeblocks of 16x16 against the reference's device coder
    (XLA on the CPU): segments and every result field."""
    c, h, w = _case("16x16")
    res, segs = _encode(c, h, w)
    assert segs == ht_jax.encode_cleanup_batch(c.astype(np.int32), h, w)
    ref = ht_jax.encode_cblks(c, h, w, np.zeros(len(c)))
    for field in ("lengths", "numbps", "npasses", "pass_rates"):
        np.testing.assert_array_equal(getattr(res, field).numpy(), getattr(ref, field))


def test_encode_overflowing_its_capacity_raises():
    """A capacity sized for 1-bit MagSgn fields cannot hold wider ones."""
    c, h, w = _case("stuffing")
    with pytest.raises(RuntimeError, match="overflow"):
        ht_cuda.ht_cleanup_enc(*_tensors(c, h, w), ht_cuda.ht_tables(CPU), mmax=1)


def test_encode_refuses_magnitudes_past_its_limit():
    """The encoder's limit is the int32 range: magnitudes from 2^24 (where
    it once refused) up to INT32_MIN's 2^31 are coded as the reference's
    default coder (native/ht_coder.cpp) codes them, energies included."""
    c = np.zeros((3, 8, 8), dtype=np.int64)
    c[1, 3, 3] = -(1 << 24)
    c[2, :4] = np.array([1 << 24, (1 << 30) - 1, 1 << 30, (1 << 31) - 1, -(1 << 31), -5, 0, 7])
    h = w = np.full(3, 8)
    res, segs = _encode(c, h, w)
    ref = native.ht_encode_cblks(c.astype(np.int32), h, w, np.zeros(3))
    assert segs == [bytes(ref.data[i, :ref.lengths[i]]) for i in range(3)]
    np.testing.assert_array_equal(res.pass_dist.numpy()[:, 0], ref.pass_dist.reshape(-1))


def _segments(c, h, w):
    segs = [ht.encode_cleanup(c[i], int(h[i]), int(w[i]))
            if np.abs(c[i, :h[i], :w[i]]).max() else b"" for i in range(len(c))]
    data = np.zeros((len(segs), max(max(map(len, segs)), 2)), dtype=np.uint8)
    for i, s in enumerate(segs):
        data[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
    return segs, data, np.array([len(s) for s in segs])


def _oracle(data, lens, h, w, bh, bw):
    """grok_tpu's default HT block decoder (native/ht_coder.cpp through
    t1/native.ht_decode_cblks), corrupt segments included: where it stops
    early it keeps what it wrote."""
    n = len(lens)
    one = np.ones(n, dtype=np.int64)
    out, _ = native.ht_decode_cblks(np.ascontiguousarray(data), np.asarray(lens, np.int64),
                                    one, one, np.asarray(h), np.asarray(w),
                                    np.zeros(n, np.int64), bh, bw)
    return out.astype(np.int64)


def _decode(data, lens, h, w, bh, bw):
    """The plain K-f against the oracle, codeblock by codeblock, then
    decode_cleanup_batch: the same coefficients. Returns (coefficients,
    stopped)."""
    t = [torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)) for a in (lens, h, w)]
    out, stopped = ht_cuda.ht_cleanup_dec(torch.from_numpy(data), *t,
                                          ht_cuda.ht_tables(CPU), bh, bw)
    np.testing.assert_array_equal(out.numpy(), _oracle(data, lens, h, w, bh, bw))
    args = (torch.from_numpy(data), torch.from_numpy(lens), torch.from_numpy(h),
            torch.from_numpy(w), bh, bw)
    np.testing.assert_array_equal(ht_cuda.decode_cleanup_batch(*args).numpy(), out.numpy())
    return out.numpy(), stopped.numpy()


@pytest.mark.parametrize("name", CASES)
def test_plain_decode_equals_reference(name):
    c, h, w = _case(name)
    _, data, lens = _segments(c, h, w)
    bh, bw = c.shape[1:]
    out, wide = _decode(data, lens, h, w, bh, bw)
    np.testing.assert_array_equal(out, c)
    assert not wide.any()


def test_decode_refuses_magsgn_fields_past_its_limit():
    """MagSgn fields of 31 and 32 bits decode as grok_tpu's default decoder
    decodes them, wrapped to int32 past its range; none stops the decode
    (only a field over 32 bits would)."""
    c = np.zeros((4, 32, 32), dtype=np.int64)
    c[0, :4, :4] = (1 << 29) + 12345
    c[1, 2, 2] = -(1 << 30)
    c[2] = 77
    c[3, 5, 5] = (1 << 31) + 5  # a 32-bit field: wraps to a negative int32
    h = w = np.full(4, 32)
    _, data, lens = _segments(c, h, w)
    out, stopped = _decode(data, lens, h, w, 32, 32)
    assert not stopped.any()
    np.testing.assert_array_equal(out, c.astype(np.int32))
    assert out[3, 5, 5] == -2147483643


@pytest.mark.parametrize("seed", [109, 7])
def test_decode_garbage_segments_equal_reference(seed):
    """Random bytes (tests/test_ht_device.py's case at seed 109): the result
    equals the oracle's, where a decode stops early too."""
    rng = np.random.default_rng(seed)
    n, L = 16, 400
    data = rng.integers(0, 256, size=(n, L), dtype=np.uint8)
    lens = rng.integers(2, L + 1, size=n).astype(np.int64)
    h = w = np.full(n, 32)
    _decode(data, lens, h, w, 32, 32)


def test_decode_reads_past_a_chunk_as_the_oracle():
    """A segment whose MagSgn chunk lost half its bytes reads past it: the
    kernel's pads (0xFF) give what the oracle gives."""
    c, h, w = _case("32x32")
    segs, _, _ = _segments(c, h, w)
    seg = segs[0]
    ms_len = len(seg) - ((seg[-1] << 4) | (seg[-2] & 0xF))
    cut = seg[:ms_len // 2] + seg[ms_len:]
    data = np.zeros((2, len(seg)), dtype=np.uint8)
    data[0, :len(cut)] = np.frombuffer(cut, dtype=np.uint8)
    data[1] = np.frombuffer(seg, dtype=np.uint8)
    out, _ = _decode(data, np.array([len(cut), len(seg)]), h[:2], w[:2], 32, 32)
    np.testing.assert_array_equal(out[1], c[0])
    assert not np.array_equal(out[0], c[0])


@pytest.mark.parametrize("kind", ["valid", "garbage"])
def test_decode_equals_ht_jax_dec_batch(kind, monkeypatch):
    """Against ht_jax_dec.decode_cleanup_batch itself (XLA on the CPU), on
    4x4 codeblocks: its program for 16x16 and above takes about 40 s to
    compile on a CPU, this one about 9 s (with the reference's own tight
    capacities, GROK_TPU_HT_DEC_TIGHT_CAPS), shared by both cases."""
    monkeypatch.setenv("GROK_TPU_HT_DEC_TIGHT_CAPS", "1")
    if kind == "valid":
        c, h, w = _case("4x4")
        _, data, lens = _segments(c, h, w)
    else:
        rng = np.random.default_rng(109)
        data = rng.integers(0, 256, size=(16, 64), dtype=np.uint8)
        lens = rng.integers(2, 65, size=16).astype(np.int64)
        h = w = np.full(16, 4)
    ref = ht_jax_dec.decode_cleanup_batch(data, lens, h, w, 4, 4)
    out, stopped = _decode(data, lens, h, w, 4, 4)
    # the port decodes corrupt segments as grok_tpu's default (native)
    # decoder does; ht_jax_dec agrees with it wherever the decode runs to
    # its end and the VLC stream's first nibble has no stray high bit
    # (the native decoder, and the port, drop that bit; ht_jax_dec keeps it)
    nib = np.array([data[i, lens[i] - 2] >> 4 for i in range(len(lens))])
    same = ~stopped & (((nib & 7) != 7) | (nib == 7))
    np.testing.assert_array_equal(out[same], ref[same])
    if kind == "valid":
        np.testing.assert_array_equal(out, c)
        assert not stopped.any()
