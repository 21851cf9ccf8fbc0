"""HT encodes whose coefficients reach 2^24 and above (24- to 30-bit
samples) on the CPU: grok_tpu_torch's streams byte-identical to
grok_tpu's, and both decoders (grok_tpu_torch's and grok_tpu's) giving the
same samples; K-e's plain version (ht_cuda.ht_cleanup_enc_plain) byte for
byte against grok_tpu's scalar coder t1/ht.py encode_cleanup and its
default coder native/ht_coder.cpp on codeblocks with magnitudes up to
2^31, energies included.

The 5/3 cases stop at 29 bits and 28 with three components: grok_tpu's
marker writer refuses a band exponent past 31 bits (30-bit samples, or 29
with the RCT's extra chroma bit)."""

import numpy as np
import pytest
import torch

import grok_tpu as gk
import grok_tpu_torch as gt
from grok_tpu.t1 import ht, native
from grok_tpu_torch.t1 import ht_cuda


def _image(mod, arr, bits):
    return mod.Image.from_array(arr, prec=bits, signed=False)


# name: (shape, bits, irreversible, layer_rates)
CASES = {
    "53 16x16 24 bits": ((16, 16), 24, False, None),
    "53 16x16 28 bits": ((16, 16), 28, False, None),
    "53 16x16 29 bits": ((16, 16), 29, False, None),
    "53 20x18x3 24 bits": ((20, 18, 3), 24, False, None),
    "53 20x18x3 28 bits, layer_rates": ((20, 18, 3), 28, False, [4.0]),
    "97 16x16 24 bits": ((16, 16), 24, True, None),
    "97 16x16 28 bits": ((16, 16), 28, True, None),
    "97 16x16 30 bits": ((16, 16), 30, True, None),
    "97 20x18x3 24 bits": ((20, 18, 3), 24, True, None),
    "97 20x18x3 28 bits": ((20, 18, 3), 28, True, None),
    "97 20x18x3 30 bits, layer_rates": ((20, 18, 3), 30, True, [4.0]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stream_and_decodes_equal_reference(name, monkeypatch):
    shape, bits, irreversible, rates = CASES[name]
    arr = np.random.default_rng(bits + len(shape)).integers(0, 1 << bits, size=shape)
    arr = arr.astype(np.int32)
    kw = dict(num_resolutions=2, ht=True, irreversible=irreversible)
    if rates:
        kw["layer_rates"] = rates
    ref = gk.compress(_image(gk, arr, bits), gk.CompressParams(**kw))
    seen, largest = [], ht_cuda.largest_magnitude

    def spy(coeffs):  # the largest magnitude of each codeblock batch encoded
        seen.append(largest(coeffs))
        return seen[-1]
    monkeypatch.setattr(ht_cuda, "largest_magnitude", spy)
    got = gt.compress(_image(gt, arr, bits), gt.CompressParams(**kw), device="cpu")
    assert got == ref
    # 9/7 at 24 bits stays just below 2^24 (its steps grow with the depth)
    assert (max(seen) >= 1 << 24) == (bits > 24 or not irreversible)
    want = gk.decompress(ref)
    back = gt.decompress(ref, device="cpu")
    planes = [arr] if arr.ndim == 2 else [arr[:, :, c] for c in range(arr.shape[2])]
    for c, (a, b) in enumerate(zip(back.components, want.components)):
        np.testing.assert_array_equal(a.data, b.data)
        if not irreversible and not rates:
            np.testing.assert_array_equal(a.data, planes[c])


def _wide_blocks():
    """Codeblocks holding 2^24, 2^30 - 1, 2^30, 2^31 - 1 and INT32_MIN, with
    their negatives, beside log-uniform magnitudes from 2^24 and small ones."""
    rng = np.random.default_rng(31)
    n, bh, bw = 6, 16, 16
    mag = np.minimum(np.exp2(rng.uniform(24, 31, size=(n, bh, bw))), (1 << 31) - 1)
    c = np.where(rng.random((n, bh, bw)) < 0.5, -1, 1) * mag.astype(np.int64)
    c *= rng.random((n, bh, bw)) < 0.7
    for i, v in enumerate((1 << 24, (1 << 30) - 1, 1 << 30, (1 << 31) - 1)):
        c[i, rng.integers(0, bh), rng.integers(0, bw)] = v
        c[i, rng.integers(0, bh), rng.integers(0, bw)] = -v
    c[4, ::2, ::2] = rng.integers(-3, 4, size=(bh // 2, bw // 2))
    c[5, 7, 9] = -(1 << 31)
    return c.astype(np.int32), np.full(n, bh, dtype=np.int32), np.full(n, bw, dtype=np.int32)


def test_plain_encoder_equals_reference_coders():
    c, h, w = _wide_blocks()
    res = ht_cuda.encode_cblks(*(torch.from_numpy(a) for a in (c, h, w)))
    segs = [bytes(res.data[i, :int(res.lengths[i])].numpy()) for i in range(len(c))]
    # the scalar coder takes the int64 coefficients its batch API hands it
    assert segs == [ht.encode_cleanup(c[i].astype(np.int64), 16, 16) for i in range(len(c))]
    nat = native.ht_encode_cblks(c, h, w, np.zeros(len(c)))
    assert segs == [bytes(nat.data[i, :nat.lengths[i]]) for i in range(len(c))]
    # each codeblock's energy, what PCRD reads, as the default coder sums it
    np.testing.assert_array_equal(res.pass_dist.numpy()[:, 0], nat.pass_dist.reshape(-1))
