"""Quality layers and PCRD rate control of grok_tpu_torch against grok_tpu.

(a) The pieces: K-e's plain block energy against the reference's native HT
    coder, the hull slopes (K-q's plain version) against
    ``grok_tpu.t2.rate_control.hull_effective_slopes`` with its native ops
    on and off, on integer data full of ties, and ``allocate_layers`` in
    all three branches; all compared exactly.
(b) The slice: ``compress(..., device="cpu")`` with layers and rate or
    quality targets byte-identical to ``grok_tpu.compress``, and
    ``decompress`` with ``max_layers`` 0 and 1 sample-identical to
    ``grok_tpu.decompress``, over one parametrised list of configurations.
(c) The parameter checks grok_tpu makes on layer targets.
"""

import numpy as np
import pytest
import torch

import grok_tpu as gk
import grok_tpu_torch as gt
from grok_tpu.t1 import native as ref_native
from grok_tpu.t2 import rate_control as ref_rc
from grok_tpu_torch.t1 import ht_cuda
from grok_tpu_torch.t2 import rate_control as rc


# ------------------------------------------------------------ (a) pieces
def test_plain_block_energy_equals_native_ht_coder():
    """Row sums first, then the rows, each in order: at magnitudes near
    2^23 the partial sums round, so another order would differ."""
    rng = np.random.default_rng(3)
    n, bh, bw = 12, 16, 64
    c = rng.integers(-(1 << 23), 1 << 23, size=(n, bh, bw)).astype(np.int32)
    c[3] //= 1000
    c[5] = 0
    heights = np.array([16, 16, 9, 16, 1, 16, 16, 3, 16, 12, 16, 16])
    widths = np.array([64, 33, 64, 64, 64, 64, 1, 64, 7, 64, 64, 64])
    c[1, :, 40:] = 77  # outside its codeblock: the energy leaves it out
    ref = ref_native.ht_encode_cblks(c, heights, widths, np.zeros(n, dtype=np.int64))
    got = ht_cuda.block_energy_plain(torch.from_numpy(c), torch.from_numpy(heights),
                                     torch.from_numpy(widths))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref.pass_dist[:, 0])
    res = ht_cuda.encode_cblks(torch.from_numpy(c), heights, widths)
    np.testing.assert_array_equal(res.pass_dist.numpy(), ref.pass_dist)
    assert ht_cuda.encode_cblks(torch.from_numpy(c), heights, widths,
                                want_dist=False).pass_dist is None


def _tie_laden(seed, n=40, p=13):
    """Integer rates with zero-length steps and integer distortions with
    zeros and repeats: equal slopes, passes adding nothing, and rows with
    no passes."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(0, 4, size=(n, p))
    steps[rng.random((n, p)) < 0.3] = 0
    rates = np.cumsum(steps, axis=1).astype(np.int64)
    dists = rng.integers(0, 5, size=(n, p)).astype(np.float64) * 4.0
    dists[rng.random((n, p)) < 0.25] = 0.0
    npasses = rng.integers(0, p + 1, size=n).astype(np.int64)
    npasses[:4] = 0
    npasses[4:8] = p
    return rates, dists, npasses


@pytest.mark.parametrize("native_ops", ["1", "0"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_hull_slopes_equal_reference(monkeypatch, native_ops, seed):
    monkeypatch.setenv("GROK_TPU_NATIVE_OPS", native_ops)
    rates, dists, npasses = _tie_laden(seed)
    if seed == 3:  # real-valued distortions too
        dists = dists * np.random.default_rng(9).random(dists.shape)
    ref = ref_rc.hull_effective_slopes(rates, dists, npasses)
    got = rc.hull_effective_slopes(rates, dists, npasses)
    np.testing.assert_array_equal(got, ref)
    assert (got[:4] == 0).all()
    t = rc.hull_slopes(torch.from_numpy(rates), torch.from_numpy(dists),
                       torch.from_numpy(npasses.astype(np.int32)))
    assert t.dtype == torch.float64
    np.testing.assert_array_equal(t.numpy(), ref)


def test_hull_slopes_refuse_bad_inputs():
    r, d, k = (torch.zeros((2, 3), dtype=torch.int64), torch.zeros((2, 3), dtype=torch.float64),
               torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        rc.hull_slopes(r.to(torch.int32), d, k)
    with pytest.raises(ValueError):
        rc.hull_slopes(r, d[:, :2].contiguous(), k)
    with pytest.raises(ValueError):
        rc.hull_slopes(r, d, k.to(torch.int64))


def _fake_exact(rates):
    """A deterministic stand-in for the packet simulation: the body bytes
    plus a header charge per layer and per included codeblock."""
    def fn(rows):
        k = rows[-1]
        body = np.where(k > 0, np.take_along_axis(rates, np.maximum(k - 1, 0)[:, None],
                                                  axis=1)[:, 0], 0).sum()
        return int(body) + 7 * len(rows) + 3 * int(sum((r > 0).sum() for r in rows))
    return fn


@pytest.mark.parametrize("branch", ["exact", "heuristic", "psnr", "none"])
def test_allocate_layers_equals_reference(branch):
    rng = np.random.default_rng(21)
    n, p = 60, 16
    rates = np.cumsum(rng.integers(0, 40, size=(n, p)), axis=1).astype(np.int64)
    dists = np.sort(rng.random((n, p)) * 1e4, axis=1)[:, ::-1].copy()
    npasses = rng.integers(0, p + 1, size=n).astype(np.int64)
    total = float(np.take_along_axis(rates, np.maximum(npasses - 1, 0)[:, None],
                                     axis=1)[:, 0].sum())
    kw = {}
    targets = [total / 8, total / 3, None]
    if branch == "exact":
        kw["exact_rate_fn"] = _fake_exact(rates)
    elif branch == "heuristic":
        kw["header_overhead_fn"] = lambda cum: 11.0 + 4.0 * int((cum > 0).sum())
    elif branch == "psnr":
        targets = [None, None, None]
        kw["dist_targets"] = [float(dists.sum()) * 0.3, float(dists.sum()) * 0.05, None]
    else:
        targets = [None, None]
    lam_ref, lam_got = [], []
    ref = ref_rc.allocate_layers(rates, dists, npasses, targets, lam_out=lam_ref, **kw)
    slopes = rc.hull_slopes(*(torch.from_numpy(a) for a in (
        rates, dists, npasses.astype(np.int32)))).numpy()
    got = rc.allocate_layers(rates, dists, npasses, targets, lam_out=lam_got, slopes=slopes,
                             **kw)
    np.testing.assert_array_equal(got, ref)
    assert lam_got == lam_ref


# ------------------------------------------------------------- (b) slice
def _image(h, w, nc, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    planes = [np.clip(base + rng.normal(0, 10 + 5 * c, (h, w)), 0, 255) for c in range(nc)]
    return np.stack(planes, -1).astype(np.int32) if nc > 1 else planes[0].astype(np.int32)


SMALL = dict(num_resolutions=3, cblk_width=16, cblk_height=16)
CASES = {
    "53_rates1": dict(layer_rates=[8]),
    "53_rates2": dict(num_layers=2, layer_rates=[16, 1]),
    "53_rates3": dict(num_layers=3, layer_rates=[40, 20, 10]),
    "97_rates1": dict(irreversible=True, layer_rates=[10]),
    "97_rates2": dict(irreversible=True, num_layers=2, layer_rates=[20, 8]),
    "97_rates3": dict(irreversible=True, num_layers=3, layer_rates=[32, 16, 8]),
    "97_psnrs": dict(irreversible=True, num_layers=2, layer_psnrs=[30, 40]),
    "53_psnrs": dict(num_layers=2, layer_psnrs=[36, 0]),
    "3_layers_no_targets": dict(num_layers=3),
    "ht_97_rates": dict(ht=True, irreversible=True, num_layers=2, layer_rates=[20, 1]),
    "ht_53_rates": dict(ht=True, num_layers=2, layer_rates=[12, 4]),
    "ht_psnrs": dict(ht=True, irreversible=True, num_layers=2, layer_psnrs=[28, 36]),
    # a layer without a target (ratio 0) between two with one
    "rates_with_gap": dict(irreversible=True, num_layers=3, layer_rates=[30, 0, 10]),
    # 12-bit samples: deeper planes, larger decreases
    "gray12_rates": dict(num_layers=2, layer_rates=[20, 6], nc=1, prec=12),
    "rc_algorithm_1": dict(irreversible=True, num_layers=3, layer_rates=[32, 16, 8],
                           rc_algorithm=1),
    "tiles_2x2": dict(irreversible=True, num_layers=2, layer_rates=[16, 8],
                      tile_size=(24, 24)),
    "rlcp": dict(num_layers=2, layer_rates=[16, 4], progression=gt.ProgressionOrder.RLCP),
    "rpcl": dict(irreversible=True, num_layers=3, layer_rates=[30, 15, 6],
                 progression=gt.ProgressionOrder.RPCL),
    "one_comp": dict(irreversible=True, num_layers=2, layer_rates=[10, 4], nc=1),
    "four_comps": dict(num_layers=2, layer_rates=[16, 8], nc=4),
    "mct_0": dict(irreversible=True, num_layers=2, layer_rates=[16, 8], mct=0),
    "style_0x01": dict(num_layers=3, layer_rates=[24, 12, 6], cblk_style=0x01),
    "style_0x3f": dict(irreversible=True, num_layers=3, layer_rates=[24, 12, 6],
                       cblk_style=0x3F),
    # bench.py's lossy97_1bpp row at a small size
    "lossy97_1bpp": dict(num_resolutions=6, irreversible=True, num_layers=1,
                         layer_rates=[8], cblk_width=64, cblk_height=64),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stream_and_decode_equal_reference(name):
    kw = dict(CASES[name])
    nc = kw.pop("nc", 3)
    prec = kw.pop("prec", 8)
    kw = {**SMALL, **kw}
    arr = _image(40, 48, nc) << (prec - 8)
    ref = gk.compress(gk.Image.from_array(arr, prec=prec), gk.CompressParams(
        **{k: (gk.ProgressionOrder(int(v)) if k == "progression" else v)
           for k, v in kw.items()}))
    stages = {}
    got = gt.compress(gt.Image.from_array(arr, prec=prec), gt.CompressParams(**kw),
                      device="cpu", stage_ms=stages)
    assert got == ref, f"{len(got)} B against the reference's {len(ref)} B"
    assert {"hull", "pcrd"} <= set(stages)
    for k in (0, 1):
        want = gk.decompress(ref, gk.DecompressParams(max_layers=k))
        back = gt.decompress(got, gt.DecompressParams(max_layers=k), device="cpu")
        for a, b in zip(back.components, want.components):
            np.testing.assert_array_equal(a.data, b.data, err_msg=f"max_layers={k}")


def test_rate_target_is_met_and_simulations_are_counted():
    arr = _image(40, 48, 3)
    stages = {}
    out = gt.compress(gt.Image.from_array(arr),
                      gt.CompressParams(irreversible=True, num_layers=2, layer_rates=[24, 8],
                                        **SMALL), device="cpu", stage_ms=stages)
    assert stages["pcrd_simulations"] >= 2  # at least one a layer
    body_budget = 40 * 48 * 3 * 8 / 8.0 / 8
    assert len(out) < body_budget + 300  # packets within budget; the headers beside them


# ---------------------------------------------------------- (c) checks
@pytest.mark.parametrize("kw", [dict(num_layers=2, layer_rates=[8]),
                                dict(num_layers=1, layer_psnrs=[30, 40])])
def test_target_lengths_are_checked_as_in_reference(kw):
    arr = _image(16, 16, 3)
    with pytest.raises(gk.core.errors.ParameterError):
        gk.compress(gk.Image.from_array(arr), gk.CompressParams(**kw))
    with pytest.raises(gt.ParameterError):
        gt.compress(gt.Image.from_array(arr), gt.CompressParams(**kw), device="cpu")


def test_rates_and_psnrs_together_raise_as_in_reference():
    arr = _image(16, 16, 3)
    kw = dict(num_layers=2, layer_rates=[20, 8], layer_psnrs=[30, 40], num_resolutions=2)
    with pytest.raises(ValueError, match="exclusive"):
        gk.compress(gk.Image.from_array(arr), gk.CompressParams(**kw))
    with pytest.raises(ValueError, match="exclusive"):
        gt.compress(gt.Image.from_array(arr), gt.CompressParams(**kw), device="cpu")
