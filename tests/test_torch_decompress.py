"""grok_tpu_torch's HTJ2K lossless slice on the CPU (the kernels' plain
versions) against grok_tpu.

The inverse transform chain (ops/transform.py: K-g and K-h) against
grok_tpu's jitted ``jax_pipeline.make_inverse_fn``; then the slice:
``compress(..., ht=True)`` byte-identical to ``grok_tpu.compress`` and
``decompress`` equal to ``grok_tpu.decompress`` and to the input, on the
port's streams and on grok_tpu's. Integer arithmetic throughout: every
comparison is exact."""

import jax
import numpy as np
import pytest
import torch

import grok_tpu as gk
import grok_tpu_torch as gt
from grok_tpu.codestream.structs import SizComponent, TccpStyle
from grok_tpu.core.rect import Rect as RefRect
from grok_tpu.ops.jax_pipeline import make_forward_fn, make_inverse_fn
from grok_tpu.tile.geometry import build_tile_comp_geometry
from grok_tpu_torch.core.rect import Rect
from grok_tpu_torch.ops import transform as tr
from tests.conftest import natural_image


# the shapes, origins, precisions and signedness of test_torch_transform.py
@pytest.mark.parametrize("h,w,nc,prec,signed,origin,nres", [
    (37, 53, 1, 8, False, (0, 0), 1),
    (37, 53, 3, 8, False, (0, 0), 6),
    (37, 53, 3, 12, False, (1, 1), 4),
    (37, 53, 1, 16, False, (3, 0), 6),
    (37, 53, 3, 8, True, (0, 5), 3),
    (37, 53, 2, 12, True, (1, 2), 2),
    (53, 37, 3, 16, False, (7, 3), 5),
])
def test_inverse_chain_matches_jax(h, w, nc, prec, signed, origin, nres):
    rng = np.random.default_rng(h * w + nc * 7 + prec + nres)
    lo, hi = (-(1 << (prec - 1)), 1 << (prec - 1)) if signed else (0, 1 << prec)
    planes = [rng.integers(lo, hi, size=(h, w)).astype(np.int32) for _ in range(nc)]
    x0, y0 = origin
    rct = nc >= 3
    tccps = [TccpStyle(num_resolutions=nres) for _ in range(nc)]
    geoms = [build_tile_comp_geometry(c, RefRect(x0, y0, x0 + w, y0 + h), tccps[c])
             for c in range(nc)]
    comps = [SizComponent(prec=prec, signed=signed) for _ in range(nc)]
    packed = [np.asarray(a) for a in
              jax.jit(make_forward_fn(geoms, tccps, comps, 1 if rct else 0))(*planes)]
    ref = [np.asarray(a) for a in
           jax.jit(make_inverse_fn(geoms, tccps, comps, 1 if rct else 0))(*packed)]
    got = tr.inverse_transform([torch.from_numpy(p.copy()) for p in packed],
                               [Rect(x0, y0, x0 + w, y0 + h)] * nc, [nres - 1] * nc,
                               [prec] * nc, [signed] * nc, rct)
    for c in range(nc):
        assert got[c].dtype == torch.int32
        np.testing.assert_array_equal(got[c].numpy(), ref[c], err_msg=f"component {c}")
        np.testing.assert_array_equal(got[c].numpy(), planes[c])


def test_inverse_chain_clips_to_the_precision():
    """Out-of-range coefficients: the chain clips like the reference's."""
    rng = np.random.default_rng(5)
    packed = [rng.integers(-3000, 3000, size=(9, 11)).astype(np.int32) for _ in range(3)]
    tccps = [TccpStyle(num_resolutions=3) for _ in range(3)]
    geoms = [build_tile_comp_geometry(c, RefRect(0, 0, 11, 9), tccps[c]) for c in range(3)]
    comps = [SizComponent(prec=8, signed=False)] * 3
    ref = jax.jit(make_inverse_fn(geoms, tccps, comps, 1))(*packed)
    got = tr.inverse_transform([torch.from_numpy(p.copy()) for p in packed],
                               [Rect(0, 0, 11, 9)] * 3, [2] * 3, [8] * 3, [False] * 3, True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert int(g.min()) == 0 and int(g.max()) == 255


def _image(mod, arr, prec, signed):
    return mod.Image.from_array(arr, prec=prec, signed=signed)


def _planes(arr):
    return arr if arr.ndim == 3 else arr[:, :, None]


def _signed16(h, w):
    return np.random.default_rng(9).integers(-(1 << 15), 1 << 15, size=(h, w)).astype(np.int32)


SLICES = {
    "rgb8_4res": (lambda: natural_image(37, 53, nc=3), 8, False, dict(num_resolutions=4)),
    "gray16_signed": (lambda: _signed16(64, 48), 16, True, dict(num_resolutions=3)),
    "tiles2x2_rpcl": (lambda: natural_image(40, 36, nc=3), 8, False,
                      dict(num_resolutions=3, tile_size=(20, 18),
                           progression=gk.ProgressionOrder.RPCL)),
    # RCT on the first three components, the fourth shifted and clipped alone
    "four_comps_12bit_cprl": (lambda: natural_image(21, 34, nc=4, prec=12), 12, False,
                              dict(num_resolutions=3, progression=gk.ProgressionOrder.CPRL)),
    "two_comps_pcrl": (lambda: natural_image(26, 19, nc=2), 8, False,
                       dict(num_resolutions=2, progression=gk.ProgressionOrder.PCRL)),
}


@pytest.mark.parametrize("name", list(SLICES))
def test_ht_slice_equals_reference(name):
    make, prec, signed, kw = SLICES[name]
    arr = make()
    ref = gk.compress(_image(gk, arr, prec, signed), gk.CompressParams(ht=True, **kw))
    if "progression" in kw:
        kw = dict(kw, progression=gt.ProgressionOrder(int(kw["progression"])))
    got = gt.compress(_image(gt, arr, prec, signed), gt.CompressParams(ht=True, **kw),
                      device="cpu")
    assert got == ref
    back = gt.decompress(got, device="cpu")
    want = gk.decompress(ref)
    for c, comp in enumerate(back.components):
        assert comp.data.dtype == np.int32
        np.testing.assert_array_equal(comp.data, _planes(arr)[:, :, c])
        np.testing.assert_array_equal(comp.data, want.components[c].data)
        assert (comp.prec, comp.signed) == (prec, signed)


@pytest.mark.parametrize("order", list(gk.ProgressionOrder))
def test_decodes_reference_streams(order):
    """grok_tpu's own HT streams in every progression order, with tiles and
    two quality layers of cleanup-only codeblocks."""
    arr = natural_image(30, 26, nc=3)
    stream = gk.compress(gk.Image.from_array(arr),
                         gk.CompressParams(ht=True, num_resolutions=3, progression=order,
                                           tile_size=(16, 16), num_layers=2,
                                           layer_rates=[40.0, 1.0]))
    back = gt.decompress(stream, device="cpu")
    want = gk.decompress(stream)
    for c, comp in enumerate(back.components):
        np.testing.assert_array_equal(comp.data, want.components[c].data)
        np.testing.assert_array_equal(comp.data, arr[:, :, c])


def test_stage_times_are_reported():
    stream = gt.compress(gt.Image.from_array(natural_image(16, 16), prec=8),
                         gt.CompressParams(num_resolutions=2, ht=True), device="cpu")
    stages = {}
    gt.decompress(stream, device="cpu", stage_ms=stages)
    assert set(stages) == {"markers", "t2", "upload", "t1_ht_dec", "scatter", "inverse",
                           "to_host"}
    assert all(v >= 0 for v in stages.values())


def test_outside_the_slice_raises():
    img = natural_image(16, 16)
    part1 = gk.compress(gk.Image.from_array(img), gk.CompressParams(num_resolutions=2))
    back = gt.decompress(part1, device="cpu")  # inside the slices since Part-1 decode
    np.testing.assert_array_equal(back.components[0].data, img)
    lossy = gk.compress(gk.Image.from_array(img),
                        gk.CompressParams(num_resolutions=2, irreversible=True))
    np.testing.assert_array_equal(  # inside the slices since the 9/7 slice
        gt.decompress(lossy, device="cpu").components[0].data,
        gk.decompress(lossy).components[0].data)
    with pytest.raises(gt.UnsupportedFeatureError):
        gt.decompress(gk.compress(gk.Image.from_array(img),
                                  gk.CompressParams(num_resolutions=2, irreversible=True,
                                                    use_eph=True)), device="cpu")
    with pytest.raises(gt.UnsupportedFeatureError):
        gt.compress(gt.Image.from_array(img, prec=8),
                    gt.CompressParams(ht=True, ht_refine=True), device="cpu")
    ht = gk.compress(gk.Image.from_array(img), gk.CompressParams(num_resolutions=2, ht=True))
    for kw in (dict(reduce=1), dict(window=(0, 0, 8, 8)), dict(tile_index=0)):
        with pytest.raises(gt.UnsupportedFeatureError, match=next(iter(kw))):
            gt.decompress(ht, gt.DecompressParams(**kw), device="cpu")
    roi = gk.compress(gk.Image.from_array(img), gk.CompressParams(
        num_resolutions=2, ht=True, irreversible=True, roi_comp=0, roi_shift=2))
    np.testing.assert_array_equal(  # inside the slices since the MCT and ROI slice
        gt.decompress(roi, device="cpu").components[0].data,
        gk.decompress(roi).components[0].data)
    for kw in (dict(use_sop=True), dict(write_plt=True),
               dict(progression_changes=[gk.core.params.ProgressionChange(
                   0, 0, 1, 2, 1, gk.ProgressionOrder.LRCP)])):
        other = gk.compress(gk.Image.from_array(img),
                            gk.CompressParams(num_resolutions=2, ht=True, **kw))
        with pytest.raises(gt.UnsupportedFeatureError):
            gt.decompress(other, device="cpu")


def test_no_card_and_no_device_raises(monkeypatch):
    stream = gt.compress(gt.Image.from_array(natural_image(8, 8), prec=8),
                         gt.CompressParams(num_resolutions=2, ht=True), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.decompress(stream)
