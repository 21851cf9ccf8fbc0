"""grok_tpu_torch.compress on the CPU (the kernels' plain versions) against
grok_tpu.compress.

The reference runs its device transform chain (GROK_TPU_DEVICE=jax) with
the numpy Part-1 coder (GROK_TPU_T1=numpy, the plain reference that
tests/test_t1_pallas.py holds the Pallas kernel to) and the Python T2 path
(GROK_TPU_NATIVE_OPS=0); one case runs the Pallas kernel itself in
interpret mode. Codestreams must be byte-identical, and grok_tpu must
decode the port's stream back to the input exactly."""

import numpy as np
import pytest
import torch

import grok_tpu as gk
import grok_tpu_torch as gt
from tests.conftest import natural_image


@pytest.fixture
def reference_env(monkeypatch):
    monkeypatch.setenv("GROK_TPU_DEVICE", "jax")
    monkeypatch.setenv("GROK_TPU_T1", "numpy")
    monkeypatch.setenv("GROK_TPU_NATIVE_OPS", "0")
    return monkeypatch


def _image(mod, arr, prec, signed, origin):
    img = mod.Image.from_array(arr, prec=prec, signed=signed)
    x0, y0 = origin
    img.x0, img.y0, img.x1, img.y1 = x0, y0, x0 + arr.shape[1], y0 + arr.shape[0]
    img.finalize()
    return img


def _check(arr, prec, signed, origin, **kw):
    ref = gk.compress(_image(gk, arr, prec, signed, origin), gk.CompressParams(**kw))
    got = gt.compress(_image(gt, arr, prec, signed, origin), gt.CompressParams(**kw),
                      device="cpu")
    assert got[:4] == b"\xff\x4f\xff\x51" and got[-2:] == b"\xff\xd9"
    assert got == ref
    back = gk.decompress(got)
    planes = arr if arr.ndim == 3 else arr[:, :, None]
    for c, comp in enumerate(back.components):
        np.testing.assert_array_equal(comp.data, planes[:, :, c])


def _signed16(h, w):
    return np.random.default_rng(9).integers(-(1 << 15), 1 << 15, size=(h, w)).astype(np.int32)


CASES = {
    "gray8": (lambda: natural_image(29, 23), 8, False, (0, 0), dict(num_resolutions=3)),
    "rgb8_rct_6res": (lambda: natural_image(40, 36, nc=3), 8, False, (0, 0), {}),
    "multitile_offsets": (lambda: natural_image(28, 30, nc=3), 8, False, (5, 7),
                          dict(num_resolutions=3, tile_size=(16, 16), tile_offset=(3, 5))),
    "odd_origin_12bit_rpcl": (lambda: natural_image(27, 31, prec=12), 12, False, (3, 1),
                              dict(num_resolutions=4, progression=gk.ProgressionOrder.RPCL)),
    "cblk16x16_style3f": (lambda: natural_image(32, 32, nc=3), 8, False, (1, 0),
                          dict(num_resolutions=3, cblk_width=16, cblk_height=16,
                               cblk_style=0x3F)),
    "cblk32x16_signed16": (lambda: _signed16(30, 20), 16, True, (0, 0),
                           dict(num_resolutions=2, cblk_width=32, cblk_height=16)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stream_identical_to_reference(reference_env, name):
    make, prec, signed, origin, kw = CASES[name]
    if "progression" in kw:
        kw = dict(kw, progression=gt.ProgressionOrder(int(kw["progression"])))
    _check(make(), prec, signed, origin, **kw)


def test_subsampled_chroma_identical(reference_env):
    """4:2:0 components: no RCT (unequal sampling), per-component rects."""
    luma = natural_image(24, 30)
    chroma = np.ascontiguousarray(luma[::2, ::2])

    def image(mod):
        img = mod.Image(0, 0, 30, 24)
        img.components = [mod.Component(prec=8, data=luma)] + [
            mod.Component(dx=2, dy=2, prec=8, data=chroma) for _ in range(2)]
        img.finalize()
        return img

    ref = gk.compress(image(gk), gk.CompressParams(num_resolutions=3))
    got = gt.compress(image(gt), gt.CompressParams(num_resolutions=3), device="cpu")
    assert got == ref
    back = gk.decompress(got)
    for comp, want in zip(back.components, (luma, chroma, chroma)):
        np.testing.assert_array_equal(comp.data, want)


def test_stream_identical_to_pallas_interpret(reference_env):
    """The one case against the Pallas kernel itself, in interpret mode.
    Interpreting costs time in proportion to a block's width and stripes,
    so every codeblock here is 8x8: one kernel shape, about ten seconds."""
    reference_env.setenv("GROK_TPU_T1", "pallas")
    reference_env.setenv("GROK_TPU_PALLAS_INTERPRET", "1")
    _check(natural_image(32, 32, nc=3), 8, False, (0, 0), num_resolutions=2,
           cblk_width=8, cblk_height=8)


@pytest.mark.parametrize("kw", [
    dict(ht=True, ht_refine=True), dict(irreversible=True, quant_style=gt.QuantStyle.NO_QUANT),
    # layers and rate targets, the Part-2 MCT and ROI are ported: the
    # refusals beside them, and the MCT's and ROI's limits, stay
    dict(mct_matrix=np.eye(128)), dict(num_layers=2, write_ppt=True),
    dict(layer_rates=[10.0], write_plm=True), dict(roi_comp=0, roi_shift=31),
    dict(precinct_sizes=[(7, 7)]),
    dict(use_sop=True), dict(use_eph=True), dict(write_tlm=True), dict(write_plt=True),
    dict(tp_divider="R"), dict(profile=3), dict(cblk_style=0x40),
])
def test_unsupported_options_raise(kw):
    with pytest.raises(gt.UnsupportedFeatureError):
        gt.compress(gt.Image.from_array(np.zeros((8, 8), np.int32), prec=8),
                    gt.CompressParams(**kw), device="cpu")


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.compress(gt.Image.from_array(np.zeros((8, 8), np.int32), prec=8))


def test_stage_times_are_reported():
    stages = {}
    gt.compress(gt.Image.from_array(natural_image(16, 16), prec=8),
                gt.CompressParams(num_resolutions=2), device="cpu", stage_ms=stages)
    # one layer: no allocation reads per-pass distortions, so none are summed
    assert set(stages) == {"markers", "upload", "transform", "gather", "t1_symbols",
                           "t1_pack", "to_host", "t2"}
    assert all(v >= 0 for v in stages.values())
