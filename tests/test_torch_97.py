"""The irreversible slice of grok_tpu_torch on the CPU (the kernels' plain
versions) against grok_tpu: 9/7 lifting, ICT and dead-zone quantization.

The parity target is grok_tpu's default host path (GROK_TPU_DEVICE unset):
numpy, and native/pipeline.cpp where it is built, op for op the same. The
plain versions of K-j ... K-o must equal it exactly, float32 bits included;
codestreams must be byte-identical and decodes sample-identical. Against
grok_tpu's JAX programs (make_forward_fn/make_inverse_fn on XLA:CPU, which
contracts mul+add into FMA) the tolerance is that program's own drift
(tests/test_device_pipeline.py): quantized indices within +-1 on at most 1%
of the coefficients, decoded samples within +-1."""

import jax
import numpy as np
import pytest
import torch

import grok_tpu as gk
import grok_tpu_torch as gt
from grok_tpu.codestream.compress import build_siz, build_tcp
from grok_tpu.codestream.quantizer import apply_band_quant, compute_signalled_quant
from grok_tpu.codestream.structs import SizComponent, TccpStyle
from grok_tpu.core.params import QuantStyle as RefQuantStyle
from grok_tpu.core.rect import Rect as RefRect
from grok_tpu.ops import dwt, mct, native_ops
from grok_tpu.ops.jax_pipeline import _band_origin, make_forward_fn, make_inverse_fn
from grok_tpu.tile.geometry import build_tile_comp_geometry
from grok_tpu.tile.tile_processor import TileProcessor as RefTileProcessor
from grok_tpu_torch.codestream.compress import build_siz as port_build_siz
from grok_tpu_torch.codestream.compress import build_tcp as port_build_tcp
from grok_tpu_torch.core.rect import Rect
from grok_tpu_torch.tile.tile_processor import TileProcessor
from grok_tpu_torch.ops import transform as tr
from tests.conftest import natural_image


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _assert_same_floats(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# ------------------------------------------------------------- K-k / K-n
LIFT_CASES = [  # (h, w, y0, x0, levels)
    (1, 1, 0, 0, 1), (1, 7, 0, 1, 2), (5, 1, 1, 0, 3), (2, 2, 1, 1, 1), (2, 3, 0, 1, 2),
    (3, 2, 1, 0, 2), (3, 3, 1, 1, 3), (17, 23, 1, 0, 4), (32, 29, 0, 1, 5),
    (40, 33, 3, 5, 6),
]


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("h,w,y0,x0,nl", LIFT_CASES)
def test_lifting_equals_host_path(monkeypatch, native, h, w, y0, x0, nl):
    """Every level of K-k's plain version, then K-n's back, against
    ops/dwt.py forward/inverse (numpy's fwd97_axis/inv97_axis, or
    native/pipeline.cpp): the same float32 bits."""
    if not native:
        monkeypatch.setenv("GROK_TPU_NATIVE_OPS", "0")
    elif not native_ops.available():
        pytest.fail("grok_tpu's native ops did not build")
    rng = np.random.default_rng(h * 131 + w * 7 + nl)
    arr = (rng.standard_normal((h, w)) * 300).astype(np.float32)
    rect = RefRect(x0, y0, x0 + w, y0 + h)
    want = dwt.forward(np, arr.copy(), rect, nl, True)
    got = torch.from_numpy(arr.copy())
    for cur in tr._levels(Rect(x0, y0, x0 + w, y0 + h), nl):
        tr.dwt97_fwd_level(got, cur.height, cur.width, cur.y0 & 1, cur.x0 & 1)
    _assert_same_floats(got, want)
    back = dwt.inverse(np, np.ascontiguousarray(want, dtype=np.float32).copy(), rect, nl, True)
    for cur in reversed(tr._levels(Rect(x0, y0, x0 + w, y0 + h), nl)):
        tr.dwt97_inv_level(got, cur.height, cur.width, cur.y0 & 1, cur.x0 & 1)
    _assert_same_floats(got, back)


# ------------------------------------------------------------- K-j / K-o
@pytest.mark.parametrize("ict", [True, False])
def test_ict_forward_equals_host_path(ict):
    rng = np.random.default_rng(11)
    planes = [rng.integers(0, 4096, size=(9, 13)).astype(np.int32) for _ in range(4)]
    dcs = [2048, 2048, 2048, 0]
    got = tr.dc_ict_fwd([torch.from_numpy(p) for p in planes], dcs, ict)
    shifted = [(p - dc).astype(np.float32) for p, dc in zip(planes, dcs)]
    want = list(mct.ict_forward(np, *shifted[:3])) + shifted[3:] if ict else shifted
    for g, w in zip(got, want):
        _assert_same_floats(g, w)


@pytest.mark.parametrize("ict", [True, False])
def test_ict_inverse_round_clip_equals_host_path(ict):
    """K-o's plain version: the inverse ICT, then floor(v + float32(0.5 + dc))
    clipped, as native/pipeline.cpp ict_finish/finish_irrev; NaN and +-inf
    take the ends of the range as there."""
    rng = np.random.default_rng(12)
    planes = [(rng.standard_normal((7, 11)) * 700).astype(np.float32) for _ in range(3)]
    planes[1][0, :3] = [np.nan, np.inf, -np.inf]
    dcs, ranges = [128, 128, 0], [(0, 255), (0, 255), (-512, 511)]
    got = tr.ict_inv_dc_round_clip([torch.from_numpy(p.copy()) for p in planes], dcs, ranges,
                                   ict)
    vals = list(mct.ict_inverse(np, *planes)) if ict else planes
    for g, v, dc, (lo, hi) in zip(got, vals, dcs, ranges):
        f = np.floor(v + np.float32(0.5 + dc))
        want = np.where(f > lo, f, lo)
        want = np.where(want > hi, hi, want).astype(np.int32)
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), want)


# ------------------------------------------------------------- K-l / K-m
def _bands(h, w):
    return [(0, 0, h // 2, w // 2, 0.37), (0, w // 2, h // 2, w - w // 2, 1.9),
            (h // 2, 0, h - h // 2, w // 3, 0.011), (h // 2, w // 3, h - h // 2, w - w // 3, 7.3)]


def test_quantization_equals_host_path():
    rng = np.random.default_rng(13)
    h, w = 19, 22
    packed = (rng.standard_normal((h, w)) * 90).astype(np.float32)
    packed[0, 0] = 0.0
    bands = _bands(h, w)
    q, = tr.quant_deadzone([torch.from_numpy(packed)], [bands])
    assert q.dtype == torch.int32
    np.testing.assert_array_equal(q.numpy(), native_ops.quant_bands(packed, bands))
    want = np.zeros((h, w), dtype=np.int32)
    for oy, ox, bh, bw, step in bands:  # tile_processor.compress's numpy loop
        v = packed[oy:oy + bh, ox:ox + bw]
        want[oy:oy + bh, ox:ox + bw] = np.sign(v) * np.floor(np.abs(v) / step)
    np.testing.assert_array_equal(q.numpy(), want)
    deq, = tr.dequant_midbin([q], [bands])
    _assert_same_floats(deq, native_ops.dequant_bands(q.numpy(), bands))


# ------------------------------------------------------------- JAX programs
def _jax_chain(nc, prec, signed, origin, h, w, nres, style):
    x0, y0 = origin
    rng = np.random.default_rng(nc * 100 + prec)
    lo, hi = (-(1 << (prec - 1)), 1 << (prec - 1)) if signed else (0, 1 << prec)
    planes = [rng.integers(lo, hi, size=(h, w)).astype(np.int32) for _ in range(nc)]
    tccps = [TccpStyle(num_resolutions=nres, irreversible=True, quant_style=style)
             for _ in range(nc)]
    comps = [SizComponent(prec=prec, signed=signed) for _ in range(nc)]
    geoms = []
    for c in range(nc):
        compute_signalled_quant(tccps[c], prec)
        g = build_tile_comp_geometry(c, RefRect(x0, y0, x0 + w, y0 + h), tccps[c])
        apply_band_quant(g, tccps[c], prec)
        geoms.append(g)
    return planes, tccps, comps, geoms


@pytest.mark.parametrize("nc,prec,signed,origin,h,w,nres,style", [
    (3, 8, False, (0, 0), 24, 30, 3, RefQuantStyle.SCALAR_EXPOUNDED),
    (1, 12, True, (3, 1), 17, 21, 4, RefQuantStyle.SCALAR_DERIVED),
])
def test_chain_within_jax_programs_drift(nc, prec, signed, origin, h, w, nres, style):
    """forward_transform and inverse_transform against make_forward_fn and
    make_inverse_fn on XLA:CPU: indices within +-1 on at most 1% of the
    coefficients, samples within +-1 (the JAX program's own FMA drift)."""
    planes, tccps, comps, geoms = _jax_chain(nc, prec, signed, origin, h, w, nres, style)
    mctv = 1 if nc >= 3 else 0
    ref_q = [np.asarray(a) for a in jax.jit(make_forward_fn(geoms, tccps, comps, mctv))(*planes)]
    x0, y0 = origin
    rects = [Rect(x0, y0, x0 + w, y0 + h)] * nc
    bands = [[(*_band_origin(g, res.r, band.orient), band.rect.height, band.rect.width,
               band.step)
              for res in g.resolutions for band in res.bands] for g in geoms]
    dcs = [0 if signed else 1 << (prec - 1)] * nc
    got_q = tr.forward_transform([torch.from_numpy(p) for p in planes], rects,
                                 [nres - 1] * nc, dcs, bool(mctv), True, bands)
    for g, r in zip(got_q, ref_q):
        d = np.abs(g.numpy().astype(np.int64) - r)
        assert d.max() <= 1 and (d > 0).mean() <= 0.01
    ref_s = [np.asarray(a) for a in
             jax.jit(make_inverse_fn(geoms, tccps, comps, mctv))(*[g.numpy() for g in got_q])]
    got_s = tr.inverse_transform([g.clone() for g in got_q], rects, [nres - 1] * nc,
                                 [prec] * nc, [signed] * nc, bool(mctv), True, bands)
    for g, r in zip(got_s, ref_s):
        assert np.abs(g.numpy().astype(np.int64) - r).max() <= 1


def test_chain_equals_reference_tile_processor():
    """forward_transform's quantized indices equal what grok_tpu's own tile
    encoder hands its T1, via its host path (TileProcessor.compress with
    the entropy stage captured)."""
    arr = natural_image(26, 19, nc=3)
    p = gk.CompressParams(num_resolutions=4, irreversible=True)
    img = gk.Image.from_array(arr)
    img.finalize()
    siz, tcp = build_siz(img, p), build_tcp(img, p)
    tp = RefTileProcessor(siz, tcp, 0)
    captured = []
    tp._entropy_and_t2 = lambda coeffs, packed=None: captured.extend(coeffs) or (b"", [])
    tp.compress([arr[:, :, c] for c in range(3)])
    port_img = gt.Image.from_array(arr)
    port_img.finalize()
    pp = gt.CompressParams(num_resolutions=4, irreversible=True)
    ptp = TileProcessor(port_build_siz(port_img, pp), port_build_tcp(port_img, pp), 0, "cpu")
    ptp._apply_band_quant()
    got = tr.forward_transform([torch.from_numpy(np.ascontiguousarray(arr[:, :, c]))
                                for c in range(3)], [g.rect for g in ptp.geoms], [3] * 3,
                               [128] * 3, True, True, ptp.band_tables())
    for g, want in zip(got, captured):
        np.testing.assert_array_equal(g.numpy(), want)


# ------------------------------------------------------------- whole slice
def _image(mod, arr, prec, signed, origin):
    img = mod.Image.from_array(arr, prec=prec, signed=signed)
    x0, y0 = origin
    img.x0, img.y0, img.x1, img.y1 = x0, y0, x0 + arr.shape[1], y0 + arr.shape[0]
    img.finalize()
    return img


def _signed(h, w, nc, prec):
    a = np.random.default_rng(prec).integers(-(1 << (prec - 1)), 1 << (prec - 1),
                                             size=(h, w, nc)).astype(np.int32)
    return a[:, :, 0] if nc == 1 else a


P = gk.ProgressionOrder
CASES = {  # name: (array, prec, signed, origin, CompressParams fields)
    "rgb8_ict": (lambda: natural_image(24, 20, nc=3), 8, False, (0, 0), {}),
    "gray8_derived": (lambda: natural_image(17, 23), 8, False, (0, 0),
                      dict(quant_style=1, num_resolutions=3)),
    "rgba8_rpcl": (lambda: natural_image(16, 18, nc=4), 8, False, (1, 2),
                   dict(progression=P.RPCL)),
    "rgb12_tiles_rlcp": (lambda: natural_image(22, 26, nc=3, prec=12), 12, False, (3, 1),
                         dict(tile_size=(16, 16), tile_offset=(1, 0), progression=P.RLCP)),
    "signed16_pcrl_guard1": (lambda: _signed(18, 15, 1, 16), 16, True, (0, 0),
                             dict(progression=P.PCRL, guard_bits=1)),
    "signed12x3_cprl_guard3": (lambda: _signed(14, 17, 3, 12), 12, True, (2, 3),
                               dict(progression=P.CPRL, guard_bits=3)),
    "rgb8_no_mct_derived": (lambda: natural_image(20, 21, nc=3), 8, False, (0, 0),
                            dict(mct=0, quant_style=1)),
    "rgb8_ht": (lambda: natural_image(26, 22, nc=3), 8, False, (1, 1), dict(ht=True)),
    "rgb16_ht_derived": (lambda: natural_image(20, 18, nc=3, prec=16), 16, False, (0, 0),
                         dict(ht=True, quant_style=1, num_resolutions=4)),
    "gray8_6levels_style3f": (lambda: natural_image(33, 35), 8, False, (0, 0),
                              dict(num_resolutions=7, cblk_style=0x3F)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stream_and_decode_identical_to_reference(name):
    make, prec, signed, origin, kw = CASES[name]
    kw = dict(num_resolutions=3, cblk_width=16, cblk_height=16, irreversible=True) | kw
    arr = make()
    ref = gk.compress(_image(gk, arr, prec, signed, origin), gk.CompressParams(**kw))
    if "progression" in kw:
        kw["progression"] = gt.ProgressionOrder(int(kw["progression"]))
    if "quant_style" in kw:
        kw["quant_style"] = gt.QuantStyle(kw["quant_style"])
    got = gt.compress(_image(gt, arr, prec, signed, origin), gt.CompressParams(**kw),
                      device="cpu")
    assert got == ref
    want = gk.decompress(ref)
    back = gt.decompress(ref, device="cpu")
    for a, b in zip(back.components, want.components):
        np.testing.assert_array_equal(a.data, b.data)


def test_three_layer_stream_at_every_max_layers():
    """A 9/7 stream with three layers written by grok_tpu (the port writes
    one): each max_layers, and all of them, sample-identical."""
    arr = natural_image(24, 28, nc=3)
    stream = gk.compress(gk.Image.from_array(arr),
                         gk.CompressParams(num_resolutions=3, irreversible=True, num_layers=3,
                                           layer_rates=[40, 12, 4], cblk_width=16,
                                           cblk_height=16))
    for k in (1, 2, 3, 0):
        want = gk.decompress(stream, gk.DecompressParams(max_layers=k))
        got = gt.decompress(stream, gt.DecompressParams(max_layers=k), device="cpu")
        for a, b in zip(got.components, want.components):
            np.testing.assert_array_equal(a.data, b.data, err_msg=f"max_layers={k}")


@pytest.mark.parametrize("kw", [
    # the Part-2 MCT and ROI are ported: their limits are refused by name
    dict(mct_matrix=np.eye(128)), dict(write_ppt=True), dict(roi_comp=0, roi_shift=31),
    # layers and rate or quality targets are ported: the refusals beside
    # them stay
    dict(num_layers=2, use_eph=True), dict(layer_rates=[8.0], write_tlm=True),
    dict(layer_psnrs=[40.0], tp_divider="R"),
    dict(precinct_sizes=[(7, 7)]), dict(use_sop=True), dict(write_plt=True),
    dict(progression_changes=[gt.core.params.ProgressionChange(0, 0, 1, 2, 1,
                                                                gt.ProgressionOrder.LRCP)]),
    dict(write_ppm=True), dict(quant_style=gt.QuantStyle.NO_QUANT),
])
def test_irreversible_refusals_name_the_feature(kw):
    with pytest.raises(gt.UnsupportedFeatureError):
        gt.compress(gt.Image.from_array(natural_image(16, 16, nc=3)),
                    gt.CompressParams(irreversible=True, **kw), device="cpu")


def test_reduce_on_a_97_stream_is_refused_by_name():
    stream = gk.compress(gk.Image.from_array(natural_image(16, 16)),
                         gk.CompressParams(num_resolutions=2, irreversible=True))
    with pytest.raises(gt.UnsupportedFeatureError, match="reduce"):
        gt.decompress(stream, gt.DecompressParams(reduce=1), device="cpu")
