"""The Part-2 array MCT and component ROI (RGN) of grok_tpu_torch on the
CPU (the kernels' plain versions) against grok_tpu.

The parity target is grok_tpu's default host path: numpy's float32
``matrix @ flat`` for the MCT (ops/mct.py:83-89), which is a fused
multiply-add chain in k order, and native/pipeline.cpp's ROI shifts and
finish. The plain K-r, K-s and K-t equal it exactly (float32 bits
included), K-i's plain ROI writeout equals ebcot_np's scaled-domain rule on
truncated codeblocks, streams are byte-identical to grok_tpu.compress and
decodes sample-identical to grok_tpu.decompress. Against grok_tpu's JAX
programs (make_forward_fn/make_inverse_fn on XLA:CPU, which contracts
mul+add differently) the integer ROI chain matches exactly and the float
MCT chain within +-1 (tests/test_device_pipeline.py:56-75's class)."""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import grok_tpu as gk
import grok_tpu_torch as gt
from grok_tpu.codestream.markers import parse_main_header as ref_parse_main_header
from grok_tpu.codestream.quantizer import apply_band_quant, compute_signalled_quant
from grok_tpu.codestream.structs import SizComponent, TccpStyle
from grok_tpu.core.params import QuantStyle as RefQuantStyle
from grok_tpu.core.rect import Rect as RefRect
from grok_tpu.ops import mct, native_ops
from grok_tpu.ops.jax_pipeline import _band_origin, make_forward_fn, make_inverse_fn
from grok_tpu.t1 import ebcot_np
from grok_tpu.tile.geometry import build_tile_comp_geometry
from grok_tpu.tile.tile_processor import TileProcessor as RefTileProcessor
from grok_tpu.codestream.compress import build_siz as ref_build_siz
from grok_tpu.codestream.compress import build_tcp as ref_build_tcp
from grok_tpu_torch import convert
from grok_tpu_torch.codestream import markers as port_markers
from grok_tpu_torch.codestream.compress import build_siz as port_build_siz
from grok_tpu_torch.codestream.compress import build_tcp as port_build_tcp
from grok_tpu_torch.core.rect import Rect
from grok_tpu_torch.ops import transform as tr
from grok_tpu_torch.tile.tile_processor import TileProcessor
from tests.conftest import natural_image
from test_torch_part1_decode import kernel_inputs, plain_decode

M3 = [[0.6, 0.3, 0.1], [-0.3, 0.5, -0.2], [0.1, -0.4, 0.5]]  # test_device_pipeline.py:62
M4 = [[0.5, 0.2, 0.2, 0.1], [-0.2, 0.5, -0.2, -0.1], [0.1, -0.3, 0.4, -0.2],
      [0.1, 0.1, -0.2, 0.6]]


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _matrix(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (np.eye(n) + rng.uniform(-0.4, 0.4, (n, n))).astype(np.float64)


# ------------------------------------------------------- K-r / K-s plain
@pytest.mark.parametrize("n", [1, 3, 4, 5])
def test_plain_mct_forward_equals_numpy_matmul(n):
    """K-r's plain version, float32 bit for bit against the host path's
    dc_shift_forward and custom_mct_forward(np, ...)."""
    rng = np.random.default_rng(n)
    planes = [rng.integers(0, 4096, (37, 53)).astype(np.int32) for _ in range(n)]
    dcs = [2048] * n
    m = _matrix(n, n + 10)
    got = tr.dc_mct_fwd([torch.from_numpy(p) for p in planes], dcs, m)
    shifted = [mct.dc_shift_forward(np, p, 12, False).astype(np.float32) for p in planes]
    want = mct.custom_mct_forward(np, shifted, m.astype(np.float32))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("n,prec,signed", [(3, 8, False), (4, 12, False), (5, 10, True)])
def test_plain_mct_inverse_equals_host_path(n, prec, signed):
    """K-s's plain version against custom_mct_inverse(np, ...) and the
    native finish_irrev with each component's offset: exact."""
    rng = np.random.default_rng(prec)
    span = float(1 << prec)
    planes = [(rng.standard_normal((29, 41)) * span / 3).astype(np.float32) for _ in range(n)]
    planes[0][0, :4] = [np.nan, np.inf, -np.inf, 1e30]
    dec = np.linalg.inv(_matrix(n, prec))
    offs = [0.0 if signed else float(1 << (prec - 1))] * n
    offs[-1] = 37.0  # the stream's offsets, not the DC shift
    lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if signed else (0, (1 << prec) - 1)
    got = tr.mct_inv_round_clip([torch.from_numpy(p) for p in planes], dec, offs,
                                [(lo, hi)] * n)
    mixed = mct.custom_mct_inverse(np, [p.copy() for p in planes], dec.astype(np.float32))
    for g, v, off in zip(got, mixed, offs):
        v = np.ascontiguousarray(v, dtype=np.float32)
        want = native_ops.finish_irrev(v, off, lo, hi)
        if want is None:
            with np.errstate(invalid="ignore"):
                f = np.floor(v + np.float32(0.5 + off))
            want = np.where(f > lo, f, lo)
            want = np.where(want > hi, hi, want).astype(np.int32)
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), want)


def _round_to_f32(x: Fraction) -> float:
    """Round a rational to the nearest float32, ties to even, exactly."""
    f = float(np.float32(float(x)))  # within one float32 step of x
    cands = {float(np.nextafter(np.float32(f), np.float32(d))) for d in (-np.inf, np.inf)}
    cands.add(f)
    best = min(cands, key=lambda c: (abs(Fraction(c) - x),
                                     int(np.float32(c).view(np.int32)) & 1))
    return best


def test_fma_emulation_rounds_once():
    """The plain versions' fused step rounds a * b + c once: float64 sums
    that land exactly halfway between two float32s (where rounding the
    float64 sum again would be wrong) and random ones, against exact
    rational arithmetic."""
    one = np.float32(1.0)
    u = np.float32(2.0 ** -23)
    a = np.float32(2.0 ** -12 * (1 + 2.0 ** -23))
    b = np.float32(2.0 ** -12 * (1 - 2.0 ** -23))
    rng = np.random.default_rng(5)
    ws = [float(a), float(a), float(-a)] + [float(v) for v in
                                            rng.standard_normal(200).astype(np.float32)]
    xs = np.array([b, -b, b] + list(rng.standard_normal(200).astype(np.float32)),
                  dtype=np.float32)
    cs = np.array([one + u, one + u, -(one + u)]
                  + list((rng.standard_normal(200) * 4).astype(np.float32)), dtype=np.float32)
    for w, x, c in zip(ws, xs, cs):
        got = tr._fma32(w, torch.tensor([x]), torch.tensor([c]))
        want = _round_to_f32(Fraction(w) * Fraction(float(x)) + Fraction(float(c)))
        assert float(got[0]) == want, (w, x, c)
    # the first case is one the float64 sum alone gets wrong
    naive = np.float32(np.float64(ws[0]) * np.float64(xs[0]) + np.float64(cs[0]))
    assert float(naive) != float(tr._fma32(ws[0], torch.tensor([xs[0]]),
                                           torch.tensor([cs[0]]))[0])


# ------------------------------------------------------------- K-t plain
@pytest.mark.parametrize("shift", [1, 4, 6, 30])
def test_plain_roi_shifts_equal_host_path(shift):
    """roi_up is the host path's int32 ``q << shift`` (wrapping), roi_down
    native/pipeline.cpp roi_unshift, INT32_MIN and values below the
    threshold included."""
    rng = np.random.default_rng(shift)
    a = rng.integers(-(1 << 20), 1 << 20, (23, 31)).astype(np.int32)
    a[0, :6] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1, 1, -(1 << shift)]
    up = tr.roi_up(torch.from_numpy(a.copy()), shift)
    np.testing.assert_array_equal(up.numpy(), a << np.int32(shift))
    down = tr.roi_down(torch.from_numpy(a.copy()), shift)
    want = a.copy()
    if native_ops.roi_unshift(want, shift) is None:
        mag = np.abs(want)
        mag = np.where(mag >= (np.int32(1) << shift), mag >> shift, mag)
        want = np.where(a < 0, -mag, mag).astype(np.int32)
    np.testing.assert_array_equal(down.numpy(), want)


def test_roi_shift_out_of_range_is_refused_by_name():
    with pytest.raises(gt.UnsupportedFeatureError, match="ROI shift of 31"):
        tr.roi_up(torch.zeros((2, 2), dtype=torch.int32), 31)


# ------------------------------------------------- the chain vs JAX programs
def _jax_setup(nc, prec, h, w, nres, irreversible, rois):
    rng = np.random.default_rng(nc * 10 + prec + sum(rois))
    planes = [rng.integers(0, 1 << prec, size=(h, w)).astype(np.int32) for _ in range(nc)]
    qs = RefQuantStyle.SCALAR_EXPOUNDED if irreversible else RefQuantStyle.NO_QUANT
    tccps = [TccpStyle(num_resolutions=nres, irreversible=irreversible, quant_style=qs)
             for _ in range(nc)]
    comps = [SizComponent(prec=prec, signed=False) for _ in range(nc)]
    geoms = []
    for c in range(nc):
        tccps[c].roi_shift = rois[c]
        compute_signalled_quant(tccps[c], prec)
        g = build_tile_comp_geometry(c, RefRect(0, 0, w, h), tccps[c])
        apply_band_quant(g, tccps[c], prec)
        geoms.append(g)
    bands = [[(*_band_origin(g, res.r, band.orient), band.rect.height, band.rect.width,
               band.step) for res in g.resolutions for band in res.bands] for g in geoms]
    return planes, tccps, comps, geoms, bands


@pytest.mark.parametrize("rois,odd", [((4, 0, 0), False), ((0, 6, 0), True)])
def test_roi_chain_53_equals_jax_programs(rois, odd):
    """5/3 + RCT with an ROI shift: forward_transform equals make_forward_fn
    and inverse_transform (the downshift on the staging planes, as for HT
    codeblocks) equals make_inverse_fn, exactly."""
    h, w = 21, (27 if odd else 32)
    planes, tccps, comps, geoms, _ = _jax_setup(3, 8, h, w, 3, False, rois)
    want = [np.asarray(a) for a in jax.jit(make_forward_fn(geoms, tccps, comps, 1))(*planes)]
    rects = [Rect(0, 0, w, h)] * 3
    got = tr.forward_transform([torch.from_numpy(p) for p in planes], rects, [2] * 3,
                               [128] * 3, True, rois=list(rois))
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), r)
    back = [np.asarray(a) for a in
            jax.jit(make_inverse_fn(geoms, tccps, comps, 1))(*[g.numpy() for g in got])]
    out = tr.inverse_transform([g.clone() for g in got], rects, [2] * 3, [8] * 3,
                               [False] * 3, True, rois=list(rois))
    for o, b, p in zip(out, back, planes):
        np.testing.assert_array_equal(o.numpy(), b)
        np.testing.assert_array_equal(o.numpy(), p)


@pytest.mark.parametrize("nc,matrix,rois", [(3, M3, (0, 0, 0)), (4, M4, (0, 0, 0, 0)),
                                            (3, M3, (0, 5, 0))])
def test_mct_chain_97_within_jax_programs_drift(nc, matrix, rois):
    """9/7 with the Part-2 MCT (and an ROI shift): forward_transform and
    inverse_transform against make_forward_fn and make_inverse_fn on
    XLA:CPU, the decoding matrix and offsets as grok_tpu parses them from
    its own stream (convert.mct_arrays_from_numpy): indices within +-1 (in
    units of the ROI step) on at most 1% of the coefficients, samples
    within +-1."""
    h, w = 24, 30
    planes, tccps, comps, geoms, bands = _jax_setup(nc, 8, h, w, 3, True, rois)
    enc = np.asarray(matrix, dtype=np.float64)
    want_q = [np.asarray(a) for a in jax.jit(make_forward_fn(
        geoms, tccps, comps, 2, mct_enc_matrix=enc))(*planes)]
    rects = [Rect(0, 0, w, h)] * nc
    got_q = tr.forward_transform([torch.from_numpy(p) for p in planes], rects, [2] * nc,
                                 [128] * nc, False, True, bands, rois=list(rois),
                                 custom=enc.astype(np.float32))
    for g, r, s in zip(got_q, want_q, rois):
        d = np.abs(g.numpy().astype(np.int64) - r)
        assert (d % (1 << s) == 0).all()
        assert (d >> s).max() <= 1 and (d > 0).mean() <= 0.01
    stream = gk.compress(gk.Image.from_array(np.stack(planes, -1)),
                         gk.CompressParams(num_resolutions=3, mct_matrix=matrix))
    hdr, _ = ref_parse_main_header(memoryview(stream))
    dec, offs = convert.mct_arrays_from_numpy(hdr.default_tcp.mct_dec_matrix,
                                              hdr.default_tcp.mct_offsets)
    assert offs == [128.0] * nc
    want_s = [np.asarray(a) for a in jax.jit(make_inverse_fn(
        geoms, tccps, comps, 2, mct_dec_matrix=hdr.default_tcp.mct_dec_matrix,
        mct_offsets=hdr.default_tcp.mct_offsets))(*[g.numpy() for g in got_q])]
    got_s = tr.inverse_transform([g.clone() for g in got_q], rects, [2] * nc, [8] * nc,
                                 [False] * nc, False, True, bands, rois=list(rois),
                                 custom=dec, offsets=offs)
    for g, r in zip(got_s, want_s):
        assert np.abs(g.numpy().astype(np.int64) - r).max() <= 1


# ---------------------------------------------- K-i's ROI writeout (plain)
def test_plain_decoder_roi_writeout_equals_reference():
    """Codeblocks of upshifted coefficients, cut at seeded passes, decoded
    with the ROI shift in style bits 8-15: the plain K-i equals
    ebcot_np.decode_cblks (the scaled-domain rule of the native decoder)
    exactly. The rule matters on truncated codeblocks: HT's rule applied
    after the halving (|c| >= 1 << s) differs there. ebcot_jax.py:1182-1189
    (|c| >= 1 << (s - 1) after the halving) gives the same values: floor(m / 2)
    >= 2^(s-1) exactly when m >= 2^s, and (m >> 1) >> s = (m >> s) >> 1."""
    n, bh, bw, shift = 8, 12, 10, 4
    rng = np.random.default_rng(17)
    base = np.clip(rng.laplace(size=(n, bh, bw)) * 60, -255, 255).astype(np.int64)
    base[:, ::3, ::2] = 0
    coeffs = base << shift
    coeffs[4:] = base[4:]  # magnitudes in the ROI gap too, as another encoder may write
    hs, ws = rng.integers(4, bh + 1, n), rng.integers(4, bw + 1, n)
    hs[0], ws[0] = bh, bw
    ors = rng.integers(0, 4, n)
    styles = np.array([0, 0x08, 0x02, 0x20, 0x3F, 0, 0x01, 0x04])
    res = ebcot_np.encode_cblks(coeffs, hs, ws, ors, styles=styles)
    cut = np.maximum(res.npasses - rng.integers(1, 12, n), 1)
    flat, starts, lens, keep, seg_arr = kernel_inputs(
        res.data, res.lengths, res.npasses, res.pass_rates, styles, cut)
    roi_styles = styles | (shift << 8)
    got = plain_decode(flat, starts, lens, res.numbps, keep, hs, ws, ors, roi_styles, seg_arr,
                       bh, bw).numpy()
    padded = np.zeros((n, max(lens.max(), 1)), dtype=np.uint8)
    for i in range(n):
        padded[i, :lens[i]] = flat[starts[i]:starts[i] + lens[i]]
    want, _ = ebcot_np.decode_cblks(padded, lens, res.numbps, keep, hs, ws, ors, bh, bw,
                                    styles=roi_styles, seg_lengths=seg_arr)
    np.testing.assert_array_equal(got, want)
    plain = plain_decode(flat, starts, lens, res.numbps, keep, hs, ws, ors, styles, seg_arr,
                         bh, bw).numpy().astype(np.int64)

    def after_halving(thresh):
        mag = np.abs(plain)
        mag = np.where(mag >= thresh, mag >> shift, mag)
        return np.where(plain < 0, -mag, mag)
    assert (after_halving(1 << shift) != got).any()
    np.testing.assert_array_equal(after_halving(1 << (shift - 1)), got)
    # whole codeblocks of upshifted coefficients give them back unshifted
    flat, starts, lens, keep, seg_arr = kernel_inputs(
        res.data, res.lengths, res.npasses, res.pass_rates, styles)
    whole = plain_decode(flat, starts, lens, res.numbps, keep, hs, ws, ors, roi_styles,
                         seg_arr, bh, bw).numpy()
    inside = (np.arange(bh)[:, None] < hs[:, None, None]) & (np.arange(bw) < ws[:, None, None])
    np.testing.assert_array_equal(whole[:4], np.where(inside, base, 0)[:4])


# ---------------------------------------------------- streams and decodes
def _image(mod, arr):
    return mod.Image.from_array(arr)


CASES = {
    # chip_smoke.py's slice_mct_roi configurations, cut to 32-64 px
    "mct_97": (40, 32, 3, dict(num_resolutions=3, mct_matrix=M3)),
    "mct_97_ht": (40, 32, 3, dict(num_resolutions=3, mct_matrix=M3, ht=True)),
    "mct4_97": (33, 27, 4, dict(num_resolutions=3, mct_matrix=M4)),
    "roi_53_ht": (40, 36, 3, dict(num_resolutions=3, roi_comp=0, roi_shift=4, ht=True)),
    "roi_97_layers": (36, 40, 3, dict(num_resolutions=3, roi_comp=1, roi_shift=6,
                                      irreversible=True, num_layers=3,
                                      layer_rates=[32, 16, 8])),
    # the MCT under rate control (every component weighted 1.0), ROI with
    # tiles (5/3 Part-1 and 9/7 HT), the lone roi_shift and custom_mct
    "mct_97_rates": (32, 32, 3, dict(num_resolutions=3, mct_matrix=M3, num_layers=2,
                                     layer_rates=[20, 8])),
    "roi_53_tiles": (40, 40, 3, dict(num_resolutions=3, tile_size=(24, 24), roi_comp=2,
                                     roi_shift=5)),
    "roi_97_ht_tiles": (40, 40, 1, dict(num_resolutions=2, tile_size=(24, 24), roi_comp=0,
                                        roi_shift=3, irreversible=True, ht=True)),
    "lone_roi_shift": (32, 24, 1, dict(num_resolutions=3, tile_size=(16, 16), roi_shift=4)),
    "custom_mct": (24, 24, 3, dict(num_resolutions=2, custom_mct=[[2.0, 0.0], [0.0, 1.0]])),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stream_and_decode_identical_to_reference(name):
    """gt.compress writes gk.compress's bytes; gt.decompress gives
    gk.decompress's samples with max_layers 0 and 1."""
    h, w, nc, kw = CASES[name]
    arr = natural_image(h, w, nc)
    want = gk.compress(_image(gk, arr), gk.CompressParams(**kw))
    got = gt.compress(_image(gt, arr), gt.CompressParams(**kw), device="cpu")
    assert got == want
    for k in (0, 1):
        ref = gk.decompress(want, gk.DecompressParams(max_layers=k))
        out = gt.decompress(want, gt.DecompressParams(max_layers=k), device="cpu")
        assert len(out.components) == len(ref.components)
        for a, b in zip(out.components, ref.components):
            np.testing.assert_array_equal(a.data, b.data)


def test_lone_roi_shift_and_custom_mct_change_nothing():
    """grok_tpu ignores roi_shift without roi_comp and never reads
    custom_mct: the port writes the stream it writes without them."""
    arr = natural_image(24, 24, 3)
    plain = gt.compress(_image(gt, arr), gt.CompressParams(num_resolutions=2), device="cpu")
    for kw in (dict(roi_shift=4), dict(roi_comp=1), dict(custom_mct=[[1.0]])):
        assert gt.compress(_image(gt, arr), gt.CompressParams(num_resolutions=2, **kw),
                           device="cpu") == plain


def test_mct_matrix_forces_the_irreversible_path_and_part2_rsiz():
    arr = natural_image(16, 16, 3)
    p = gt.CompressParams(num_resolutions=2, mct_matrix=M3)
    stream = gt.compress(_image(gt, arr), p, device="cpu")
    assert p.irreversible is False  # the caller's parameters are left as they are
    hdr, _ = port_markers.parse_main_header(stream)
    assert hdr.siz.rsiz == 0x8100 and hdr.default_tcp.mct == 2
    assert hdr.default_tcp.tccps[0].irreversible
    np.testing.assert_array_equal(hdr.default_tcp.mct_dec_matrix,
                                  np.linalg.inv(np.array(M3)).astype(np.float32))
    assert hdr.default_tcp.mct_offsets == [128.0] * 3


@pytest.mark.parametrize("mct_on", [True, False])
def test_mct_weights_equal_reference(mct_on):
    """Rate control weighs every component 1.0 under the Part-2 MCT (the
    reference's _mct_weights, tile_processor.py:866-878)."""
    arr = np.zeros((8, 8, 4), dtype=np.int32)
    kw = dict(num_resolutions=2, irreversible=True)
    if mct_on:
        kw["mct_matrix"] = M4
    img = gk.Image.from_array(arr)
    img.finalize()
    want = RefTileProcessor(ref_build_siz(img, gk.CompressParams(**kw)),
                            ref_build_tcp(img, gk.CompressParams(**kw)), 0)._mct_weights()
    pimg = gt.Image.from_array(arr)
    pimg.finalize()
    pp = gt.CompressParams(**kw)
    tcp = port_build_tcp(pimg, pp)
    assert tcp.mct == (2 if mct_on else 1)
    got = TileProcessor(port_build_siz(pimg, pp), tcp, 0, "cpu", pp)._mct_weights()
    assert got == want
    if mct_on:
        assert got == [1.0] * 4


@pytest.mark.parametrize("kw,feature", [
    (dict(mct_matrix=np.eye(128)), "mct_matrix of more than 127"),
    (dict(roi_comp=0, roi_shift=31), "roi_shift above 30"),
])
def test_refusals_name_the_feature(kw, feature):
    arr = natural_image(8, 8, 3)
    with pytest.raises(gt.UnsupportedFeatureError, match=feature):
        gt.compress(_image(gt, arr), gt.CompressParams(num_resolutions=2, **kw), device="cpu")


def test_mct_on_a_53_stream_is_refused_by_name():
    """A stream signalling the Part-2 MCT over the 5/3 transform: refused by
    name rather than decoded through a path the reference's int32 finish
    does not define."""
    arr = natural_image(16, 16, 3)
    stream = bytearray(gt.compress(_image(gt, arr), gt.CompressParams(num_resolutions=2,
                                                                      mct_matrix=M3),
                                   device="cpu"))
    cod = bytes(stream).index(b"\xff\x52")
    assert stream[cod + 13] == 0  # SPcod's transform byte: 9/7
    stream[cod + 13] = 1
    with pytest.raises(gt.UnsupportedFeatureError, match="MCT 2 with the 5/3 transform"):
        gt.decompress(bytes(stream), device="cpu")


def _rgn_in_tile_parts(stream: bytes) -> bytes:
    """The stream with its main-header RGN moved into every tile-part
    header (Psot grows by the segment's length)."""
    pos = stream.index(b"\xff\x5e")
    rgn = stream[pos:pos + 2 + int.from_bytes(stream[pos + 2:pos + 4], "big")]
    body = stream[:pos] + stream[pos + len(rgn):]
    out, at = bytearray(), 0
    while True:
        sot = body.find(b"\xff\x90\x00\x0a", at)
        if sot < 0:
            return bytes(out + body[at:])
        psot = int.from_bytes(body[sot + 6:sot + 10], "big")
        out += body[at:sot + 6] + (psot + len(rgn)).to_bytes(4, "big") + body[sot + 10:sot + 12]
        out += rgn + body[sot + 12:sot + psot]
        at = sot + psot


def test_rgn_in_tile_part_headers_decodes_like_the_reference():
    arr = natural_image(32, 32, 3)
    kw = dict(num_resolutions=2, tile_size=(16, 16), roi_comp=1, roi_shift=5, ht=True)
    stream = _rgn_in_tile_parts(gk.compress(_image(gk, arr), gk.CompressParams(**kw)))
    hdr, _ = port_markers.parse_main_header(stream)
    assert all(t.roi_shift == 0 for t in hdr.default_tcp.tccps)
    ref = gk.decompress(stream)
    got = gt.decompress(stream, device="cpu")
    for a, b, c in zip(got.components, ref.components, range(3)):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.data, arr[:, :, c])
