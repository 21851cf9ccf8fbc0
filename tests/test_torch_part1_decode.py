"""grok_tpu_torch's Part-1 (MQ) decode on the CPU (the plain versions of
K-i) against grok_tpu.

The plain MQ decoder against ``mq_np.MQDecoder`` decision for decision;
the plain codeblock decoder against ``ebcot_np.decode_cblks`` for every
codeblock style and, at 8x8, against ``ebcot_jax.decode_cblks`` (K5);
then the slice: ``decompress(stream, device="cpu")`` sample-identical to
``grok_tpu.decompress`` on grok_tpu's Part-1 streams, layer-limited
decodes included. Integer arithmetic throughout: every comparison is
exact (tolerance 0)."""

import numpy as np
import pytest
import torch

import grok_tpu as gk
import grok_tpu_torch as gt
from grok_tpu.t1 import ebcot_np, mq_np
from grok_tpu_torch.t1 import ebcot_cuda as ec
from grok_tpu_torch.t1.mq import MQDecoder, mq_table
from grok_tpu_torch.t2.packets import _segment_splits, merge_segments
from conftest import natural_image


# ----------------------------------------------------------------- MQ decoder
def _flat(data: np.ndarray):
    """A padded [N, L] byte array as the port's flat buffer and starts."""
    n, L = data.shape
    return (torch.from_numpy(data.reshape(-1).copy()),
            torch.arange(n, dtype=torch.int64) * L, torch.full((n,), L, dtype=torch.int64))


def _mq_streams(n, seed):
    """Per lane: an MQ segment, a raw segment, an MQ segment (the BYPASS
    shape), written by mq_np's encoder; returns the bytes, the three
    segment lengths and the coded (ctx, bit, mask) and raw (bit, mask)
    decisions."""
    rng = np.random.default_rng(seed)
    enc = mq_np.MQEncoder(n, 4096)
    script = []
    for pi, part in enumerate(("mq", "raw", "mq")):
        for _ in range(int(rng.integers(150, 400))):
            mask = rng.random(n) < 0.8
            if part == "mq":
                ctx = rng.integers(0, 19, n)
                bits = (rng.random(n) < np.where(ctx < 9, 0.1, 0.5)).astype(np.uint8)
                enc.encode(bits, ctx, mask)
                script.append(("mq", ctx, bits, mask))
            else:
                bits = (rng.random(n) < 0.5).astype(np.int64)
                enc.raw_bit(bits, mask)
                script.append(("raw", None, bits, mask))
        if pi == 0:
            ends0 = enc.terminate_restart(np.ones(n, dtype=bool))
            enc.raw_start(np.ones(n, dtype=bool))
        elif pi == 1:
            ends1 = enc.raw_terminate_restart_mq(np.ones(n, dtype=bool))
    enc.flush(np.ones(n, dtype=bool))
    ends2 = enc.lengths()
    data = enc.buf[:, 1:].copy()
    return data, (ends0, ends1 - ends0, ends2 - ends1), script


@pytest.mark.parametrize("seed,cut", [(1, 0), (2, 0), (3, 5)])
def test_mq_decoder_equals_reference(seed, cut):
    """Decision for decision on mq_np's streams: MQ, raw, re-primed MQ.
    ``cut`` drops that many bytes from each segment's end (a truncated
    buffer), where both decoders read 0xFF."""
    n = 6
    data, (l0, l1, l2), script = _mq_streams(n, seed)
    l0c, l1c, l2c = (np.maximum(x - cut, 0) for x in (l0, l1, l2))
    ref = mq_np.MQDecoder(data, l0c)
    d, starts, totals = _flat(data)
    got = MQDecoder(d, starts, totals, torch.from_numpy(l0c), mq_table())
    T = torch.from_numpy
    phase = 0
    for kind, ctx, _, mask in script:
        if kind == "raw" and phase == 0:
            phase = 1
            on = np.ones(n, dtype=bool)
            ref.raw_init(on, l0, l1c)
            got.raw_init(T(on), T(l0), T(l1c))
        elif kind == "mq" and phase == 1:
            phase = 2
            on = np.ones(n, dtype=bool)
            ref.init_registers(on, l0 + l1, l2c)
            got.init_registers(T(on), T(l0 + l1), T(l2c))
        if kind == "mq":
            want = ref.decode(ctx, mask)
            have = got.decode(T(ctx), T(mask))
        else:
            want = ref.raw_bit(mask)
            have = got.raw_bit(T(mask))
        np.testing.assert_array_equal(have.numpy(), want.astype(np.int64))
    assert phase == 2


def test_mq_decoder_decodes_what_was_coded():
    n = 4
    data, (l0, l1, l2), script = _mq_streams(n, 9)
    d, starts, totals = _flat(data)
    dec = MQDecoder(d, starts, totals, torch.from_numpy(l0), mq_table())
    T = torch.from_numpy
    phase = 0
    for kind, ctx, bits, mask in script:
        if kind == "raw" and phase == 0:
            phase = 1
            dec.raw_init(T(np.ones(n, dtype=bool)), T(l0), T(l1))
        elif kind == "mq" and phase == 1:
            phase = 2
            dec.init_registers(T(np.ones(n, dtype=bool)), T(l0 + l1), T(l2))
        have = dec.decode(T(ctx), T(mask)) if kind == "mq" else dec.raw_bit(T(mask))
        np.testing.assert_array_equal(have.numpy(), np.where(mask, bits, 0))


# ------------------------------------------------------- codeblock decoder
def _repair(rates, npasses):
    """The tile encoder's monotone repair of the conservative pass rates."""
    from grok_tpu_torch.tile.tile_processor import _repair_pass_rates

    rates = np.array(rates, dtype=np.int64)
    _repair_pass_rates(rates, np.asarray(npasses, dtype=np.int64))
    return rates


def kernel_inputs(data, lengths, npasses, rates, styles, cut=None, split=None):
    """K-i's byte inputs from an encoder's output (numpy): the flat bytes,
    starts, lengths, passes kept and merged segment lengths [n, max_segs].
    ``cut`` keeps that many passes of each codeblock (at their rates);
    ``split`` puts a layer boundary after that many passes, so a TERMALL
    or BYPASS segment may arrive in two pieces, merged by
    ``merge_segments``."""
    n = len(lengths)
    keep = np.asarray(npasses if cut is None else np.minimum(cut, npasses), dtype=np.int64)
    rates = _repair(rates, npasses)
    chunks, lens, segs = [], [], []
    for i in range(n):
        k = int(keep[i])
        end = 0 if k == 0 else (int(lengths[i]) if k == npasses[i]
                                else min(int(rates[i, k - 1]), int(lengths[i])))

        def at(p):
            return 0 if p == 0 else (end if p == k else min(int(rates[i, p - 1]), end))
        chunks.append(np.asarray(data[i, :end], dtype=np.uint8))
        lens.append(end)
        sty = int(styles[i])
        if not sty & 0x05 or k == 0:
            segs.append([])
            continue
        s = k if split is None else min(int(split[i]), k)
        pieces, passes, p = [], [], 0
        for first, count in ((0, s), (s, k - s)):
            for np_s in _segment_splits(sty, first, count):
                pieces.append(at(p + np_s) - at(p))
                passes.append(np_s)
                p += np_s
        merged = merge_segments(sty, pieces, passes)
        whole, p = [], 0
        for np_s in _segment_splits(sty, 0, k):
            whole.append(at(p + np_s) - at(p))
            p += np_s
        assert merged == whole
        segs.append(merged)
    seg_arr = np.zeros((n, max(1, max(map(len, segs)))), dtype=np.int32)
    for i, m in enumerate(segs):
        seg_arr[i, :len(m)] = m
    flat = np.concatenate(chunks + [np.zeros(1, np.uint8)])
    lens = np.asarray(lens, dtype=np.int64)
    return flat, np.cumsum(lens) - lens, lens, keep, seg_arr


def plain_decode(flat, starts, lens, numbps, keep, hs, ws, ors, styles, seg_arr, bh, bw):
    lanes = np.stack([numbps, keep, hs, ws, ors, styles, lens]).astype(np.int32)
    return ec.ebcot_decode_plain(
        torch.from_numpy(flat), torch.from_numpy(starts.astype(np.int64)),
        torch.from_numpy(lanes), torch.from_numpy(seg_arr), ec.device_tables("cpu")["ctx"],
        ec.device_tables("cpu")["mq"], bh, bw)


def encoded_batch(n, bh, bw, bits, style, seed):
    """A seeded batch of n codeblocks (sizes up to bh x bw, Laplacian
    magnitudes below 2**bits) through ebcot_np's encoder."""
    rng = np.random.default_rng(seed)
    coeffs = np.clip(rng.laplace(size=(n, bh, bw)) * (1 << bits) / 12,
                     -(1 << bits) + 1, (1 << bits) - 1).astype(np.int64)
    hs = rng.integers(1, bh + 1, n)
    ws = rng.integers(1, bw + 1, n)
    hs[0], ws[0] = bh, bw
    ors = rng.integers(0, 4, n)
    styles = np.full(n, style)
    res = ebcot_np.encode_cblks(coeffs, hs, ws, ors, styles=styles)
    return coeffs, hs, ws, ors, styles, res


STYLES = [0, 0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x3F]


@pytest.mark.parametrize("style", STYLES, ids=[f"style{s:#04x}" for s in STYLES])
@pytest.mark.parametrize("bh,bw", [(10, 6), (3, 8)])
def test_plain_decoder_equals_reference(style, bh, bw):
    """ebcot_np.decode_cblks on the same segments: whole codeblocks, then
    stopped at a seeded pass (mid-bin reconstruction), with segments split
    across a layer boundary and merged, and the last codeblock's passes
    with no bytes at all (decoded from 0xFF pads)."""
    n = 7
    coeffs, hs, ws, ors, styles, res = encoded_batch(n, bh, bw, 10, style, style + bh)
    rng = np.random.default_rng(style * 3 + bw)
    for cut in (None, rng.integers(0, res.npasses + 1)):
        split = rng.integers(0, res.npasses + 1)
        flat, starts, lens, keep, seg_arr = kernel_inputs(
            res.data, res.lengths, res.npasses, res.pass_rates, styles, cut, split)
        if cut is not None:
            lens[-1] = 0
            seg_arr[-1] = 0
            assert keep[-1] > 0
        got = plain_decode(flat, starts, lens, res.numbps, keep, hs, ws, ors, styles, seg_arr,
                           bh, bw)
        padded = np.zeros((n, max(lens.max(), 1)), dtype=np.uint8)
        for i in range(n):
            padded[i, :lens[i]] = flat[starts[i]:starts[i] + lens[i]]
        want, _ = ebcot_np.decode_cblks(padded, lens, res.numbps, keep, hs, ws, ors, bh, bw,
                                        styles=styles,
                                        seg_lengths=seg_arr if style & 0x05 else None)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        if cut is None:
            np.testing.assert_array_equal(got.numpy(), np.where(
                (np.arange(bh)[:, None] < hs[:, None, None])
                & (np.arange(bw) < ws[:, None, None]), coeffs, 0))
        else:
            assert (keep < res.npasses).any()


def test_plain_decoder_equals_reference_64x64():
    """One whole 64x64 codeblock of every style bit, cut at a pass."""
    coeffs, hs, ws, ors, styles, res = encoded_batch(1, 64, 64, 3, 0x3F, 64)
    flat, starts, lens, keep, seg_arr = kernel_inputs(
        res.data, res.lengths, res.npasses, res.pass_rates, styles, res.npasses - 2)
    got = plain_decode(flat, starts, lens, res.numbps, keep, hs, ws, ors, styles, seg_arr, 64, 64)
    want, _ = ebcot_np.decode_cblks(res.data, lens, res.numbps, keep, hs, ws, ors, 64, 64,
                                    styles=styles, seg_lengths=seg_arr)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_decoder_equals_k5():
    """ebcot_jax.decode_cblks itself (K5's lockstep decoder) on the shape
    of tests/test_t1.py's decoder round trip: 8x8, five codeblocks."""
    from grok_tpu.t1 import ebcot_jax

    rng = np.random.default_rng(0)
    coeffs = (rng.standard_normal((5, 8, 8)) * 25).astype(np.int64)
    hs, ws = np.array([8, 5, 8, 3, 8]), np.array([8, 8, 6, 8, 8])
    ors = np.array([0, 1, 2, 3, 0])
    styles = np.array([0, 0x08, 0x02, 0x20, 0x2A])
    res = ebcot_np.encode_cblks(coeffs, hs, ws, ors, styles=styles)
    want, _ = ebcot_jax.decode_cblks(res.data, res.lengths, res.numbps, res.npasses,
                                     hs, ws, ors, 8, 8, styles=styles)
    flat, starts, lens, keep, seg_arr = kernel_inputs(
        res.data, res.lengths, res.npasses, res.pass_rates, styles)
    got, planes = ec.decode_cblks(torch.from_numpy(flat), starts,
                                  np.stack([res.numbps, keep, hs, ws, ors, styles, lens]),
                                  seg_arr, 8, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :8, :8])
    np.testing.assert_array_equal(planes.numpy(), res.numbps)


def test_decoder_refuses_more_than_30_planes():
    lanes = torch.tensor([[31, 1, 4, 4, 0, 0, 2]], dtype=torch.int32).T.contiguous()
    tabs = ec.device_tables("cpu")
    with pytest.raises(gt.UnsupportedFeatureError, match="30"):
        ec.ebcot_decode(torch.zeros(2, dtype=torch.uint8), torch.zeros(1, dtype=torch.int64),
                        lanes, torch.zeros((1, 1), dtype=torch.int32), tabs["ctx"], tabs["mq"],
                        4, 4)
    lanes[0, 0] = 30  # the limit itself decodes
    out = ec.ebcot_decode(torch.zeros(2, dtype=torch.uint8), torch.zeros(1, dtype=torch.int64),
                          lanes, torch.zeros((1, 1), dtype=torch.int32), tabs["ctx"],
                          tabs["mq"], 4, 4)
    assert out.shape == (1, 4, 4)


# ------------------------------------------------------------------- slice
def _image(mod, arr, prec, signed):
    return mod.Image.from_array(arr, prec=prec, signed=signed)


def _signed(h, w, nc, prec, seed):
    r = np.random.default_rng(seed)
    a = natural_image(h, w, nc=nc).astype(np.int64) * (1 << (prec - 8)) - (1 << (prec - 1))
    a += r.integers(0, 1 << (prec - 8), a.shape)
    return a.astype(np.int32)


def _assert_same(stream, max_layers=0):
    back = gt.decompress(stream, gt.DecompressParams(max_layers=max_layers), device="cpu")
    want = gk.decompress(stream, gk.DecompressParams(max_layers=max_layers))
    assert len(back.components) == len(want.components)
    for c, comp in enumerate(back.components):
        assert comp.data.dtype == np.int32
        np.testing.assert_array_equal(comp.data, want.components[c].data, err_msg=f"comp {c}")
        assert (comp.prec, comp.signed) == (want.components[c].prec, want.components[c].signed)
    return back


O = gk.ProgressionOrder
SLICES = {
    "lrcp_rgb8": (lambda: natural_image(20, 24, nc=3), 8, False, dict(num_resolutions=3)),
    "rlcp_gray8": (lambda: natural_image(17, 22), 8, False,
                   dict(num_resolutions=3, progression=O.RLCP)),
    "rpcl_rgb12_signed": (lambda: _signed(14, 18, 3, 12, 1), 12, True,
                          dict(num_resolutions=2, progression=O.RPCL)),
    "pcrl_four16": (lambda: natural_image(12, 13, nc=4).astype(np.int32) * 257, 16, False,
                    dict(num_resolutions=2, progression=O.PCRL)),
    "cprl_gray16_signed": (lambda: _signed(11, 15, 1, 16, 2), 16, True,
                           dict(num_resolutions=3, progression=O.CPRL)),
    "tiles_rgb8_style3f": (lambda: natural_image(26, 23, nc=3), 8, False,
                           dict(num_resolutions=2, tile_size=(13, 12), cblk_style=0x3F)),
    "bypass_rgb8": (lambda: natural_image(20, 20, nc=3), 8, False,
                    dict(num_resolutions=2, cblk_style=0x01)),
}


@pytest.mark.parametrize("name", list(SLICES))
def test_part1_slice_equals_reference(name):
    """grok_tpu's Part-1 streams: every progression order, 1, 3 and 4
    components, 8-16 bits signed and unsigned, tiles, styles 0x3F and
    BYPASS alone; the decode equals grok_tpu's and the input."""
    make, prec, signed, kw = SLICES[name]
    arr = make()
    stream = gk.compress(_image(gk, arr, prec, signed), gk.CompressParams(**kw))
    back = _assert_same(stream)
    planes = arr if arr.ndim == 3 else arr[:, :, None]
    for c, comp in enumerate(back.components):
        np.testing.assert_array_equal(comp.data, planes[:, :, c])


@pytest.mark.parametrize("max_layers", [0, 1, 2, 3])
def test_layer_limited_decode_equals_reference(max_layers):
    """A three-layer 0x3F stream (layer_rates 20, 5, 1) in RLCP, where the
    unwanted layers sit between wanted packets: truncated codeblocks decode
    to grok_tpu's mid-bin samples."""
    arr = natural_image(28, 30, nc=3)
    stream = gk.compress(gk.Image.from_array(arr), gk.CompressParams(
        num_resolutions=3, num_layers=3, layer_rates=[20, 5, 1], cblk_style=0x3F,
        progression=O.RLCP))
    back = _assert_same(stream, max_layers)
    exact = all(np.array_equal(c.data, arr[:, :, i]) for i, c in enumerate(back.components))
    assert exact == (max_layers in (0, 3))


def test_bypass_layers_dropped_mid_stream():
    """BYPASS alone, five layers in RPCL: dropped packets of later layers
    still place the raw/MQ segment splits of the packets that follow."""
    arr = natural_image(24, 24, nc=3)
    stream = gk.compress(gk.Image.from_array(arr), gk.CompressParams(
        num_resolutions=2, num_layers=5, layer_rates=[40, 20, 8, 3, 1], cblk_style=0x01,
        progression=O.RPCL))
    for ml in (2, 4):
        _assert_same(stream, ml)


def test_port_stream_decodes_to_input():
    arr = natural_image(19, 21, nc=3)
    stream = gt.compress(gt.Image.from_array(arr), gt.CompressParams(num_resolutions=3),
                         device="cpu")
    stages = {}
    back = gt.decompress(stream, device="cpu", stage_ms=stages)
    for c, comp in enumerate(back.components):
        np.testing.assert_array_equal(comp.data, arr[:, :, c])
    assert set(stages) == {"markers", "t2", "upload", "t1_dec", "scatter", "inverse",
                           "to_host"}


def test_ht_layer_limited_decode_equals_reference():
    arr = natural_image(24, 20, nc=3)
    stream = gk.compress(gk.Image.from_array(arr), gk.CompressParams(
        ht=True, num_resolutions=3, num_layers=2, layer_rates=[40.0, 1.0]))
    _assert_same(stream, 1)
