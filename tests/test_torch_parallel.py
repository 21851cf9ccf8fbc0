"""The multi-device layer of grok_tpu_torch (K6) on the CPU, against
grok_tpu's parallel/mesh.py and parallel/distributed.py.

The port's mesh is ``make_mesh(n, device="cpu")`` (n shards running the
kernels' plain versions); the reference's is the virtual 8-device CPU mesh
tests/conftest.py sets up. Inputs are made from a seed with numpy and handed
to both. The strip wavelet must equal the reference's sharded program and
ops/dwt.py exactly (5/3 integers; 9/7 float32 bits through the layout
bridge, where the reference's own XLA:CPU program, which contracts to FMA,
is held to its own test's tolerance); the distributed entry points must
give grok_tpu's streams byte for byte and its decodes sample for sample.
The plain Part-1 coder and decoder are slow on the CPU (about 0.6 ms a
sample to encode, 0.2 ms a decision to decode), so the images are small.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import grok_tpu as gk
import grok_tpu_torch as gt
from grok_tpu.core.rect import Rect
from grok_tpu.ops import dwt as dwt_ops
from grok_tpu.parallel import mesh as ref_mesh
from grok_tpu_torch.codestream.compress import build_siz, build_tcp, encode_tile_to_blob
from grok_tpu_torch.parallel import mesh as pm
from grok_tpu_torch.parallel.distributed import transform_tiles_on_mesh
from grok_tpu_torch.parallel import ops as k6
from tests.conftest import natural_image


def _jax_mesh(n, name):
    return JaxMesh(np.array(jax.devices()[:n]), axis_names=(name,))


def _planes(img) -> list[np.ndarray]:
    return [c.data for c in img.components]


def _same_planes(a, b) -> bool:
    return len(a.components) == len(b.components) and all(
        np.array_equal(x, y) for x, y in zip(_planes(a), _planes(b)))


# ------------------------------------------------------------- the strip wavelet
@pytest.mark.parametrize("n", [1, 3, 8])
def test_strip53_equals_reference_and_inverts(n):
    """The port's 5/3 strip equals grok_tpu's sharded program exactly, its
    bridge equals ops/dwt.py, and its inverse reconstructs exactly; n = 3
    catches an exchange out of bulk-synchronous order (a shard's update
    before its neighbour's predict)."""
    H, W, LV = 32 * n, 128, 3
    x = np.random.default_rng(n).integers(-512, 512, size=(H, W)).astype(np.int32)
    fwd, inv = gt.make_sharded_strip_dwt(gt.make_mesh(n, device="cpu"), LV)
    shards = fwd(x)
    got = pm.join_rows(shards).numpy()
    jfwd, _ = ref_mesh.make_sharded_strip_dwt(_jax_mesh(n, "y"), LV)
    jm = _jax_mesh(n, "y")
    ref = np.asarray(jfwd(jax.device_put(x, NamedSharding(jm, P("y", None)))))
    np.testing.assert_array_equal(got, ref)
    host = dwt_ops.forward(np, x.copy(), Rect(0, 0, W, H), LV, False)
    np.testing.assert_array_equal(pm.strip_to_mallat(got, n, LV), host)
    np.testing.assert_array_equal(pm.strip_to_mallat(torch.from_numpy(got), n, LV).numpy(), host)
    np.testing.assert_array_equal(pm.join_rows(inv(shards)).numpy(), x)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_strip97_equals_host_path_bit_for_bit(n):
    """The 9/7 strip through the bridge equals dwt_ops.forward(np, ...) on
    float32 bits; the reference's sharded program (XLA:CPU, FMA-contracted)
    within its own test's tolerance (tests/test_parallel.py:259); the
    round trip within its 1e-3. The inverse, fed dwt_ops.forward's
    coefficients through the inverse bridge, equals dwt_ops.inverse(np, ...)
    on float32 bits."""
    H, W, LV = 32 * n, 64, 3
    x = (np.random.default_rng(10 + n).standard_normal((H, W)) * 100).astype(np.float32)
    fwd, inv = gt.make_sharded_strip_dwt(gt.make_mesh(n, device="cpu"), LV, irreversible=True)
    shards = fwd(x)
    got = pm.join_rows(shards).numpy()
    host = dwt_ops.forward(np, x.copy(), Rect(0, 0, W, H), LV, True).astype(np.float32)
    np.testing.assert_array_equal(pm.strip_to_mallat(got, n, LV).view(np.int32),
                                  host.view(np.int32))
    jm = _jax_mesh(n, "y")
    jfwd, _ = ref_mesh.make_sharded_strip_dwt(jm, LV, irreversible=True)
    ref = np.asarray(jfwd(jax.device_put(x, NamedSharding(jm, P("y", None)))))
    assert np.allclose(got, ref, atol=1e-2 * max(1.0, np.abs(ref).max() / 100))
    assert np.allclose(pm.join_rows(inv(shards)).numpy(), x, atol=1e-3)
    back = dwt_ops.inverse(np, host.copy(), Rect(0, 0, W, H), LV, True).astype(np.float32)
    got_back = pm.join_rows(inv(pm.mallat_to_strip(host, n, LV))).numpy()
    np.testing.assert_array_equal(got_back.view(np.int32), back.view(np.int32))


@pytest.mark.parametrize("H,n,levels", [(64, 1, 3), (96, 3, 2), (256, 8, 4), (48, 3, 4),
                                        (128, 4, 5)])
def test_bridge_map_equals_reference(H, n, levels):
    W = 64
    np.testing.assert_array_equal(pm.strip_to_mallat_map(H, W, n, levels),
                                  ref_mesh.strip_to_mallat_map(H, W, n, levels))
    y = np.random.default_rng(H).integers(-99, 99, (H, W)).astype(np.int32)
    for fn, ref in ((pm.strip_to_mallat, ref_mesh.strip_to_mallat),
                    (pm.mallat_to_strip, ref_mesh.mallat_to_strip)):
        np.testing.assert_array_equal(fn(torch.from_numpy(y), n, levels).numpy(),
                                      ref(y, n, levels))


@pytest.mark.parametrize("update", [False, True])
@pytest.mark.parametrize("with_halo", [False, True])
def test_strip_steps_and_packing_plain(update, with_halo):
    """K-u's plain steps and their inverses, K-v's packing and unpacking,
    written out on a sub-block of a wider shard."""
    rng = np.random.default_rng(5)
    shard = torch.from_numpy(rng.integers(-300, 300, (10, 9)).astype(np.int32))
    halo = torch.from_numpy(rng.integers(-300, 300, 9).astype(np.int32)) if with_halo else None
    h, w = 8, 6
    x = shard.clone()
    k6.strip53_step(x, h, w, halo, update)
    s, d = shard[:h:2, :w].numpy().astype(np.int64), shard[1:h:2, :w].numpy().astype(np.int64)
    if update:
        left = np.concatenate([(halo[None, :w].numpy() if with_halo else d[:1]), d[:-1]])
        want = s + ((left + d + 2) >> 2)
        np.testing.assert_array_equal(x[:h:2, :w].numpy(), want)
    else:
        right = np.concatenate([s[1:], (halo[None, :w].numpy() if with_halo else s[-1:])])
        np.testing.assert_array_equal(x[1:h:2, :w].numpy(), d - ((s + right) >> 1))
    np.testing.assert_array_equal(x[h:].numpy(), shard[h:].numpy())
    np.testing.assert_array_equal(x[:, w:].numpy(), shard[:, w:].numpy())
    k6.strip53_step(x, h, w, halo, update, inverse=True)
    np.testing.assert_array_equal(x.numpy(), shard.numpy())
    k6.strip_pack_v(x, h, w)
    np.testing.assert_array_equal(x[:h // 2, :w].numpy(), shard[:h:2, :w].numpy())
    np.testing.assert_array_equal(x[h // 2:h, :w].numpy(), shard[1:h:2, :w].numpy())
    k6.strip_unpack_v(x, h, w)
    np.testing.assert_array_equal(x.numpy(), shard.numpy())


@pytest.mark.parametrize("h,w", [(2, 1), (1024, 4096), (1024, 37), (7264, 8), (7264, 5),
                                 (7266, 8), (7266, 37)])
def test_pack_form(h, w):
    """K-v's form from h alone: a column band of all h rows in one block's
    shared memory (227 KB) at the first band of PACK_BANDS that fits, down
    to 8 columns at 7,264 rows; above that the two-pass form. Odd widths
    leave a ragged last band."""
    form = k6.pack_form(h, w)
    if h > 7264:
        assert form == k6.PackForm("two_pass", 0, 0)
        return
    fits = [b for b in k6.PACK_BANDS if h * b * 4 <= k6.SMEM_BYTES]
    assert form == k6.PackForm("smem", fits[0], -(-w // fits[0]))
    assert form.band * h * 4 <= 232_448 and form.band >= 8
    if h == 7264:
        assert form.band == 8
    if h <= 1024:
        assert form.band == k6.PACK_BANDS[0]
    assert form.blocks * form.band >= w > (form.blocks - 1) * form.band


def test_strip97_step_rounds_as_numpy():
    """K-u's 9/7 plain step: x + c * (a + b) with numpy's float32 rounding
    of each operation (a weak Python scalar)."""
    rng = np.random.default_rng(6)
    shard = (rng.standard_normal((8, 5)) * 50).astype(np.float32)
    halo = (rng.standard_normal(5) * 50).astype(np.float32)
    x = torch.from_numpy(shard.copy())
    k6.strip97_step(x, 8, 5, torch.from_numpy(halo), False, k6.STEPS_97[0][1])
    s, d = shard[0::2], shard[1::2]
    want = d + dwt_ops.ALPHA * (s + np.concatenate([s[1:], halo[None]]))
    np.testing.assert_array_equal(x[1::2].numpy().view(np.int32), want.view(np.int32))


# ------------------------------------------------------------- the tile transform
def test_sharded_transform_equals_reference():
    """make_sharded_transform: packed and blk_max exactly the reference's;
    dist exactly numpy's int64 sum of squares, and within the reference's
    1e-3 of its float32 psum."""
    n = 4
    batch = np.random.default_rng(7).integers(0, 256, size=(2 * n, 3, 64, 128)).astype(np.int32)
    packed, blk_max, dist = gt.make_sharded_transform(gt.make_mesh(n, device="cpu"), 3)(batch)
    jm = _jax_mesh(n, "tile")
    r_packed, r_max, r_dist = ref_mesh.make_sharded_transform(jm, levels=3)(
        jax.device_put(batch, NamedSharding(jm, P("tile"))))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(r_packed))
    np.testing.assert_array_equal(blk_max.numpy(), np.asarray(r_max))
    exact = int(np.square(np.asarray(r_packed).astype(np.int64)).sum())
    assert dist.dtype == torch.float32
    assert float(dist) == float(np.float32(exact))
    assert abs(float(dist) - float(r_dist)) < 1e-3 * abs(float(r_dist))
    bmax, total = k6.blk_stats(packed)
    assert int(total.item()) == exact and total.dtype == torch.float64


# ------------------------------------------------------------- the entry points
ENCODE_CASES = {  # (h, w, components, params)
    "53_t64": (72, 80, 1, dict(num_resolutions=3, tile_size=(64, 64))),
    "53_t37_odd_parity": (40, 80, 1, dict(num_resolutions=3, tile_size=(37, 37))),
    "53_ht_t37": (80, 90, 3, dict(num_resolutions=3, tile_size=(37, 37), ht=True)),
    "97_t64": (40, 72, 3, dict(num_resolutions=3, tile_size=(64, 64), irreversible=True)),
    "97_ht_t37": (80, 90, 3, dict(num_resolutions=3, tile_size=(37, 37), irreversible=True,
                                  ht=True)),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_compress_distributed_byte_identical(case):
    h, w, nc, kw = ENCODE_CASES[case]
    arr = natural_image(h, w, nc)
    ref = gk.compress(gk.Image.from_array(arr), gk.CompressParams(**kw))
    got = gt.compress_distributed(gt.Image.from_array(arr), gt.CompressParams(**kw),
                                  mesh=gt.make_mesh(8, device="cpu"))
    assert got == ref


DECODE_CASES = {  # (h, w, components, params): Part-1 small, HT larger
    "53_part1_t16": (24, 30, 3, dict(num_resolutions=3, tile_size=(16, 16))),
    "97_part1_t13_layers": (26, 22, 2, dict(num_resolutions=2, tile_size=(13, 13),
                                            irreversible=True, num_layers=2,
                                            layer_rates=[4.0, 0.0])),
    "53_ht_t37": (80, 90, 3, dict(num_resolutions=3, tile_size=(37, 37), ht=True)),
    "97_ht_t64": (96, 100, 3, dict(num_resolutions=3, tile_size=(64, 64), ht=True,
                                   irreversible=True)),
    # tests/test_parallel.py:146-149's ROI case: a lone roi_shift, which both
    # encoders ignore; and a real ROI on component 0 through HT
    "roi_lone_shift": (20, 33, 1, dict(num_resolutions=3, tile_size=(12, 12), roi_shift=4)),
    "roi_ht": (72, 80, 3, dict(num_resolutions=3, tile_size=(48, 48), roi_comp=0,
                               roi_shift=4, ht=True)),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decompress_distributed_sample_identical(case):
    h, w, nc, kw = DECODE_CASES[case]
    stream = gk.compress(gk.Image.from_array(natural_image(h, w, nc)), gk.CompressParams(**kw))
    ref = gk.decompress(stream)
    got = gt.decompress_distributed(stream, mesh=gt.make_mesh(8, device="cpu"))
    want = [np.asarray(c.data) for c in ref.components]
    assert all(np.array_equal(a, b) for a, b in zip(_planes(got), want))
    assert len(got.components) == len(want)


@pytest.mark.parametrize("frac", [0.3, 0.7])
def test_decompress_distributed_truncated_stream_equals_decompress(frac):
    """A cut multi-tile stream: tiles whose packets run out decode their
    intact prefix on the shards, tiles without data keep the DC fill; the
    planes are decompress's."""
    kw = dict(num_resolutions=3, tile_size=(24, 24), ht=True)
    stream = gk.compress(gk.Image.from_array(natural_image(48, 60, 3)), gk.CompressParams(**kw))
    cut = stream[:int(len(stream) * frac)]
    assert _same_planes(gt.decompress_distributed(cut, mesh=gt.make_mesh(3, device="cpu")),
                        gt.decompress(cut, device="cpu"))


def test_device_irreversible_false_keeps_irreversible_per_tile():
    """With device_irreversible=False the 9/7 tiles stay on the per-tile
    path, as the reference keeps them on its CPU backend: the same stream
    and the same planes, and no shard transforms a tile."""
    kw = dict(num_resolutions=2, tile_size=(32, 32), irreversible=True, ht=True)
    arr = natural_image(48, 40, 3)
    stream = gk.compress(gk.Image.from_array(arr), gk.CompressParams(**kw))
    mesh = gt.make_mesh(2, device="cpu")
    p = gt.CompressParams(**kw)
    im = gt.Image.from_array(arr)
    im.finalize()
    assert transform_tiles_on_mesh(im, build_siz(im, p), build_tcp(im, p), p, range(4), mesh,
                                   device_irreversible=False) == {}
    assert gt.compress_distributed(gt.Image.from_array(arr), p, mesh=mesh,
                                   device_irreversible=False) == stream
    assert _same_planes(gt.decompress_distributed(stream, mesh=mesh, device_irreversible=False),
                        gt.decompress(stream, device="cpu"))


def test_compress_frames_equal_compress():
    """Three small frames dealt to the shards, and a frame of another
    geometry on the per-frame path: each stream grok_tpu's."""
    p = dict(num_resolutions=3, ht=True)
    arrs = [natural_image(40, 48, 3, seed=s) for s in (1, 2, 3)] + [natural_image(24, 40, 3)]
    got = gt.compress_frames([gt.Image.from_array(a) for a in arrs], gt.CompressParams(**p),
                             mesh=gt.make_mesh(2, device="cpu"))
    assert len(got) == len(arrs)
    for a, g in zip(arrs, got):
        assert g == gk.compress(gk.Image.from_array(a), gk.CompressParams(**p))


def test_bridged_strip_feeds_the_encoder():
    """The 5/3 strip's coefficients through the bridge, encoded by
    encode_tile_to_blob(coeffs=): the blob lies in grok_tpu's stream
    (tests/test_parallel.py:262-297)."""
    n, LV = 2, 3
    arr = natural_image(32 * n, 48)
    ref_stream = gk.compress(gk.Image.from_array(arr), gk.CompressParams(num_resolutions=LV + 1))
    fwd, _ = gt.make_sharded_strip_dwt(gt.make_mesh(n, device="cpu"), LV)
    coeffs = pm.strip_to_mallat(pm.join_rows(fwd(arr.astype(np.int32) - 128)), n, LV)
    im = gt.Image.from_array(arr)
    im.finalize()
    p = gt.CompressParams(num_resolutions=LV + 1)
    blob = encode_tile_to_blob(build_siz(im, p), build_tcp(im, p), 0, None, coeffs=[coeffs])
    assert blob in ref_stream


# ------------------------------------------------------------- refusals
def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="make_mesh.*CUDA"):
        gt.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.compress_distributed(gt.Image.from_array(natural_image(16, 16, 3)))
    assert gt.make_mesh(3, device="cpu").devices == [torch.device("cpu")] * 3


@pytest.mark.parametrize("H,W,n,levels,what", [
    (96, 64, 5, 2, "do not divide the height"),
    (96, 64, 3, 6, "does not divide the shard height"),
    (64, 72, 2, 4, "does not divide the width"),
])
def test_strip_limits_are_refused_by_name(H, W, n, levels, what):
    fwd, inv = gt.make_sharded_strip_dwt(gt.make_mesh(n, device="cpu"), levels)
    x = np.zeros((H, W), np.int32)
    with pytest.raises(gt.UnsupportedFeatureError, match=what):
        fwd(x)
    with pytest.raises(gt.UnsupportedFeatureError, match=what):
        inv(x)


@pytest.mark.parametrize("field,value", [("reduce", 1), ("window", (0, 0, 8, 8))])
def test_decompress_distributed_refuses_reduce_and_window(field, value):
    stream = gk.compress(gk.Image.from_array(natural_image(32, 32, 1)),
                         gk.CompressParams(num_resolutions=2, tile_size=(16, 16), ht=True))
    with pytest.raises(gt.UnsupportedFeatureError, match=field):
        gt.decompress_distributed(stream, gt.DecompressParams(**{field: value}),
                                  mesh=gt.make_mesh(2, device="cpu"))


def test_compress_frames_refuses_profile():
    with pytest.raises(gt.UnsupportedFeatureError, match="profile"):
        gt.compress_frames([gt.Image.from_array(natural_image(16, 16, 3))],
                           gt.CompressParams(profile=3), mesh=gt.make_mesh(2, device="cpu"))
