"""Decoder robustness of grok_tpu_torch on the CPU (the kernels' plain
versions): truncated and corrupt streams give typed errors or planes, never
a crash (the port's counterpart of tests/test_robustness.py), and where
grok_tpu gives planes the port gives the same planes.

grok_tpu keeps the intact prefix of a tile's packets (its default native
T2) and decodes a tile that still fails as an empty one; so does the port.
A feature refused by name (UnsupportedFeatureError) is not corruption: it
still propagates. The streams come from grok_tpu.compress, since the port
writes one layer only."""

import numpy as np
import pytest

import grok_tpu as gk
import grok_tpu_torch as gt
from grok_tpu.core.errors import GrokTpuError as RefError
from grok_tpu_torch.core.errors import GrokTpuError
from tests.conftest import natural_image

TYPED = (GrokTpuError, ValueError, IndexError, OverflowError)


def _planes(img):
    return [np.asarray(c.data) for c in img.components]


def _outcome(data):
    """(reference planes or its error, port planes or its error); the
    port's error must be typed."""
    try:
        ref = _planes(gk.decompress(data))
    except (RefError, ValueError, IndexError, OverflowError) as e:
        ref = e
    try:
        got = _planes(gt.decompress(data, device="cpu"))
    except TYPED as e:
        got = e
    return ref, got


def _check_against_reference(data):
    """Planes equal the reference's wherever both give planes; where only
    the reference does, the port refused a feature by name."""
    ref, got = _outcome(data)
    if isinstance(got, Exception):
        assert isinstance(ref, Exception) or isinstance(got, gt.UnsupportedFeatureError), got
        return got
    assert isinstance(got, list) and all(p is not None for p in got)
    if isinstance(ref, list):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("frac", [0.1, 0.3, 0.6, 0.9, 0.99])
@pytest.mark.parametrize("ht", [False, True])
def test_cut_stream_planes_equal_reference(ht, frac):
    """40x40x3 with 24x24 tiles cut to a fraction of its stream: the port's
    planes equal grok_tpu.decompress's."""
    arr = np.random.default_rng(0).integers(0, 256, (40, 40, 3)).astype(np.int32)
    stream = gk.compress(gk.Image.from_array(arr),
                         gk.CompressParams(tile_size=(24, 24), num_resolutions=3, ht=ht))
    got = _check_against_reference(stream[:int(len(stream) * frac)])
    assert isinstance(got, list)


@pytest.mark.parametrize("ht", [False, True])
def test_truncation_sweep(ht):
    arr = natural_image(40, 40)
    stream = gk.compress(gk.Image.from_array(arr), gk.CompressParams(num_resolutions=3, ht=ht))
    for frac in (0.02, 0.1, 0.3, 0.6, 0.9, 0.99):
        _check_against_reference(stream[:int(len(stream) * frac)])


@pytest.mark.parametrize("ht", [False, True])
def test_byte_corruption_fuzz(ht):
    """Random bytes overwritten in a two-layer stream: typed errors or
    planes, the reference's planes where it gives planes (HT codeblocks
    with refinement passes, outside the slices, are refused by name)."""
    rng = np.random.default_rng(1)
    arr = natural_image(32, 32)
    stream = bytearray(gk.compress(gk.Image.from_array(arr),
                                   gk.CompressParams(num_resolutions=3, ht=ht, num_layers=2,
                                                     layer_rates=[16, 1])))
    for _ in range(30):
        mutated = bytearray(stream)
        for _ in range(int(rng.integers(1, 8))):
            pos = int(rng.integers(0, len(mutated)))
            mutated[pos] = int(rng.integers(0, 256))
        _check_against_reference(bytes(mutated))


def test_garbage_input():
    rng = np.random.default_rng(2)
    for data in (b"", b"\x00" * 100, bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),
                 b"\xff\x4f\xff\x51" + b"\x00" * 50):
        ref, got = _outcome(data)
        assert isinstance(got, Exception) and isinstance(ref, Exception)


def test_missing_tile_fills_dc_midgray():
    """A tile without tile-part data holds the value of zero coefficients;
    the tiles present still decode exactly."""
    arr = np.random.default_rng(0).integers(0, 256, (40, 56)).astype(np.int32)
    s = gk.compress(gk.Image.from_array(arr, prec=8),
                    gk.CompressParams(tile_size=(32, 32), num_resolutions=2))
    last_sot = s.rfind(b"\xff\x90")
    img = gt.decompress(s[:last_sot] + b"\xff\xd9", device="cpu")
    data = img.components[0].data
    assert set(np.unique(data[32:, 32:]).tolist()) == {128}
    np.testing.assert_array_equal(data[:32, :32], arr[:32, :32])
    np.testing.assert_array_equal(_planes(img), _planes(gk.decompress(s[:last_sot] + b"\xff\xd9")))


def test_a_tile_index_outside_the_grid_leaves_dc_midgray():
    """An SOT naming a tile the grid does not have: nothing decodes there
    and the image holds the DC level, as in grok_tpu."""
    arr = natural_image(16, 16)
    s = bytearray(gk.compress(gk.Image.from_array(arr), gk.CompressParams(num_resolutions=2)))
    sot = s.find(b"\xff\x90")
    s[sot + 4:sot + 6] = (7).to_bytes(2, "big")  # Isot = 7 of a one-tile grid
    got = _check_against_reference(bytes(s))
    assert set(np.unique(got[0]).tolist()) == {128}


def test_refused_feature_in_a_tile_still_raises():
    """A tile-part header with a feature outside the slices (an RGN shift
    above 30) raises by name: the tile tolerance does not hide a refusal."""
    arr = natural_image(16, 16)
    s = gk.compress(gk.Image.from_array(arr), gk.CompressParams(num_resolutions=2))
    sot = s.find(b"\xff\x90")
    rgn = b"\xff\x5e\x00\x05\x00\x00\x1f"  # RGN: component 0, style 0, shift 31
    psot = int.from_bytes(s[sot + 6:sot + 10], "big") + len(rgn)
    s = s[:sot + 6] + psot.to_bytes(4, "big") + s[sot + 10:sot + 12] + rgn + s[sot + 12:]
    with pytest.raises(gt.UnsupportedFeatureError, match="RGN"):
        gt.decompress(s, device="cpu")
