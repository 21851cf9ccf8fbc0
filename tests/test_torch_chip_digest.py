"""chip_smoke.py's pinned digests come from grok_tpu itself.

chip_smoke.py holds every stream the card writes to ``REF_SHA256``, every
9/7 and rate-controlled decode to ``REF_MD5`` and every corpus decode to
``CORPUS_REF_MD5``: these tests make ``grok_tpu.compress`` write the same
images on the CPU (as Part-1, HTJ2K, 9/7 and layered, rate-controlled
streams, and with the Part-2 MCT and ROI) and ``grok_tpu.decompress``
decode them and the corpus, and check the constants, so a wrong constant
cannot pass on the card."""

import functools
import hashlib
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import grok_tpu
from tests.conftest import golden_md5

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# the image is made once for the three encodes of each size
natural_image = functools.lru_cache(maxsize=3)(chip_smoke.natural_image)


@pytest.mark.parametrize("h,w", [(256, 256), (chip_smoke.H, chip_smoke.W)])
def test_reference_stream_has_the_pinned_digest(h, w):
    arr = natural_image(h, w, chip_smoke.NC)
    out = grok_tpu.compress(grok_tpu.Image.from_array(arr),
                            grok_tpu.CompressParams(num_resolutions=6))
    nbytes, digest = chip_smoke.REF_SHA256[f"{h}x{w}x{chip_smoke.NC}"]
    assert len(out) == nbytes
    assert hashlib.sha256(out).hexdigest() == digest


@pytest.mark.parametrize("h,w", [(256, 256), (chip_smoke.H, chip_smoke.W)])
def test_reference_ht_stream_has_the_pinned_digest(h, w):
    arr = natural_image(h, w, chip_smoke.NC)
    out = grok_tpu.compress(grok_tpu.Image.from_array(arr),
                            grok_tpu.CompressParams(num_resolutions=6, ht=True))
    nbytes, digest = chip_smoke.REF_SHA256[f"ht {h}x{w}x{chip_smoke.NC}"]
    assert len(out) == nbytes
    assert hashlib.sha256(out).hexdigest() == digest


@pytest.mark.parametrize("case", list(chip_smoke.WIDE_HT_CASES))
def test_reference_wide_ht_streams_have_the_pinned_digests(case):
    """slice_ht_wide's 28-bit HT streams (coefficients from 2^24 up); the
    5/3 stream decodes to the input."""
    arr = chip_smoke.wide_image(64, 64, 3, chip_smoke.WIDE_BITS)
    assert arr.max() >= 1 << (chip_smoke.WIDE_BITS - 1)
    kw = chip_smoke.WIDE_HT_CASES[case]
    out = grok_tpu.compress(grok_tpu.Image.from_array(arr, prec=chip_smoke.WIDE_BITS),
                            grok_tpu.CompressParams(**kw))
    key = f"ht {case} 64x64x3"
    assert (len(out), hashlib.sha256(out).hexdigest()) == chip_smoke.REF_SHA256[key]
    if not kw.get("irreversible"):
        for c, p in enumerate(grok_tpu.decompress(out).components):
            np.testing.assert_array_equal(p.data, arr[:, :, c])


def test_chip_smoke_imports_only_numpy_at_module_level():
    src = Path(chip_smoke.__file__).read_text()
    top = [ln for ln in src.splitlines() if ln.startswith(("import ", "from "))]
    assert all(ln.split()[1] in ("__future__", "hashlib", "json", "subprocess", "sys", "time",
                                 "numpy") for ln in top), top


@pytest.mark.parametrize("h,w", [(256, 256), (chip_smoke.H, chip_smoke.W)])
def test_reference_97_stream_and_decode_have_the_pinned_digests(h, w):
    arr = natural_image(h, w, chip_smoke.NC)
    out = grok_tpu.compress(grok_tpu.Image.from_array(arr),
                            grok_tpu.CompressParams(**chip_smoke.P97))
    key = f"97 {h}x{w}x{chip_smoke.NC}"
    assert (len(out), hashlib.sha256(out).hexdigest()) == chip_smoke.REF_SHA256[key]
    back = grok_tpu.decompress(out)
    assert golden_md5([c.data for c in back.components]) == chip_smoke.REF_MD5[key]


@pytest.mark.parametrize("case", list(chip_smoke.RC_CASES))
def test_reference_rc_streams_and_decodes_have_the_pinned_digests(case):
    arr = natural_image(256, 256, chip_smoke.NC)
    out = grok_tpu.compress(grok_tpu.Image.from_array(arr),
                            grok_tpu.CompressParams(**chip_smoke.RC_CASES[case]))
    key = f"{case} 256x256x{chip_smoke.NC}"
    assert (len(out), hashlib.sha256(out).hexdigest()) == chip_smoke.REF_SHA256[key]
    for k in (0, 1):
        back = grok_tpu.decompress(out, grok_tpu.DecompressParams(max_layers=k))
        assert golden_md5([c.data for c in back.components]) == chip_smoke.REF_MD5[f"{key} L{k}"]


def test_reference_1bpp_stream_and_decode_have_the_pinned_digests():
    """bench.py's lossy97_1bpp row at full size."""
    arr = natural_image(chip_smoke.H, chip_smoke.W, chip_smoke.NC)
    out = grok_tpu.compress(grok_tpu.Image.from_array(arr),
                            grok_tpu.CompressParams(**chip_smoke.P1BPP))
    key = f"1bpp {chip_smoke.H}x{chip_smoke.W}x{chip_smoke.NC}"
    assert (len(out), hashlib.sha256(out).hexdigest()) == chip_smoke.REF_SHA256[key]
    back = grok_tpu.decompress(out)
    assert golden_md5([c.data for c in back.components]) == chip_smoke.REF_MD5[key]


@pytest.mark.parametrize("case", list(chip_smoke.MCT_ROI_CASES))
def test_reference_mct_roi_streams_and_decodes_have_the_pinned_digests(case):
    """slice_mct_roi's Part-2 MCT and ROI streams at 256x256, decoded with
    max_layers 0 and 1."""
    nc, kw = chip_smoke.MCT_ROI_CASES[case]
    arr = natural_image(256, 256, nc)
    out = grok_tpu.compress(grok_tpu.Image.from_array(arr), grok_tpu.CompressParams(**kw))
    key = f"{case} 256x256x{nc}"
    assert (len(out), hashlib.sha256(out).hexdigest()) == chip_smoke.REF_SHA256[key]
    for k in (0, 1):
        back = grok_tpu.decompress(out, grok_tpu.DecompressParams(max_layers=k))
        assert golden_md5([c.data for c in back.components]) == chip_smoke.REF_MD5[f"{key} L{k}"]


@pytest.mark.parametrize("name", ["mct", "roi", "roi_ht"])
def test_reference_4k_mct_and_roi_streams_have_the_pinned_digests(name):
    """e2e_mct (PMCT), e2e_roi (PROI) and e2e_roi_ht (PROI_HT) at full size:
    the streams, the MCT stream's decode digest, the lossless ROI streams'
    decodes the input."""
    kw = {"mct": chip_smoke.PMCT, "roi": chip_smoke.PROI, "roi_ht": chip_smoke.PROI_HT}[name]
    arr = natural_image(chip_smoke.H, chip_smoke.W, chip_smoke.NC)
    out = grok_tpu.compress(grok_tpu.Image.from_array(arr), grok_tpu.CompressParams(**kw))
    key = f"{name} {chip_smoke.H}x{chip_smoke.W}x{chip_smoke.NC}"
    assert (len(out), hashlib.sha256(out).hexdigest()) == chip_smoke.REF_SHA256[key]
    planes = [c.data for c in grok_tpu.decompress(out).components]
    if name == "mct":
        assert golden_md5(planes) == chip_smoke.REF_MD5[key]
    else:
        assert key not in chip_smoke.REF_MD5
        for c, p in enumerate(planes):
            np.testing.assert_array_equal(p, arr[:, :, c])


@pytest.mark.parametrize("name", ["dist53", "dist97"])
def test_reference_4k_tiled_streams_have_the_pinned_digests(name):
    """e2e_dist (DIST53, DIST97: 1024x1024 tiles) at full size: the streams,
    the 9/7 stream's decode digest, the 5/3 stream's decode the input."""
    kw = {"dist53": chip_smoke.DIST53, "dist97": chip_smoke.DIST97}[name]
    arr = natural_image(chip_smoke.H, chip_smoke.W, chip_smoke.NC)
    out = grok_tpu.compress(grok_tpu.Image.from_array(arr), grok_tpu.CompressParams(**kw))
    key = f"{name} {chip_smoke.H}x{chip_smoke.W}x{chip_smoke.NC}"
    assert (len(out), hashlib.sha256(out).hexdigest()) == chip_smoke.REF_SHA256[key]
    planes = [c.data for c in grok_tpu.decompress(out).components]
    if name == "dist97":
        assert golden_md5(planes) == chip_smoke.REF_MD5[key]
    else:
        assert key not in chip_smoke.REF_MD5
        for c, p in enumerate(planes):
            np.testing.assert_array_equal(p, arr[:, :, c])


def test_e2e_frames_frame0_is_the_pinned_image():
    """e2e_frames' frame 0 (seed FRAME_SEEDS[0]) is the 4K image of the
    pinned "97 ..." stream, and the other seeds make other images."""
    seeds = chip_smoke.FRAME_SEEDS
    h, w, nc = chip_smoke.H // 8, chip_smoke.W // 8, chip_smoke.NC
    assert seeds[0] == 3 and len(set(seeds)) == len(seeds)
    first = chip_smoke.natural_image(h, w, nc, seed=seeds[0])
    np.testing.assert_array_equal(first, chip_smoke.natural_image(h, w, nc))
    assert not np.array_equal(first, chip_smoke.natural_image(h, w, nc, seed=seeds[1]))


def test_p1bpp_is_benchs_lossy97_1bpp_row():
    src = (Path(__file__).resolve().parents[1] / "bench.py").read_text()
    assert re.search(r'"lossy97_1bpp": \(\s*gk\.CompressParams\(num_resolutions=6, '
                     r'irreversible=True,\s*num_layers=1, layer_rates=\[8\]\)', src)
    assert chip_smoke.P1BPP == dict(num_resolutions=6, irreversible=True, num_layers=1,
                                    layer_rates=[8])


def test_corpus_digests_are_the_reference_decodes():
    """Every pinned corpus digest is grok_tpu's decode of that stream with
    the manifest's decode parameters."""
    corpus = Path(__file__).resolve().parent / "corpus"
    manifest = {e["name"]: e for e in json.loads((corpus / "manifest.json").read_text())}
    assert set(chip_smoke.CORPUS_REF_MD5) <= set(manifest)
    for name, md5 in chip_smoke.CORPUS_REF_MD5.items():
        img = grok_tpu.decompress((corpus / "streams" / name).read_bytes(),
                                  grok_tpu.DecompressParams(**manifest[name].get("decode", {})))
        assert golden_md5([c.data for c in img.components]) == md5, name


def test_chip_smoke_digest_recipe_is_the_corpus_recipe():
    rng = np.random.default_rng(4)
    planes = [rng.integers(-9, 300, size=s).astype(np.int32) for s in ((3, 5), (2, 7))]
    assert chip_smoke.golden_md5(planes) == golden_md5(planes)
