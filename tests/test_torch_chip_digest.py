"""chip_smoke.py's pinned codestream digests come from grok_tpu itself.

chip_smoke.py holds every stream the card writes to ``REF_SHA256``: these
tests make ``grok_tpu.compress`` write the same two images on the CPU, as
Part-1 and as HTJ2K streams, and check the constants, so a wrong constant
cannot pass on the card."""

import hashlib
import sys
from pathlib import Path

import pytest

import grok_tpu

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("h,w", [(256, 256), (chip_smoke.H, chip_smoke.W)])
def test_reference_stream_has_the_pinned_digest(h, w):
    arr = chip_smoke.natural_image(h, w, chip_smoke.NC)
    out = grok_tpu.compress(grok_tpu.Image.from_array(arr),
                            grok_tpu.CompressParams(num_resolutions=6))
    nbytes, digest = chip_smoke.REF_SHA256[f"{h}x{w}x{chip_smoke.NC}"]
    assert len(out) == nbytes
    assert hashlib.sha256(out).hexdigest() == digest


@pytest.mark.parametrize("h,w", [(256, 256), (chip_smoke.H, chip_smoke.W)])
def test_reference_ht_stream_has_the_pinned_digest(h, w):
    arr = chip_smoke.natural_image(h, w, chip_smoke.NC)
    out = grok_tpu.compress(grok_tpu.Image.from_array(arr),
                            grok_tpu.CompressParams(num_resolutions=6, ht=True))
    nbytes, digest = chip_smoke.REF_SHA256[f"ht {h}x{w}x{chip_smoke.NC}"]
    assert len(out) == nbytes
    assert hashlib.sha256(out).hexdigest() == digest


def test_chip_smoke_imports_only_numpy_at_module_level():
    src = Path(chip_smoke.__file__).read_text()
    top = [ln for ln in src.splitlines() if ln.startswith(("import ", "from "))]
    assert all(ln.split()[1] in ("__future__", "hashlib", "json", "subprocess", "sys", "time",
                                 "numpy") for ln in top), top
