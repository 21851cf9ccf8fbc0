"""Every stream of tests/corpus/corrupt/ through grok_tpu_torch.decompress
on the CPU (the kernels' plain versions): a typed error or planes, never a
crash, and the same outcome as grok_tpu's: the same planes where both give
planes, an error where grok_tpu raises, and where only grok_tpu gives
planes a feature the port refuses by name (UnsupportedFeatureError). The
two SIZ bombs (tile_grid_bomb, empty_tile_walk_bomb) must fail or finish
fast, without allocating for the tiles a corrupt SIZ claims.

Kept apart from tests/test_torch_robustness.py so that neither file
dominates a test worker: the plain Part-1 decoder needs 15-30 s for each
of the 128x96x3 streams here."""

import os
import time

import numpy as np
import pytest

import grok_tpu as gk
import grok_tpu_torch as gt
from grok_tpu.core.errors import GrokTpuError as RefError
from grok_tpu_torch.core.errors import GrokTpuError

CORRUPT = os.path.join(os.path.dirname(__file__), "corpus", "corrupt")
FILES = sorted(f for f in os.listdir(CORRUPT) if f.endswith(".j2k"))
TYPED = (GrokTpuError, ValueError, IndexError, OverflowError)


@pytest.mark.parametrize("name", FILES)
def test_corrupt_stream_has_the_reference_outcome(name):
    data = open(os.path.join(CORRUPT, name), "rb").read()
    try:
        ref = [np.asarray(c.data) for c in gk.decompress(data).components]
    except (RefError, ValueError, IndexError, OverflowError) as e:
        ref = e
    t0 = time.perf_counter()
    try:
        got = [np.asarray(c.data) for c in gt.decompress(data, device="cpu").components]
    except TYPED as e:
        got = e
    if "bomb" in name:
        assert time.perf_counter() - t0 < 5.0
    if isinstance(got, Exception):
        assert isinstance(ref, Exception) or isinstance(got, gt.UnsupportedFeatureError), got
        return
    assert isinstance(ref, list), ref
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
