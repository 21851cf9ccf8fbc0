"""K-l ``quant_deadzone`` and K-m ``dequant_midbin`` as the transform chains
call them, once a tile over its list of planes, on the CPU (their plain
versions) against grok_tpu's host path (grok_tpu.ops.native_ops.quant_bands
and dequant_bands over native/pipeline.cpp), bit for bit: the band tables
of tiles of odd sizes and origins at 0 to 5 levels, with 1, 3 and 4
components; and the wrappers' check that a plane's bands tile it."""

import numpy as np
import pytest
import torch

from grok_tpu.ops import native_ops
import grok_tpu_torch as gt
from grok_tpu_torch.codestream.compress import build_siz, build_tcp
from grok_tpu_torch.ops import transform as tr
from grok_tpu_torch.tile.tile_processor import TileProcessor


def _tile(h, w, nc, levels, origin):
    """(plane shapes, band tables) of a 9/7 tile of an h x w x nc image at
    origin (x0, y0)."""
    img = gt.Image.from_array(np.zeros((h, w, nc), dtype=np.uint8))
    x0, y0 = origin
    img.x0, img.y0, img.x1, img.y1 = x0, y0, x0 + w, y0 + h
    img.finalize()
    p = gt.CompressParams(num_resolutions=levels + 1, irreversible=True)
    tp = TileProcessor(build_siz(img, p), build_tcp(img, p), 0, "cpu")
    tp._apply_band_quant()
    return [(g.rect.height, g.rect.width) for g in tp.geoms], tp.band_tables()


CASES = [(17, 23, 1, 0, (0, 0)), (19, 22, 3, 1, (1, 2)), (33, 35, 4, 3, (3, 1)),
         (64, 48, 3, 5, (0, 0)), (37, 41, 1, 4, (5, 7)), (45, 77, 4, 5, (2, 3))]


@pytest.mark.parametrize("h,w,nc,levels,origin", CASES)
def test_tile_equals_host_path(h, w, nc, levels, origin):
    shapes, bands = _tile(h, w, nc, levels, origin)
    assert all(len(b) == 3 * levels + 1 for b in bands)
    rng = np.random.default_rng(h * w + nc)
    planes = [(rng.standard_normal(s) * 200).astype(np.float32) for s in shapes]
    planes[0][0, 0] = 0.0
    q = tr.quant_deadzone([torch.from_numpy(p) for p in planes], bands)
    for g, p, b in zip(q, planes, bands):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), native_ops.quant_bands(p, b))
    d = tr.dequant_midbin(q, bands)
    for g, qc, b in zip(d, q, bands):
        assert g.dtype == torch.float32
        want = native_ops.dequant_bands(np.ascontiguousarray(qc.numpy()), b)
        np.testing.assert_array_equal(g.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("fault", ["a band left out", "a band outside its plane",
                                   "a band twice"])
def test_bands_that_do_not_tile_the_plane_raise(fault):
    shapes, bands = _tile(19, 22, 3, 2, (1, 0))
    bands = [list(b) for b in bands]
    oy, ox, bh, bw, step = bands[1][-1]
    if fault == "a band left out":
        bands[1].pop()
    elif fault == "a band outside its plane":
        bands[1][-1] = (oy + 1, ox, bh, bw, step)
    else:
        bands[1].append(bands[1][0])
    planes = [torch.zeros(s, dtype=torch.float32) for s in shapes]
    with pytest.raises(ValueError):
        tr.quant_deadzone(planes, bands)
    with pytest.raises(ValueError):
        tr.dequant_midbin([p.to(torch.int32) for p in planes], bands)
