"""grok_tpu_torch's forward transform chain (ops/transform.py: DC shift, RCT,
multi-level 5/3 lifting, Mallat packing) against grok_tpu's jitted
``jax_pipeline.make_forward_fn`` on the CPU. Integer arithmetic throughout,
so the packed coefficient planes must be equal."""

import jax
import numpy as np
import pytest
import torch

from grok_tpu.codestream.structs import SizComponent, TccpStyle
from grok_tpu.core.rect import Rect as RefRect
from grok_tpu.ops.jax_pipeline import make_forward_fn
from grok_tpu.tile.geometry import build_tile_comp_geometry
from grok_tpu_torch.core.rect import Rect
from grok_tpu_torch.ops import transform as tr


@pytest.mark.parametrize("h,w,nc,prec,signed,origin,nres", [
    (37, 53, 1, 8, False, (0, 0), 1),
    (37, 53, 3, 8, False, (0, 0), 6),
    (37, 53, 3, 12, False, (1, 1), 4),
    (37, 53, 1, 16, False, (3, 0), 6),
    (37, 53, 3, 8, True, (0, 5), 3),
    (37, 53, 2, 12, True, (1, 2), 2),
    (53, 37, 3, 16, False, (7, 3), 5),
])
def test_forward_chain_matches_jax(h, w, nc, prec, signed, origin, nres):
    rng = np.random.default_rng(h * w + nc * 7 + prec + nres)
    lo, hi = (-(1 << (prec - 1)), 1 << (prec - 1)) if signed else (0, 1 << prec)
    planes = [rng.integers(lo, hi, size=(h, w)).astype(np.int32) for _ in range(nc)]
    x0, y0 = origin
    rct = nc >= 3

    tccps = [TccpStyle(num_resolutions=nres) for _ in range(nc)]
    geoms = [build_tile_comp_geometry(c, RefRect(x0, y0, x0 + w, y0 + h), tccps[c])
             for c in range(nc)]
    comps = [SizComponent(prec=prec, signed=signed) for _ in range(nc)]
    fn = jax.jit(make_forward_fn(geoms, tccps, comps, 1 if rct else 0))
    ref = [np.asarray(a) for a in fn(*planes)]

    dcs = [0 if signed else 1 << (prec - 1)] * nc
    got = tr.forward_transform([torch.from_numpy(p) for p in planes],
                               [Rect(x0, y0, x0 + w, y0 + h)] * nc, [nres - 1] * nc,
                               dcs, rct)
    for c in range(nc):
        assert got[c].dtype == torch.int32
        np.testing.assert_array_equal(got[c].numpy(), ref[c], err_msg=f"component {c}")


@pytest.mark.parametrize("n,parity", [(1, 0), (1, 1), (2, 1), (7, 0), (7, 1), (8, 1)])
def test_one_level_short_lines(n, parity):
    """Lines of one and two samples and both origin parities, one level,
    against the same level of the JAX chain."""
    rng = np.random.default_rng(n + 10 * parity)
    plane = rng.integers(-500, 500, size=(n, n + 3)).astype(np.int32)
    tccp = TccpStyle(num_resolutions=2)
    rect = RefRect(parity, parity, parity + n + 3, parity + n)
    geom = build_tile_comp_geometry(0, rect, tccp)
    fn = jax.jit(make_forward_fn([geom], [tccp], [SizComponent(prec=10, signed=True)], 0))
    ref = np.asarray(fn(plane)[0])
    got = torch.from_numpy(plane.copy())
    tr.dwt53_fwd_level(got, n, n + 3, parity, parity)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrappers_refuse_bad_inputs():
    p = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tr.dc_rct_fwd([p.to(torch.int64)], [0], False)
    with pytest.raises(ValueError):
        tr.dc_rct_fwd([p, p], [0, 0], True)  # RCT needs three planes
    with pytest.raises(ValueError):
        tr.dwt53_fwd_level(p.t(), 4, 4, 0, 0)  # not contiguous
    with pytest.raises(ValueError):
        tr.dwt53_fwd_level(p, 5, 4, 0, 0)
    with pytest.raises(ValueError):  # a device that is neither CPU nor CUDA
        tr.dwt53_fwd_level(p.to("meta"), 4, 4, 0, 0)
    with pytest.raises(ValueError):
        tr.dc_rct_fwd([p.to("meta")], [0], False)
