"""Transform chains of the reversible path: DC level shift, RCT and
multi-level 5/3 lifting, Mallat-packed, forward and inverse.

Counterpart of the reversible branches of grok_tpu/ops/jax_pipeline.py
make_forward_fn (:43-111) and make_inverse_fn (:144-223) over ops/mct.py
(dc shift :64, rct_forward :33, rct_inverse :41) and ops/dwt.py
(fwd53_axis :112, forward :259, inv53_axis :128, inverse :285). Four
kernels live here, each beside its plain torch version: K-a
``dc_rct_fwd`` (csrc/dc_rct.cu), K-b ``dwt53_fwd_level`` (csrc/dwt53.cu),
K-g ``dwt53_inv_level`` (csrc/dwt53_inv.cu) and K-h ``rct_inv_dc_clip``
(csrc/rct_inv.cu). A wrapper takes the plain version only for CPU tensors;
CUDA tensors launch the kernel. All arithmetic is int32 with arithmetic
right shifts, so the kernels and their plain versions are bit-exact.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..core.rect import Rect


def _check_plane(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous 2-d int32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


# ============================================= K-a: DC shift + RCT
def dc_rct_fwd(planes: list[torch.Tensor], dcs: list[int], rct: bool) -> list[torch.Tensor]:
    """New int32 planes: ``planes[c] - dcs[c]``, then RCT on the first
    three when ``rct`` (y = (r + 2g + b) >> 2, cb = b - g, cr = r - g)."""
    dev = planes[0].device
    for i, p in enumerate(planes):
        _check_plane(p, f"plane {i}")
        if p.device != dev:
            raise ValueError("all planes must share one device")
    if rct and (len(planes) < 3 or not planes[0].shape == planes[1].shape == planes[2].shape):
        raise ValueError("RCT needs three equally-sized planes")
    if dev.type == "cpu":
        return dc_rct_fwd_plain(planes, dcs, rct)
    if dev.type != "cuda":
        raise ValueError(f"dc_rct_fwd: unsupported device {dev}")
    outs = [torch.empty_like(p) for p in planes]
    k = kernels.KERNELS["dc_rct_fwd"]
    stream = kernels.stream_ptr(dev)
    first = 0
    if rct:
        k.call(*(p.data_ptr() for p in planes[:3]), *(o.data_ptr() for o in outs[:3]),
               planes[0].numel(), dcs[0], dcs[1], dcs[2], 1, stream)
        first = 3
    for c in range(first, len(planes)):
        k.call(planes[c].data_ptr(), None, None, outs[c].data_ptr(), None, None,
               planes[c].numel(), dcs[c], 0, 0, 0, stream)
    return outs


def dc_rct_fwd_plain(planes, dcs, rct):
    shifted = [p - dc for p, dc in zip(planes, dcs)]
    if rct:
        r, g, b = shifted[:3]
        shifted[:3] = [(r + 2 * g + b) >> 2, b - g, r - g]
    return shifted


# ============================================= K-b: one 5/3 level
def dwt53_fwd_level(plane: torch.Tensor, h: int, w: int, py: int, px: int) -> None:
    """One forward 5/3 level, in place: the top-left h x w of ``plane``
    becomes [[LL, HL], [LH, HH]]; py/px are the level rect's origin
    parities (y0 & 1, x0 & 1)."""
    _check_plane(plane, "plane")
    if h > plane.shape[0] or w > plane.shape[1]:
        raise ValueError("level region exceeds the plane")
    if h == 0 or w == 0:
        return
    dev = plane.device
    if dev.type == "cpu":
        dwt53_fwd_level_plain(plane, h, w, py, px)
        return
    if dev.type != "cuda":
        raise ValueError(f"dwt53_fwd_level: unsupported device {dev}")
    tmp = torch.empty(h * w, dtype=torch.int32, device=dev)
    kernels.KERNELS["dwt53_fwd_level"].call(
        plane.data_ptr(), tmp.data_ptr(), plane.stride(0), h, w, py, px,
        kernels.stream_ptr(dev))


def _fwd53_axis(x: torch.Tensor, axis: int, parity: int) -> torch.Tensor:
    """One forward 5/3 pass along axis, returning Mallat-packed [s | d];
    symmetric extension is a clamp to the nearest opposite-phase sample."""
    n = x.shape[axis]
    if n == 1:
        return x * 2 if parity == 1 else x
    s = x.index_select(axis, torch.arange(parity, n, 2, device=x.device))
    d = x.index_select(axis, torch.arange(1 - parity, n, 2, device=x.device))
    sn, dn = s.shape[axis], d.shape[axis]
    j = torch.arange(dn, device=x.device)
    if parity == 0:
        sl, sr = j, (j + 1).clamp(max=sn - 1)
    else:
        sl, sr = (j - 1).clamp(min=0), j.clamp(max=sn - 1)
    d = d - ((s.index_select(axis, sl) + s.index_select(axis, sr)) >> 1)
    i = torch.arange(sn, device=x.device)
    if parity == 0:
        dl, dr = (i - 1).clamp(min=0), i.clamp(max=dn - 1)
    else:
        dl, dr = i, (i + 1).clamp(max=dn - 1)
    s = s + ((d.index_select(axis, dl) + d.index_select(axis, dr) + 2) >> 2)
    return torch.cat([s, d], dim=axis)


def dwt53_fwd_level_plain(plane, h, w, py, px):
    sub = _fwd53_axis(plane[:h, :w], 0, py)
    plane[:h, :w] = _fwd53_axis(sub, 1, px)


# ============================================= the chain
def forward_transform(planes: list[torch.Tensor], rects: list[Rect],
                      num_levels: list[int], dcs: list[int], rct: bool) -> list[torch.Tensor]:
    """DC shift + RCT + multi-level 5/3 of a tile's components; returns
    the Mallat-packed int32 coefficient planes (resolution r occupies the
    top-left ceil(rect / 2^(NL-r)))."""
    out = dc_rct_fwd(planes, dcs, rct)
    for plane, rect, nl in zip(out, rects, num_levels):
        cur = rect
        for _ in range(nl):
            if cur.height == 0 or cur.width == 0:
                break
            dwt53_fwd_level(plane, cur.height, cur.width, cur.y0 & 1, cur.x0 & 1)
            cur = cur.ceil_div_pow2(1)
    return out


# ============================================= K-g: one inverse 5/3 level
def dwt53_inv_level(plane: torch.Tensor, h: int, w: int, py: int, px: int) -> None:
    """One inverse 5/3 level, in place: the Mallat-packed top-left h x w
    of ``plane`` ([[LL, HL], [LH, HH]]) becomes natural order; py/px are
    the level rect's origin parities."""
    _check_plane(plane, "plane")
    if h > plane.shape[0] or w > plane.shape[1]:
        raise ValueError("level region exceeds the plane")
    if h == 0 or w == 0:
        return
    dev = plane.device
    if dev.type == "cpu":
        dwt53_inv_level_plain(plane, h, w, py, px)
        return
    if dev.type != "cuda":
        raise ValueError(f"dwt53_inv_level: unsupported device {dev}")
    tmp = torch.empty(h * w, dtype=torch.int32, device=dev)
    kernels.KERNELS["dwt53_inv_level"].call(
        plane.data_ptr(), tmp.data_ptr(), plane.stride(0), h, w, py, px,
        kernels.stream_ptr(dev))


def _inv53_axis(y: torch.Tensor, axis: int, parity: int) -> torch.Tensor:
    """One inverse 5/3 pass along axis: Mallat-packed [s | d] in, natural
    order out; the neighbours are the forward pass's clamped ones."""
    n = y.shape[axis]
    if n == 1:
        return y >> 1 if parity == 1 else y
    sn = n // 2 if parity else (n + 1) // 2
    dn = n - sn
    s, d = y.narrow(axis, 0, sn), y.narrow(axis, sn, dn)
    i = torch.arange(sn, device=y.device)
    if parity == 0:
        dl, dr = (i - 1).clamp(min=0), i.clamp(max=dn - 1)
    else:
        dl, dr = i, (i + 1).clamp(max=dn - 1)
    s = s - ((d.index_select(axis, dl) + d.index_select(axis, dr) + 2) >> 2)
    j = torch.arange(dn, device=y.device)
    if parity == 0:
        sl, sr = j, (j + 1).clamp(max=sn - 1)
    else:
        sl, sr = (j - 1).clamp(min=0), j.clamp(max=sn - 1)
    d = d + ((s.index_select(axis, sl) + s.index_select(axis, sr)) >> 1)
    out = torch.empty_like(y)
    out.index_copy_(axis, torch.arange(parity, n, 2, device=y.device), s)
    out.index_copy_(axis, torch.arange(1 - parity, n, 2, device=y.device), d)
    return out


def dwt53_inv_level_plain(plane, h, w, py, px):
    sub = _inv53_axis(plane[:h, :w], 1, px)
    plane[:h, :w] = _inv53_axis(sub, 0, py)


# ============================================= K-h: inverse RCT + DC + clip
def rct_inv_dc_clip(planes: list[torch.Tensor], dcs: list[int],
                    ranges: list[tuple[int, int]], rct: bool) -> list[torch.Tensor]:
    """In place: inverse RCT on the first three planes when ``rct`` (g = y -
    ((cb + cr) >> 2), r = cr + g, b = cb + g), then ``plane + dc`` clipped
    to ``ranges[c]`` = (lo, hi) on every plane. Returns the planes."""
    dev = planes[0].device
    for i, p in enumerate(planes):
        _check_plane(p, f"plane {i}")
        if p.device != dev:
            raise ValueError("all planes must share one device")
    if rct and (len(planes) < 3 or not planes[0].shape == planes[1].shape == planes[2].shape):
        raise ValueError("RCT needs three equally-sized planes")
    if dev.type == "cpu":
        return rct_inv_dc_clip_plain(planes, dcs, ranges, rct)
    if dev.type != "cuda":
        raise ValueError(f"rct_inv_dc_clip: unsupported device {dev}")
    k = kernels.KERNELS["rct_inv_dc_clip"]
    stream = kernels.stream_ptr(dev)
    first = 0
    if rct:
        k.call(*(p.data_ptr() for p in planes[:3]), planes[0].numel(),
               *(v for c in range(3) for v in (dcs[c], *ranges[c])), 1, stream)
        first = 3
    for c in range(first, len(planes)):
        k.call(planes[c].data_ptr(), None, None, planes[c].numel(), dcs[c], *ranges[c],
               0, 0, 0, 0, 0, 0, 0, stream)
    return planes


def rct_inv_dc_clip_plain(planes, dcs, ranges, rct):
    if rct:
        y, cb, cr = (p.clone() for p in planes[:3])
        g = y - ((cb + cr) >> 2)
        planes[0].copy_(cr + g)
        planes[1].copy_(g)
        planes[2].copy_(cb + g)
    for p, dc, (lo, hi) in zip(planes, dcs, ranges):
        p.copy_((p + dc).clamp(lo, hi))
    return planes


def inverse_transform(planes: list[torch.Tensor], rects: list[Rect], num_levels: list[int],
                      precs: list[int], signeds: list[bool], rct: bool) -> list[torch.Tensor]:
    """Inverse 5/3 of every level, coarsest first, then inverse RCT, DC
    shift and clip, in place on a tile's Mallat-packed int32 planes;
    returns the component samples."""
    for plane, rect, nl in zip(planes, rects, num_levels):
        chain = [rect]
        for _ in range(nl):
            chain.append(chain[-1].ceil_div_pow2(1))
        for cur in reversed(chain[:nl]):
            if cur.height and cur.width:
                dwt53_inv_level(plane, cur.height, cur.width, cur.y0 & 1, cur.x0 & 1)
    dcs = [0 if s else 1 << (p - 1) for p, s in zip(precs, signeds)]
    ranges = [(-(1 << (p - 1)), (1 << (p - 1)) - 1) if s else (0, (1 << p) - 1)
              for p, s in zip(precs, signeds)]
    return rct_inv_dc_clip(planes, dcs, ranges, rct)
