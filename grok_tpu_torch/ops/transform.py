"""Transform chains, forward and inverse: DC level shift, RCT and
multi-level 5/3 lifting (reversible), or ICT, multi-level 9/7 lifting and
dead-zone quantization (irreversible), Mallat-packed.

Counterpart of grok_tpu/ops/jax_pipeline.py make_forward_fn (:43-111) and
make_inverse_fn (:144-223) over ops/mct.py (dc shift :64, rct_forward :33,
rct_inverse :41, ict_forward :48, ict_inverse :56) and ops/dwt.py
(fwd53_axis :112, inv53_axis :128, fwd97_axis :148, inv97_axis :172,
forward :259, inverse :285), held to grok_tpu's default host path
(tile/tile_processor.py:280-390 and :1340-1660 over native/pipeline.cpp),
with the Part-2 MCT (make_forward_fn :70-79, make_inverse_fn :192-197)
and the ROI maxshift (:103-108, :168-176).
Fourteen kernels live here, each beside its plain torch version, and the
horizontal halves of K-b, K-g, K-k and K-n alone, which the sharded strip
wavelet runs (grok_tpu_torch/parallel/mesh.py):

- reversible: K-a ``dc_rct_fwd`` (csrc/dc_rct.cu), K-b ``dwt53_fwd_level``
  (csrc/dwt53.cu), K-g ``dwt53_inv_level`` (csrc/dwt53_inv.cu) and K-h
  ``rct_inv_dc_clip`` (csrc/rct_inv.cu), all int32 with arithmetic right
  shifts;
- the wavelet levels of K-b, K-g, K-k and K-n run one launch a level out
  of place, through ``dwt53_fwd_levels``, ``dwt53_inv_levels``,
  ``dwt97_fwd_levels`` and ``dwt97_inv_levels`` (``fwd_ping_pong``,
  ``inv_ping_pong``); K-l and K-m one launch a tile over its components
  (``quant_plan``);
- irreversible: K-j ``dc_ict_fwd`` (csrc/dc_ict.cu), K-k
  ``dwt97_fwd_level`` and K-n ``dwt97_inv_level`` (csrc/dwt97.cu), K-l
  ``quant_deadzone`` and K-m ``dequant_midbin`` (csrc/quant97.cu) and K-o
  ``ict_inv_dc_round_clip`` (csrc/ict_inv.cu), float32 with every product
  and every sum rounded on its own, as the host path computes them (the
  kernels are built with -fmad=false and write __fmul_rn/__fadd_rn; the
  plain versions are one tensor op per product and per sum, which neither
  the CPU nor the card contracts).

- the Part-2 MCT: K-r ``dc_mct_fwd`` and K-s ``mct_inv_round_clip``
  (csrc/mct_custom.cu), float32 fused multiply-add chains in k order, as
  numpy's float32 matmul of the host path computes them (explicit
  __fmaf_rn; the plain versions round each fused step once, from float64),
  one launch a call with the planes' addresses and the per-component
  constants by value in the kernel's parameters and the matrix on the card
  once per distinct matrix (``_mct_matrix``);
- the ROI maxshift: K-t ``roi_up`` and ``roi_down`` (csrc/roi.cu), int32.

A wrapper takes the plain version only for CPU tensors; CUDA tensors
launch the kernel. So the kernels and their plain versions are bit-exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..core.errors import UnsupportedFeatureError
from ..core.rect import Rect


def _check_plane(t: torch.Tensor, name: str, dtype=torch.int32) -> None:
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous 2-d {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _check_planes(planes: list[torch.Tensor], three: bool, dtype=torch.int32) -> torch.device:
    """The planes' common device; ``three``: the first three planes must
    have one shape (RCT or ICT)."""
    dev = planes[0].device
    for i, p in enumerate(planes):
        _check_plane(p, f"plane {i}", dtype)
        if p.device != dev:
            raise ValueError("all planes must share one device")
    if three and (len(planes) < 3 or not planes[0].shape == planes[1].shape == planes[2].shape):
        raise ValueError("a colour transform needs three equally-sized planes")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _launch_dc_colour(name: str, planes: list[torch.Tensor], dcs: list[int], three: bool,
                      dtype: torch.dtype) -> list[torch.Tensor]:
    """K-a or K-j on CUDA planes: new ``dtype`` planes, the first three in
    one launch when ``three``, each other plane alone (the two kernels take
    the same arguments)."""
    outs = [torch.empty(p.shape, dtype=dtype, device=p.device) for p in planes]
    k = kernels.KERNELS[name]
    stream = kernels.stream_ptr(planes[0].device)
    first = 0
    if three:
        k.call(*(p.data_ptr() for p in planes[:3]), *(o.data_ptr() for o in outs[:3]),
               planes[0].numel(), dcs[0], dcs[1], dcs[2], 1, stream)
        first = 3
    for c in range(first, len(planes)):
        k.call(planes[c].data_ptr(), None, None, outs[c].data_ptr(), None, None,
               planes[c].numel(), dcs[c], 0, 0, 0, stream)
    return outs


# ============================================= K-a: DC shift + RCT
def dc_rct_fwd(planes: list[torch.Tensor], dcs: list[int], rct: bool) -> list[torch.Tensor]:
    """New int32 planes: ``planes[c] - dcs[c]``, then RCT on the first
    three when ``rct`` (y = (r + 2g + b) >> 2, cb = b - g, cr = r - g)."""
    if _check_planes(planes, rct).type == "cpu":
        return dc_rct_fwd_plain(planes, dcs, rct)
    return _launch_dc_colour("dc_rct_fwd", planes, dcs, rct, torch.int32)


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
    parities (y0 & 1, x0 & 1) (on the card K-b writes a scratch region,
    copied back)."""
    _level_in_place("dwt53_fwd_level", dwt53_fwd_level_plain, torch.int32, True, plane, h, w,
                    py, px)


def dwt53_fwd_levels(plane: torch.Tensor, levels) -> torch.Tensor:
    """The forward 5/3 of ``levels`` (h, w, py, px), finest first, on an
    int32 plane: the tensor that holds the result, the plane itself on the
    CPU (in place), a new one on the card (one K-b launch a level, the plane
    left as it was)."""
    return _run_levels("dwt53_fwd_level", dwt53_fwd_level_plain, fwd_ping_pong, torch.int32,
                       plane, levels)


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


# ============================================= the horizontal halves alone
# The strip wavelet's horizontal passes (grok_tpu_torch/parallel/mesh.py):
# K-b's and K-g's here, K-k's and K-n's (dwt97_fwd_h, dwt97_inv_h) below.
# All four live in csrc/strip_h.cu. Each has two forms, counted apart in
# kernels.form_counts(): "smem" stages whole lines in shared memory and works
# in place, up to MAX_LINE samples (H_MAX_LINE); "scratch" takes a line of
# any length through a compact scratch. The line length and the lines a
# launch pick the form (h_form). A launch takes up to H_MAX_PLANES planes.
MAX_LINE = 50 * 1024
SHORT_LINE = 4096  # the longest line a "smem" block of either half lifts as one of several
# A launch of lines past SHORT_LINE takes "scratch" when they number fewer
# than the card's SMs over FEW_LINES_DIV: a "smem" block lifts such a line
# alone (about 0.4 ns a sample in a block of either half, on an H100), so
# a few lines leave SMs idle. The 9/7 "scratch" form costs six
# launches, so it won only on 2 lines of 51,200 samples, and "smem" from 8
# lines of 16,384 up (chip_smoke.py check_form_choice times both forms on
# such launches).
FEW_LINES_DIV = {"dwt53": 5, "dwt97": 33}
H_FORMS = ("smem", "scratch")
H_MAX_PLANES = 8  # planes a launch of a horizontal half (csrc/strip_h.cu H_PLANES)


def h_form(name: str, w: int, lines: int, sms: int) -> str:
    """The form of a launch of horizontal half ``name`` over ``lines`` lines
    of ``w`` samples on a card of ``sms`` SMs: "smem" up to MAX_LINE
    samples, unless the lines are longer than SHORT_LINE and fewer than
    sms / FEW_LINES_DIV; else "scratch", which spreads every sample over
    the card."""
    if w > MAX_LINE or (w > SHORT_LINE and lines * FEW_LINES_DIV[name[:5]] < sms):
        return "scratch"
    return "smem"


@functools.cache
def sm_count(dev: torch.device) -> int:
    """The SMs of CUDA device ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def h_lines(planes: list, h: int) -> int:
    """The lines of one launch of a horizontal half over ``planes`` (h rows
    each): a launch takes up to H_MAX_PLANES planes at once."""
    return h * min(len(planes), H_MAX_PLANES)


def _h_planes(planes, dtype, h: int, w: int) -> list[torch.Tensor]:
    """``planes`` (a plane, or a list of planes of one shape on one device)
    as a list, checked to hold an h x w region."""
    planes = list(planes) if isinstance(planes, (list, tuple)) else [planes]
    for i, p in enumerate(planes):
        _check_plane(p, f"plane {i}", dtype)
        if p.device != planes[0].device or p.shape != planes[0].shape:
            raise ValueError("the planes of a horizontal half share one device and one shape")
    if planes and (h > planes[0].shape[0] or w > planes[0].shape[1]):
        raise ValueError("level region exceeds the plane")
    if planes and planes[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {planes[0].device}")
    return planes


def _h_half(name: str, plain, planes, h: int, w: int, px: int, dtype) -> None:
    planes = _h_planes(planes, dtype, h, w)
    if not planes or h == 0 or w == 0:
        return
    if planes[0].device.type == "cpu":
        for p in planes:
            plain(p, h, w, px)
        return
    form = h_form(name, w, h_lines(planes, h), sm_count(planes[0].device))
    launch_h(name, planes, h, w, px, form)


def launch_h(name: str, planes: list[torch.Tensor], h: int, w: int, px: int,
             form: str) -> None:
    """Horizontal half ``name`` (dwt53_fwd_h, dwt53_inv_h, dwt97_fwd_h or
    dwt97_inv_h) in ``form`` on CUDA planes of one shape, in place on the
    top-left h x w of each, one launch for up to H_MAX_PLANES planes.
    "scratch" takes any length (it allocates h * w samples a plane); "smem"
    past MAX_LINE raises."""
    if form not in H_FORMS:
        raise ValueError(f"{name}: no form {form!r}")
    k = kernels.KERNELS[name]
    dev, dtype, ld = planes[0].device, planes[0].dtype, planes[0].stride(0)
    stream = kernels.stream_ptr(dev)

    for i in range(0, len(planes), H_MAX_PLANES):
        group = planes[i:i + H_MAX_PLANES]
        ptrs = np.array([p.data_ptr() for p in group], dtype=np.int64)
        tmp = (torch.empty(len(group) * h * w, dtype=dtype, device=dev) if form == "scratch"
               else None)
        k.call(ptrs.ctypes.data, len(group), ld, h, w, px,
               None if tmp is None else tmp.data_ptr(), stream, form=form)


def dwt53_fwd_h(planes, h: int, w: int, px: int) -> None:
    """K-b's horizontal pass alone, in place: each row of the top-left
    h x w of a plane becomes [low | high] (origin parity px). ``planes``: an
    int32 plane, or a list of planes of one shape on one device (on a card,
    one launch for up to H_MAX_PLANES of them)."""
    _h_half("dwt53_fwd_h", dwt53_fwd_h_plain, planes, h, w, px, torch.int32)


def dwt53_fwd_h_plain(plane, h, w, px):
    plane[:h, :w] = _fwd53_axis(plane[:h, :w], 1, px)


def dwt53_inv_h(planes, h: int, w: int, px: int) -> None:
    """K-g's horizontal pass alone, in place: each [low | high] row of the
    top-left h x w of a plane back to natural order; ``planes`` as for
    dwt53_fwd_h."""
    _h_half("dwt53_inv_h", dwt53_inv_h_plain, planes, h, w, px, torch.int32)


def dwt53_inv_h_plain(plane, h, w, px):
    plane[:h, :w] = _inv53_axis(plane[:h, :w], 1, px)


# ============================================= the chain
def _levels(rect: Rect, nl: int) -> list[Rect]:
    """The rect of each decomposition level, finest first, stopping at an
    empty one."""
    out = []
    cur = rect
    for _ in range(nl):
        if cur.height == 0 or cur.width == 0:
            break
        out.append(cur)
        cur = cur.ceil_div_pow2(1)
    return out


def forward_transform(planes: list[torch.Tensor], rects: list[Rect], num_levels: list[int],
                      dcs: list[int], mct: bool, irreversible: bool = False,
                      bands: list[list[tuple]] | None = None, rois: list[int] | None = None,
                      custom=None) -> list[torch.Tensor]:
    """DC shift, colour transform (RCT or ICT when ``mct``, or the Part-2
    MCT with the float32 [N, N] encoding matrix ``custom``, 9/7 only) and
    multi-level 5/3 or 9/7 of a tile's components; returns the
    Mallat-packed int32 coefficient planes (resolution r occupies the
    top-left ceil(rect / 2^(NL-r))). 9/7 coefficients are quantized per
    band: ``bands[c]`` lists component c's (oy, ox, h, w, step) in the
    packed plane. A component with ``rois[c]`` > 0 is upshifted by it
    (ROI maxshift)."""
    if not irreversible:
        if custom is not None:
            raise ValueError("the Part-2 MCT takes the irreversible transform")
        out = dc_rct_fwd(planes, dcs, mct)
    else:
        out = dc_ict_fwd(planes, dcs, mct) if custom is None else dc_mct_fwd(planes, dcs, custom)
    out = [(dwt97_fwd_levels if irreversible else dwt53_fwd_levels)(
               plane, [(r.height, r.width, r.y0 & 1, r.x0 & 1) for r in _levels(rect, nl)])
           for plane, rect, nl in zip(out, rects, num_levels)]
    if irreversible:
        out = quant_deadzone(out, bands)
    for plane, s in zip(out, rois or ()):
        if s:
            roi_up(plane, s)
    return out


# ============================================= wavelet levels out of place
def _check_levels(name: str, plane: torch.Tensor, levels, dtype) -> torch.device:
    """The device of a ``dtype`` plane that holds every level (h, w, ...)."""
    _check_plane(plane, "plane", dtype)
    for h, w, *_ in levels:
        if h > plane.shape[0] or w > plane.shape[1]:
            raise ValueError("level region exceeds the plane")
    dev = plane.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def level_launcher(name: str, dev: torch.device):
    """The launch of K-b, K-g, K-k or K-n (kernel ``name``) on ``dev``'s
    current stream, ``launch(a, b, c, h, w, py, px)``. The inverses (K-g,
    K-n): the level of the packed ``a`` (its LL quadrant) and ``b`` (the
    rest) into ``c`` in natural order. The forwards (K-b, K-k): the level of
    the natural-order ``a`` into the packed ``b`` (its LL quadrant) and
    ``c`` (the rest). Neither output may overlap an input."""
    call, stream = kernels.KERNELS[name].call, kernels.stream_ptr(dev)

    def launch(a, b, c, h, w, py, px):
        call(a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), c.data_ptr(), c.stride(0),
             h, w, py, px, stream)
    return launch


def fwd_ping_pong(plane: torch.Tensor, levels, launch) -> torch.Tensor:
    """The forward launches over ``levels`` (h, w, py, px), finest first,
    each out of place: level i reads its natural-order input from level
    i - 1's LL quadrant (the plane for the first) and writes its detail
    bands to the buffer returned, its LL quadrant to the next level's input:
    two scratches in turns, the first the size of the second level, the
    other of the third; the last level's LL quadrant goes to the buffer
    returned too. The plane is only read; a plane larger than the first
    level keeps its outside in the buffer returned."""
    h0, w0 = levels[0][:2]
    out = plane.new_empty(plane.shape) if (h0, w0) == tuple(plane.shape) else plane.clone()
    tmps = [plane.new_empty(lv[:2]) for lv in levels[1:3]]
    src = plane
    for i, (h, w, py, px) in enumerate(levels):
        ll = out if i == len(levels) - 1 else tmps[i % 2]
        launch(src, ll, out, h, w, py, px)
        src = ll
    return out


def inv_ping_pong(plane: torch.Tensor, levels, launch) -> torch.Tensor:
    """The inverse launches over ``levels`` (h, w, py, px), coarsest first,
    each out of place: level i reads its LL quadrant from level i - 1's
    output (the plane for the first) and its other bands from the plane, and
    writes one of two buffers: the finest level the one returned, the
    levels before it in turns that one and a scratch the size of the
    second-finest level. A plane larger than the finest level keeps its
    outside in the buffer returned."""
    h0, w0 = levels[-1][:2]
    out = plane.new_empty(plane.shape) if (h0, w0) == tuple(plane.shape) else plane.clone()
    tmp = plane.new_empty(levels[-2][:2]) if len(levels) > 1 else None
    ll = plane
    for i, (h, w, py, px) in enumerate(levels):
        dst = out if (len(levels) - 1 - i) % 2 == 0 else tmp
        launch(ll, plane, dst, h, w, py, px)
        ll = dst
    return out


def _run_levels(name: str, plain, ping_pong, dtype, plane: torch.Tensor,
                levels) -> torch.Tensor:
    """Kernel ``name``'s ``levels`` (h, w, py, px) on ``plane`` in the
    order given: the tensor that holds the result, the plane itself on the
    CPU (``plain`` in place, a level at a time), a new one on the card (one
    launch a level through ``ping_pong``, the plane left as it was)."""
    levels = [lv for lv in levels if lv[0] and lv[1]]
    dev = _check_levels(name, plane, levels, dtype)
    if not levels:
        return plane
    if dev.type == "cpu":
        for lv in levels:
            plain(plane, *lv)
        return plane
    return ping_pong(plane, levels, level_launcher(name, dev))


def _level_in_place(name: str, plain, dtype, fwd: bool, plane: torch.Tensor, h: int, w: int,
                    py: int, px: int) -> None:
    """One level of kernel ``name`` in place: ``plain`` on the CPU; on the
    card one launch into a scratch region, copied back."""
    dev = _check_levels(name, plane, [(h, w)], dtype)
    if h == 0 or w == 0:
        return
    if dev.type == "cpu":
        plain(plane, h, w, py, px)
        return
    out = plane.new_empty((h, w))
    level_launcher(name, dev)(plane, out if fwd else plane, out, h, w, py, px)
    plane[:h, :w].copy_(out)


# ============================================= K-g: one inverse 5/3 level
def dwt53_inv_level(plane: torch.Tensor, h: int, w: int, py: int, px: int) -> None:
    """One inverse 5/3 level, in place: the Mallat-packed top-left h x w
    of ``plane`` ([[LL, HL], [LH, HH]]) becomes natural order; py/px are
    the level rect's origin parities (on the card K-g writes a scratch
    region, copied back)."""
    _level_in_place("dwt53_inv_level", dwt53_inv_level_plain, torch.int32, False, plane, h, w,
                    py, px)


def dwt53_inv_levels(plane: torch.Tensor, levels) -> torch.Tensor:
    """The inverse 5/3 of ``levels`` (h, w, py, px), coarsest first, on an
    int32 plane: the tensor that holds the result, the plane itself on the
    CPU (in place), a new one on the card (one K-g launch a level, the plane
    left as it was)."""
    return _run_levels("dwt53_inv_level", dwt53_inv_level_plain, inv_ping_pong, torch.int32,
                       plane, levels)


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
    dev = _check_planes(planes, rct)
    if dev.type == "cpu":
        return rct_inv_dc_clip_plain(planes, dcs, ranges, rct)
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
                      precs: list[int], signeds: list[bool], mct: bool,
                      irreversible: bool = False,
                      bands: list[list[tuple]] | None = None, rois: list[int] | None = None,
                      custom=None, offsets: list[float] | None = None) -> list[torch.Tensor]:
    """Inverse of ``forward_transform`` on a tile's Mallat-packed int32
    planes: (the ROI downshift of a component with ``rois[c]`` > 0, in
    place; 9/7: mid-bin dequantization per band,) the inverse 5/3 or 9/7
    of every level, coarsest first, then the inverse colour transform (or,
    9/7 only, the Part-2 MCT with the float32 [N, N] decoding matrix
    ``custom`` and the stream's ``offsets`` in place of the DC shifts), DC
    shift, rounding and clip; returns the int32 component samples (on the
    CPU the 5/3 chain works in place)."""
    dcs = [0 if s else 1 << (p - 1) for p, s in zip(precs, signeds)]
    ranges = [(-(1 << (p - 1)), (1 << (p - 1)) - 1) if s else (0, (1 << p) - 1)
              for p, s in zip(precs, signeds)]
    for plane, s in zip(planes, rois or ()):
        if s:
            roi_down(plane, s)
    if irreversible:
        planes = dequant_midbin(planes, bands)
    elif custom is not None:
        raise ValueError("the Part-2 MCT takes the irreversible transform")
    else:
        planes = list(planes)  # the caller's list stays as it was
    for c, (rect, nl) in enumerate(zip(rects, num_levels)):
        levels = [(r.height, r.width, r.y0 & 1, r.x0 & 1) for r in reversed(_levels(rect, nl))]
        planes[c] = (dwt97_inv_levels if irreversible else dwt53_inv_levels)(planes[c], levels)
    if custom is not None:
        return mct_inv_round_clip(planes, custom, dcs if offsets is None else offsets, ranges)
    if irreversible:
        return ict_inv_dc_round_clip(planes, dcs, ranges, mct)
    return rct_inv_dc_clip(planes, dcs, ranges, mct)


# ============================================= 9/7 constants
# T.800 F.4.8.2 lifting constants and the ICT matrices (T.800 G-1/G-2),
# rounded to float32 as the host path uses them (ops/dwt.py:29-33 under
# numpy's weak scalar promotion; ops/mct.py:15, :23; native/pipeline.cpp:28-33)
def _f32(v: float) -> float:
    return float(np.float32(v))


LIFT97 = tuple(_f32(v) for v in (-1.586134342059924, -0.052980118572961, 0.882911075530934,
                                 0.443506852043971, 1.230174104914001, 1.0 / 1.230174104914001))
ALPHA, BETA, GAMMA, DELTA, K97, INV_K97 = LIFT97
ICT_FWD = tuple(tuple(_f32(v) for v in row) for row in (
    (0.299, 0.587, 0.114), (-0.168736, -0.331264, 0.5), (0.5, -0.418688, -0.081312)))
ICT_INV = tuple(tuple(_f32(v) for v in row) for row in (
    (1.0, 0.0, 1.402), (1.0, -0.344136, -0.714136), (1.0, 1.772, 0.0)))


# ============================================= K-j: DC shift + ICT
def dc_ict_fwd(planes: list[torch.Tensor], dcs: list[int], ict: bool) -> list[torch.Tensor]:
    """New float32 planes: ``float(planes[c] - dcs[c])``, then the ICT on
    the first three when ``ict`` (y = m00 r + m01 g + m02 b, ..., each
    product and each sum rounded)."""
    if _check_planes(planes, ict).type == "cpu":
        return dc_ict_fwd_plain(planes, dcs, ict)
    return _launch_dc_colour("dc_ict_fwd", planes, dcs, ict, torch.float32)


def _dot3(m: tuple, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """m[0] a + m[1] b + m[2] c, left to right, skipping zero terms as the
    host path does (one tensor op per product and per sum)."""
    out = None
    for w, v in zip(m, (a, b, c)):
        if w == 0.0:
            continue
        t = v if w == 1.0 else v * w
        out = t if out is None else out + t
    return out


def dc_ict_fwd_plain(planes, dcs, ict):
    shifted = [(p - dc).to(torch.float32) for p, dc in zip(planes, dcs)]
    if ict:
        r, g, b = shifted[:3]
        shifted[:3] = [_dot3(row, r, g, b) for row in ICT_FWD]
    return shifted


# ============================================= K-k: one 9/7 level
def dwt97_fwd_level(plane: torch.Tensor, h: int, w: int, py: int, px: int) -> None:
    """One forward 9/7 level, in place on a float32 plane: the top-left
    h x w becomes [[LL, HL], [LH, HH]]; py/px are the level rect's origin
    parities. A line of one sample is left as it is (on the card K-k writes
    a scratch region, copied back)."""
    _level_in_place("dwt97_fwd_level", dwt97_fwd_level_plain, torch.float32, True, plane, h, w,
                    py, px)


def dwt97_fwd_levels(plane: torch.Tensor, levels) -> torch.Tensor:
    """The forward 9/7 of ``levels`` (h, w, py, px), finest first, on a
    float32 plane: the tensor that holds the result, the plane itself on the
    CPU (in place), a new one on the card (one K-k launch a level, the plane
    left as it was)."""
    return _run_levels("dwt97_fwd_level", dwt97_fwd_level_plain, fwd_ping_pong, torch.float32,
                       plane, levels)


def _s_nbrs(parity: int, dn: int, sn: int, device):
    """Indices into d of each s sample's left and right neighbour."""
    i = torch.arange(sn, device=device)
    if parity == 0:
        return (i - 1).clamp(min=0), i.clamp(max=dn - 1)
    return i, (i + 1).clamp(max=dn - 1)


def _d_nbrs(parity: int, dn: int, sn: int, device):
    """Indices into s of each d sample's left and right neighbour."""
    j = torch.arange(dn, device=device)
    if parity == 0:
        return j, (j + 1).clamp(max=sn - 1)
    return (j - 1).clamp(min=0), j.clamp(max=sn - 1)


def _lift(x: torch.Tensor, axis: int, nbr, coef: float, sign: int,
          src: torch.Tensor) -> torch.Tensor:
    """x +- coef * (src[l] + src[r]), one rounding per op."""
    left, right = nbr
    t = (src.index_select(axis, left) + src.index_select(axis, right)) * coef
    return x + t if sign > 0 else x - t


def _fwd97_axis(x: torch.Tensor, axis: int, parity: int) -> torch.Tensor:
    n = x.shape[axis]
    if n == 1:
        return x
    s = x.index_select(axis, torch.arange(parity, n, 2, device=x.device))
    d = x.index_select(axis, torch.arange(1 - parity, n, 2, device=x.device))
    sn, dn = s.shape[axis], d.shape[axis]
    dn_ = _d_nbrs(parity, dn, sn, x.device)
    sn_ = _s_nbrs(parity, dn, sn, x.device)
    d = _lift(d, axis, dn_, ALPHA, 1, s)
    s = _lift(s, axis, sn_, BETA, 1, d)
    d = _lift(d, axis, dn_, GAMMA, 1, s)
    s = _lift(s, axis, sn_, DELTA, 1, d)
    return torch.cat([s * INV_K97, d * K97], dim=axis)


def dwt97_fwd_level_plain(plane, h, w, py, px):
    sub = _fwd97_axis(plane[:h, :w], 0, py)
    plane[:h, :w] = _fwd97_axis(sub, 1, px)


# ============================================= K-n: one inverse 9/7 level
def dwt97_inv_levels(plane: torch.Tensor, levels) -> torch.Tensor:
    """The inverse 9/7 of ``levels`` (h, w, py, px), coarsest first, on a
    float32 plane: the tensor that holds the result, the plane itself on the
    CPU (in place), a new one on the card (one K-n launch a level, the plane
    left as it was)."""
    return _run_levels("dwt97_inv_level", dwt97_inv_level_plain, inv_ping_pong, torch.float32,
                       plane, levels)


def dwt97_inv_level(plane: torch.Tensor, h: int, w: int, py: int, px: int) -> None:
    """One inverse 9/7 level, in place on a float32 plane: the
    Mallat-packed top-left h x w becomes natural order (on the card K-n
    writes a scratch region, copied back)."""
    _level_in_place("dwt97_inv_level", dwt97_inv_level_plain, torch.float32, False, plane, h, w,
                    py, px)


def _inv97_axis(y: torch.Tensor, axis: int, parity: int) -> torch.Tensor:
    n = y.shape[axis]
    if n == 1:
        return y
    sn = n // 2 if parity else (n + 1) // 2
    dn = n - sn
    s = y.narrow(axis, 0, sn) * K97
    d = y.narrow(axis, sn, dn) * INV_K97
    dn_ = _d_nbrs(parity, dn, sn, y.device)
    sn_ = _s_nbrs(parity, dn, sn, y.device)
    s = _lift(s, axis, sn_, DELTA, -1, d)
    d = _lift(d, axis, dn_, GAMMA, -1, s)
    s = _lift(s, axis, sn_, BETA, -1, d)
    d = _lift(d, axis, dn_, ALPHA, -1, s)
    out = torch.empty_like(y)
    out.index_copy_(axis, torch.arange(parity, n, 2, device=y.device), s)
    out.index_copy_(axis, torch.arange(1 - parity, n, 2, device=y.device), d)
    return out


def dwt97_inv_level_plain(plane, h, w, py, px):
    sub = _inv97_axis(plane[:h, :w], 1, px)
    plane[:h, :w] = _inv97_axis(sub, 0, py)


def dwt97_fwd_h(planes, h: int, w: int, px: int) -> None:
    """K-k's horizontal pass alone, in place on a float32 plane (or a list,
    as for dwt53_fwd_h: on a card, one launch for up to H_MAX_PLANES)."""
    _h_half("dwt97_fwd_h", dwt97_fwd_h_plain, planes, h, w, px, torch.float32)


def dwt97_fwd_h_plain(plane, h, w, px):
    plane[:h, :w] = _fwd97_axis(plane[:h, :w], 1, px)


def dwt97_inv_h(planes, h: int, w: int, px: int) -> None:
    """K-n's horizontal pass alone, in place on a float32 plane (or a list,
    as for dwt53_fwd_h: on a card, one launch for up to H_MAX_PLANES)."""
    _h_half("dwt97_inv_h", dwt97_inv_h_plain, planes, h, w, px, torch.float32)


def dwt97_inv_h_plain(plane, h, w, px):
    plane[:h, :w] = _inv97_axis(plane[:h, :w], 1, px)


# ============================================= K-l / K-m: band quantization
QUANT_MAX_COMPS, QUANT_MAX_BANDS = 8, 112  # a launch's (csrc/quant97.cu MAX_COMPS, MAX_BANDS)
_QUANT_PLANS: dict = {}


def quant_plan(shapes: list[tuple[int, int]],
               bands: list[list[tuple]]) -> list[tuple[list[int], np.ndarray]]:
    """The launches of K-l or K-m over a tile's planes of ``shapes``, whose
    ``bands[c]`` list plane c's (oy, ox, h, w, step): the components in
    order, as many to a launch as its parameters hold, each launch as (its
    components, int32 [nb, 6]: component within the launch, oy, ox, h, w,
    the float32 step's bits), the bands and planes without samples left
    out. Raises ValueError unless every band lies inside its plane and the
    band areas sum to the plane's. Cached by geometry."""
    key = (tuple(map(tuple, shapes)), tuple(map(tuple, bands)))
    plan = _QUANT_PLANS.get(key)
    if plan is not None:
        return plan
    if len(shapes) != len(bands):
        raise ValueError(f"{len(shapes)} planes but {len(bands)} band lists")
    plan, comps, rows = [], [], []

    def close():
        t = np.array([r[:5] for r in rows], dtype=np.int32)
        steps = np.array([r[5] for r in rows], dtype=np.float32).view(np.int32)
        plan.append((comps, np.ascontiguousarray(np.column_stack([t, steps]))))

    for c, ((ph, pw), bs) in enumerate(zip(shapes, bands)):
        for oy, ox, h, w, _ in bs:
            if min(oy, ox, h, w) < 0 or oy + h > ph or ox + w > pw:
                raise ValueError(f"band {(oy, ox, h, w)} lies outside plane {c} ({ph}x{pw})")
        area = sum(h * w for _, _, h, w, _ in bs)
        if area != ph * pw:
            raise ValueError(f"the bands of plane {c} cover {area} samples of its {ph * pw}")
        live = [b for b in bs if b[2] and b[3]]
        if len(live) > QUANT_MAX_BANDS:
            raise ValueError(f"plane {c} has {len(live)} bands, a launch takes "
                             f"{QUANT_MAX_BANDS}")
        if not live:
            continue
        if comps and (len(comps) == QUANT_MAX_COMPS or len(rows) + len(live) > QUANT_MAX_BANDS):
            close()
            comps, rows = [], []
        rows += [(len(comps), *b) for b in live]
        comps.append(c)
    if comps:
        close()
    if len(_QUANT_PLANS) >= 256:
        _QUANT_PLANS.clear()
    _QUANT_PLANS[key] = plan
    return plan


def _empty_aligned_as(plane: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised 4-byte ``dtype`` tensor of plane's shape whose
    address equals plane's modulo 16, so K-l and K-m move both in 16-byte
    quads."""
    if plane.data_ptr() % 16 == 0:  # the allocator's blocks are aligned
        return torch.empty(plane.shape, dtype=dtype, device=plane.device)
    n = plane.numel()
    buf = torch.empty(n + 3, dtype=dtype, device=plane.device)
    k = ((plane.data_ptr() - buf.data_ptr()) >> 2) & 3
    return buf[k:k + n].view(plane.shape)


def _band_quant(name: str, plain, planes: list[torch.Tensor], bands: list[list[tuple]],
                src: torch.dtype, dst: torch.dtype) -> list[torch.Tensor]:
    """K-l or K-m over a tile's planes: one launch a group of
    quant_plan, or the plain version plane by plane on the CPU."""
    dev = _check_planes(planes, False, src)
    plan = quant_plan([tuple(p.shape) for p in planes], bands)
    if dev.type == "cpu":
        return [plain(p, b) for p, b in zip(planes, bands)]
    outs = [_empty_aligned_as(p, dst) for p in planes]  # the bands write every sample
    k, stream = kernels.KERNELS[name], kernels.stream_ptr(dev)
    for comps, table in plan:
        ptrs = np.array([(planes[c].data_ptr(), outs[c].data_ptr(), planes[c].shape[1])
                         for c in comps], dtype=np.int64)
        k.call(ptrs.ctypes.data, table.ctypes.data, len(comps), len(table), stream)
    return outs


def quant_deadzone(planes: list[torch.Tensor], bands: list[list[tuple]]) -> list[torch.Tensor]:
    """Dead-zone quantization of a tile's packed float32 planes: int32
    sign(v) * floor(|v| / step) with each band's float32 step; ``bands[c]``
    lists plane c's (oy, ox, h, w, step) and must tile it."""
    return _band_quant("quant_deadzone", quant_deadzone_plain, planes, bands, torch.float32,
                       torch.int32)


def quant_deadzone_plain(plane, bands):
    out = torch.zeros(plane.shape, dtype=torch.int32, device=plane.device)
    for oy, ox, bh, bw, step in bands:
        v = plane[oy:oy + bh, ox:ox + bw]
        # a tensor divisor: CUDA divides by a scalar as a product with its
        # reciprocal, which is not IEEE division
        q = torch.floor(v.abs() / torch.full_like(v, step)).to(torch.int32)
        out[oy:oy + bh, ox:ox + bw] = torch.where(v < 0, -q, q)
    return out


def dequant_midbin(planes: list[torch.Tensor], bands: list[list[tuple]]) -> list[torch.Tensor]:
    """Mid-bin dequantization of a tile's packed int32 planes: float32
    sign(q) * (|q| + 0.5) * step, 0 for q = 0, with each band's float32
    step; ``bands[c]`` lists plane c's (oy, ox, h, w, step) and must tile
    it."""
    return _band_quant("dequant_midbin", dequant_midbin_plain, planes, bands, torch.int32,
                       torch.float32)


def dequant_midbin_plain(plane, bands):
    out = torch.zeros(plane.shape, dtype=torch.float32, device=plane.device)
    for oy, ox, bh, bw, step in bands:
        q = plane[oy:oy + bh, ox:ox + bw]
        mag = q.abs().to(torch.float32)
        rec = torch.where(mag > 0, (mag + 0.5) * _f32(step), 0.0)
        out[oy:oy + bh, ox:ox + bw] = torch.where(q < 0, -rec, rec)
    return out


# ============================================= K-o: inverse ICT + DC + round + clip
def ict_inv_dc_round_clip(planes: list[torch.Tensor], dcs: list[int],
                          ranges: list[tuple[int, int]], ict: bool) -> list[torch.Tensor]:
    """New int32 planes from float32 ones: the inverse ICT on the first
    three when ``ict`` (r = y + 1.402 cr, g = y - 0.344136 cb - 0.714136 cr,
    b = y + 1.772 cb), then floor(v + float32(0.5 + dc)) clipped to
    ``ranges[c]``; NaN gives the low end (native/pipeline.cpp:597-611)."""
    dev = _check_planes(planes, ict, torch.float32)
    if dev.type == "cpu":
        return ict_inv_dc_round_clip_plain(planes, dcs, ranges, ict)
    outs = [torch.empty(p.shape, dtype=torch.int32, device=dev) for p in planes]
    k = kernels.KERNELS["ict_inv_dc_round_clip"]
    stream = kernels.stream_ptr(dev)
    adds = [_f32(0.5 + dc) for dc in dcs]
    first = 0
    if ict:
        k.call(*(p.data_ptr() for p in planes[:3]), *(o.data_ptr() for o in outs[:3]),
               planes[0].numel(), *(v for c in range(3) for v in (adds[c], *ranges[c])),
               1, stream)
        first = 3
    for c in range(first, len(planes)):
        k.call(planes[c].data_ptr(), None, None, outs[c].data_ptr(), None, None,
               planes[c].numel(), adds[c], *ranges[c], 0.0, 0, 0, 0.0, 0, 0, 0, stream)
    return outs


def ict_inv_dc_round_clip_plain(planes, dcs, ranges, ict):
    vals = list(planes)
    if ict:
        y, cb, cr = planes[:3]
        vals[:3] = [_dot3(row, y, cb, cr) for row in ICT_INV]
    outs = []
    for v, dc, (lo, hi) in zip(vals, dcs, ranges):
        f = torch.floor(v + _f32(0.5 + dc))
        f = torch.where(f > lo, f, float(lo))  # NaN -> lo
        outs.append(torch.where(f > hi, float(hi), f).to(torch.int32))
    return outs


# ============================================= K-r / K-s: the Part-2 custom MCT
# one MCT marker segment holds at most 127 x 127 float32 elements: the
# reference writes no larger matrix (markers.py write_mct_markers)
MCT_MAX_COMPS = 127


def _mct_args(planes: list[torch.Tensor], matrix, dtype) -> tuple[torch.device, np.ndarray]:
    """The planes' device and ``matrix`` as a float32 [N, N] numpy array;
    N must be the number of planes, which share one shape."""
    dev = _check_planes(planes, False, dtype)
    if isinstance(matrix, torch.Tensor):
        matrix = matrix.cpu()
    m = np.ascontiguousarray(matrix, dtype=np.float32)
    n = len(planes)
    if m.shape != (n, n):
        raise ValueError(f"the Part-2 MCT of {n} components needs an {n} x {n} matrix, "
                         f"got {tuple(m.shape)}")
    if n > MCT_MAX_COMPS:
        raise UnsupportedFeatureError(
            f"outside the ported slices: a Part-2 MCT of more than {MCT_MAX_COMPS} components")
    if any(p.shape != planes[0].shape for p in planes):
        raise ValueError("the Part-2 MCT needs equally-sized planes")
    return dev, m


_MCT_MATRICES: dict = {}


def _mct_matrix(m: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The float32 matrix ``m`` on the card ``dev``: uploaded once per
    distinct matrix, then found by its bytes."""
    key = (dev, m.tobytes())
    t = _MCT_MATRICES.get(key)
    if t is None:
        if len(_MCT_MATRICES) >= 64:
            _MCT_MATRICES.clear()
        t = _MCT_MATRICES[key] = torch.from_numpy(m.copy()).to(dev)
    return t


def _mct_launch(name: str, planes: list[torch.Tensor], outs: list[torch.Tensor],
                m: np.ndarray, *per: np.ndarray) -> None:
    """K-r or K-s: one launch, the plane addresses and the per-component
    arrays ``per`` (N 4-byte values each) by value in its parameters, the
    matrix from ``_mct_matrix`` (csrc/mct_custom.cu)."""
    dev = planes[0].device
    ptrs = np.array([p.data_ptr() for p in planes] + [o.data_ptr() for o in outs],
                    dtype=np.int64)
    kernels.KERNELS[name].call(
        ptrs.ctypes.data, _mct_matrix(m, dev).data_ptr(), *(a.ctypes.data for a in per),
        planes[0].numel(), len(planes), kernels.stream_ptr(dev))


def _fma32(w: float, x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32 fma(w, x, acc), rounded once, from float64 arithmetic: the
    product is exact in float64; the sum's rounding error (TwoSum) decides
    the one case where rounding the float64 sum again to float32 would
    differ, a float64 sum that lands exactly halfway between two float32s."""
    p = x.double() * w
    c = acc.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    r = s.float()
    d = s - r.double()
    nb = torch.nextafter(r, torch.where(d > 0, torch.full_like(r, float("inf")),
                                        torch.full_like(r, float("-inf"))))
    tie = (d != 0) & (s == (r.double() + nb.double()) * 0.5)
    return torch.where(tie & (err != 0) & ((err > 0) == (d > 0)), nb, r)


def _mct_rows(m: torch.Tensor, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each output m[o, 0] x_0, then fma(m[o, k], x_k, .) for k = 1..N-1:
    numpy's float32 ``matrix @ flat`` (grok_tpu/ops/mct.py:83-89)."""
    outs = []
    for row in m.cpu().tolist():
        acc = (xs[0].double() * row[0]).float()
        for w, x in zip(row[1:], xs[1:]):
            acc = _fma32(w, x, acc)
        outs.append(acc)
    return outs


def dc_mct_fwd(planes: list[torch.Tensor], dcs: list[int], matrix) -> list[torch.Tensor]:
    """K-r: new float32 planes, the Part-2 MCT of ``float(planes[k] -
    dcs[k])`` with the [N, N] encoding ``matrix`` (rounded to float32), each
    output one fused multiply-add chain over k = 0..N-1."""
    dev, m = _mct_args(planes, matrix, torch.int32)
    if dev.type == "cpu":
        return dc_mct_fwd_plain(planes, dcs, m)
    # at the first input's address modulo 16, so that K-r moves quads of all
    # planes in 16-byte loads and stores where the inputs share it too
    outs = [_empty_aligned_as(planes[0], torch.float32) for _ in planes]
    _mct_launch("dc_mct_fwd", planes, outs, m, np.asarray(dcs, dtype=np.int32))
    return outs


def dc_mct_fwd_plain(planes, dcs, matrix):
    m = torch.as_tensor(matrix, dtype=torch.float32)
    return _mct_rows(m, [(p - dc).to(torch.float32) for p, dc in zip(planes, dcs)])


def mct_inv_round_clip(planes: list[torch.Tensor], matrix, offsets: list[float],
                       ranges: list[tuple[int, int]]) -> list[torch.Tensor]:
    """K-s: new int32 planes from float32 ones: the Part-2 MCT with the [N, N]
    decoding ``matrix`` (rounded to float32; the fused chain of K-r), then
    floor(v + float32(0.5 + offsets[c])) clipped to ``ranges[c]``, NaN to
    the low end (native/pipeline.cpp finish_irrev :597-611)."""
    dev, m = _mct_args(planes, matrix, torch.float32)
    if dev.type == "cpu":
        return mct_inv_round_clip_plain(planes, m, offsets, ranges)
    outs = [torch.empty(p.shape, dtype=torch.int32, device=dev) for p in planes]
    add = np.array([0.5 + float(o) for o in offsets], dtype=np.float32)
    lo, hi = (np.array(v, dtype=np.int32) for v in zip(*ranges))
    _mct_launch("mct_inv_round_clip", planes, outs, m, add, lo, hi)
    return outs


def mct_inv_round_clip_plain(planes, matrix, offsets, ranges):
    m = torch.as_tensor(matrix, dtype=torch.float32)
    outs = []
    for v, off, (lo, hi) in zip(_mct_rows(m, list(planes)), offsets, ranges):
        f = torch.floor(v + _f32(0.5 + float(off)))
        f = torch.where(f > lo, f, float(lo))  # NaN -> lo
        outs.append(torch.where(f > hi, float(hi), f).to(torch.int32))
    return outs


# ============================================= K-t: the ROI maxshift
ROI_MAX_SHIFT = 30  # 1 << shift must stay an int32


def _roi(name: str, plain, plane: torch.Tensor, shift: int) -> torch.Tensor:
    _check_plane(plane, "plane")
    if not 1 <= shift <= ROI_MAX_SHIFT:
        raise UnsupportedFeatureError(
            f"outside the ported slices: an ROI shift of {shift} (1..{ROI_MAX_SHIFT})")
    dev = plane.device
    if dev.type == "cpu":
        return plain(plane, shift)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    kernels.KERNELS[name].call(plane.data_ptr(), plane.numel(), shift, kernels.stream_ptr(dev))
    return plane


def roi_up(plane: torch.Tensor, shift: int) -> torch.Tensor:
    """K-t up: ``plane << shift`` in place (int32, wrapping); returns it."""
    return _roi("roi_up", roi_up_plain, plane, shift)


def roi_up_plain(plane, shift):
    return plane.bitwise_left_shift_(shift)


def roi_down(plane: torch.Tensor, shift: int) -> torch.Tensor:
    """K-t down, in place: a magnitude of at least ``1 << shift`` shifts
    down by ``shift``, the sign kept (native/pipeline.cpp roi_unshift);
    returns the plane."""
    return _roi("roi_down", roi_down_plain, plane, shift)


def roi_down_plain(plane, shift):
    mag = plane.abs()
    mag = torch.where(mag >= (1 << shift), mag >> shift, mag)
    return plane.copy_(torch.where(plane < 0, -mag, mag))
