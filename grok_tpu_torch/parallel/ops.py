"""The kernels of K6, each beside its plain torch version: K-u
``strip53_step``/``strip97_step`` and K-v ``strip_pack_v``/``strip_unpack_v``
(csrc/strip_dwt.cu), the vertical half of a level of the Y-sharded strip
wavelet, and K-w ``blk_stats`` (csrc/blk_stats.cu), the block statistics of
the tile-parallel transform.

Counterpart of grok_tpu/parallel/mesh.py: the lifting steps of
_fwd53_v_sharded (:65), _inv53_v_sharded (:93), _fwd97_v_sharded (:146) and
_inv97_v_sharded (:177) with their packing, and make_sharded_transform's
blk_max and psum of distortion (:475-480).

A step works in place on a shard's top-left h x w sub-block, its rows
interleaved (s = rows 0::2, d = rows 1::2). The row past the sub-block's
edge comes from a one-row halo buffer, or at an edge of the mesh (no halo)
from the clamp to the shard's own row. A wrapper takes the plain version
only for CPU tensors; CUDA tensors launch the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..ops.transform import ALPHA, BETA, DELTA, GAMMA, INV_K97, K97

# the four 9/7 steps of a forward level, in order: (update, coefficient);
# the inverse runs them backwards with the opposite sign (mesh.py:168-171,
# :197-200)
STEPS_97 = ((False, ALPHA), (True, BETA), (False, GAMMA), (True, DELTA))


def _check_sub(plane: torch.Tensor, h: int, w: int, dtype, name: str) -> None:
    if plane.dtype != dtype or plane.dim() != 2 or plane.stride(1) != 1:
        raise ValueError(f"{name}: want a 2-d {dtype} shard with unit column stride, got "
                         f"{plane.dtype} {tuple(plane.shape)}")
    if h > plane.shape[0] or w > plane.shape[1] or h % 2:
        raise ValueError(f"{name}: the sub-block {h}x{w} must have even rows inside the shard")
    if plane.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {plane.device}")


def _halo_arg(halo: torch.Tensor | None, plane: torch.Tensor, w: int):
    if halo is None:
        return None
    if halo.device != plane.device or halo.dtype != plane.dtype or halo.numel() < w:
        raise ValueError("the halo must be a row of at least w samples of the shard's type "
                         "on the shard's device")
    return halo.data_ptr()


# ============================================= K-u: one lifting step
def strip53_step(plane: torch.Tensor, h: int, w: int, halo: torch.Tensor | None,
                 update: bool, inverse: bool = False) -> None:
    """One 5/3 lifting step in place on the int32 sub-block plane[:h, :w].
    Predict (update False): d[j] -= (s[j] + s[j+1]) >> 1, s[h/2] being the
    next shard's first s row (``halo``) or, without one, s[h/2 - 1].
    Update: s[i] += (d[i-1] + d[i] + 2) >> 2, d[-1] being the previous
    shard's last d row or d[0]. ``inverse`` undoes the step (+ for -)."""
    _check_sub(plane, h, w, torch.int32, "strip53_step")
    if h == 0 or w == 0:
        return
    if plane.device.type == "cpu":
        strip53_step_plain(plane, h, w, halo, update, inverse)
        return
    kernels.KERNELS["strip53_step"].call(
        plane.data_ptr(), _halo_arg(halo, plane, w), plane.stride(0), h, w, int(update),
        int(inverse), kernels.stream_ptr(plane.device))


def _nbrs(x: torch.Tensor, halo: torch.Tensor | None, update: bool, w: int):
    """(target rows, left source rows, right source rows) of a step."""
    s, d = x[0::2], x[1::2]
    if not update:
        edge = s[-1:] if halo is None else halo[:w].reshape(1, w)
        return d, s, torch.cat([s[1:], edge])
    edge = d[:1] if halo is None else halo[:w].reshape(1, w)
    return s, torch.cat([edge, d[:-1]]), d


def strip53_step_plain(plane, h, w, halo, update, inverse):
    tgt, a, b = _nbrs(plane[:h, :w], halo, update, w)
    p = (a + b + 2) >> 2 if update else (a + b) >> 1
    tgt.copy_(tgt + p if inverse != update else tgt - p)


def strip97_step(plane: torch.Tensor, h: int, w: int, halo: torch.Tensor | None,
                 update: bool, coef: float, inverse: bool = False) -> None:
    """One 9/7 lifting step in place on the float32 sub-block: the target
    phase x becomes x + coef * (a + b), or with ``inverse`` x - coef * (a +
    b), with the neighbours of ``strip53_step``; the sum, the product and
    the add each rounded on their own."""
    _check_sub(plane, h, w, torch.float32, "strip97_step")
    if h == 0 or w == 0:
        return
    if plane.device.type == "cpu":
        strip97_step_plain(plane, h, w, halo, update, coef, inverse)
        return
    kernels.KERNELS["strip97_step"].call(
        plane.data_ptr(), _halo_arg(halo, plane, w), plane.stride(0), h, w, int(update),
        float(coef), int(inverse), kernels.stream_ptr(plane.device))


def strip97_step_plain(plane, h, w, halo, update, coef, inverse):
    tgt, a, b = _nbrs(plane[:h, :w], halo, update, w)
    p = (a + b) * coef
    tgt.copy_(tgt - p if inverse else tgt + p)


# ============================================= K-v: packing
SMEM_BYTES = 232_448  # the shared memory one block can have on Hopper (227 KB)
# the column bands of the one-pass form, in order of preference (chosen on
# the card: PERF.md §6); a band of 8 columns is one 32-byte sector a row
PACK_BANDS = (16, 8)


class PackForm(NamedTuple):
    """How K-v runs on an h x w sub-block: ``form`` "smem" stages a column
    band of ``band`` columns and all h rows in one block's shared memory and
    writes the rows back permuted, in place, in one pass of ``blocks``
    blocks; "two_pass" writes a compact scratch and copies it back."""

    form: str
    band: int
    blocks: int


def pack_form(h: int, w: int) -> PackForm:
    """K-v's form: the first band of PACK_BANDS whose h rows fit a block's
    shared memory (h x band x 4 bytes), else the two-pass form (above 7,264
    rows). The form follows from h alone; w sets the number of bands, the
    last one ragged."""
    for band in PACK_BANDS:
        if h * band * 4 <= SMEM_BYTES:
            return PackForm("smem", band, -(-w // band))
    return PackForm("two_pass", 0, 0)


def launch_pack(plane: torch.Tensor, h: int, w: int, form: PackForm, unpack: bool) -> None:
    """Launch K-v's ``form`` on a CUDA shard (the wrappers pass
    ``pack_form``'s); only the two-pass form allocates, its scratch."""
    if plane.device.type != "cuda":
        raise ValueError(f"launch_pack: want a CUDA shard, got {plane.device}")
    name = "strip_unpack_v" if unpack else "strip_pack_v"
    tmp = (torch.empty(h * w, dtype=plane.dtype, device=plane.device)
           if form.form == "two_pass" else None)
    kernels.KERNELS[name].call(plane.data_ptr(), None if tmp is None else tmp.data_ptr(),
                               plane.stride(0), h, w, int(plane.dtype == torch.float32),
                               form.band, kernels.stream_ptr(plane.device), form=form.form)


def _pack(name: str, plain, plane: torch.Tensor, h: int, w: int) -> None:
    dtype = plane.dtype
    if dtype not in (torch.int32, torch.float32):
        raise ValueError(f"{name}: want an int32 (5/3) or float32 (9/7) shard, got {dtype}")
    _check_sub(plane, h, w, dtype, name)
    if h == 0 or w == 0:
        return
    if plane.device.type == "cpu":
        plain(plane, h, w)
        return
    launch_pack(plane, h, w, pack_form(h, w), name == "strip_unpack_v")


def strip_pack_v(plane: torch.Tensor, h: int, w: int) -> None:
    """In place: the interleaved rows of plane[:h, :w] become [s | d]; a
    float32 (9/7) sub-block scales s by 1/K and d by K."""
    _pack("strip_pack_v", strip_pack_v_plain, plane, h, w)


def strip_pack_v_plain(plane, h, w):
    x = plane[:h, :w]
    s, d = x[0::2], x[1::2]
    if plane.dtype == torch.float32:
        s, d = s * INV_K97, d * K97
    x.copy_(torch.cat([s, d]))


def strip_unpack_v(plane: torch.Tensor, h: int, w: int) -> None:
    """In place: the [s | d] rows of plane[:h, :w] back to interleaved; a
    float32 (9/7) sub-block scales s by K and d by 1/K first."""
    _pack("strip_unpack_v", strip_unpack_v_plain, plane, h, w)


def strip_unpack_v_plain(plane, h, w):
    x = plane[:h, :w]
    s, d = x[:h // 2], x[h // 2:]
    if plane.dtype == torch.float32:
        s, d = s * K97, d * INV_K97
    out = torch.empty_like(x)
    out[0::2], out[1::2] = s, d
    x.copy_(out)


# ============================================= K-w: block statistics
def blk_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Of an int32 batch [T, C, H, W], H and W multiples of 64: the largest
    magnitude of each 64 x 64 block, int32 [T, C, H/64, W/64], and the sum
    of the squares of every sample, a float64 scalar tensor (exact while
    the squares and their sum stay integers a float64 holds)."""
    if x.dtype != torch.int32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"blk_stats: want a contiguous int32 [T, C, H, W] batch, got "
                         f"{x.dtype} {tuple(x.shape)}")
    t, c, hh, ww = x.shape
    if hh % 64 or ww % 64:
        raise ValueError(f"blk_stats: H and W must be multiples of 64, got {hh}x{ww}")
    if x.device.type == "cpu":
        return blk_stats_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"blk_stats: unsupported device {x.device}")
    bmax = torch.empty((t, c, hh // 64, ww // 64), dtype=torch.int32, device=x.device)
    if bmax.numel() == 0:
        return bmax, torch.zeros((), dtype=torch.float64, device=x.device)
    partial = torch.empty(bmax.numel(), dtype=torch.float64, device=x.device)
    total = torch.empty((), dtype=torch.float64, device=x.device)
    kernels.KERNELS["blk_stats"].call(x.data_ptr(), bmax.data_ptr(), partial.data_ptr(),
                                      total.data_ptr(), t * c, hh, ww,
                                      kernels.stream_ptr(x.device))
    return bmax, total


def blk_stats_plain(x):
    t, c, hh, ww = x.shape
    bmax = x.abs().reshape(t, c, hh // 64, 64, ww // 64, 64).amax(dim=(3, 5))
    return bmax, x.double().square().sum()
