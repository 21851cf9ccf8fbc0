"""The device mesh of the port and the sharded programs of K6: the
Y-sharded strip wavelet with one-row halos, its layout bridge to the
codestream's Mallat layout, and the tile-parallel transform with its block
statistics.

Counterpart of grok_tpu/parallel/mesh.py. The reference is a single
controller over a ``jax.sharding.Mesh``: one process drives every device,
and ``ppermute`` moves a halo row from one shard to the next. The port
keeps that form:

- a mesh is an ordered list of ``torch.device``s (``Mesh``); several
  entries may name one card, the counterpart of XLA's forced host device
  count, so n shards run on the one card the tests and the measurements
  have;
- a shard is a tensor on its device;
- a halo exchange is an explicit copy of one row into the receiving shard's
  halo buffer (``halo_from_next``, ``halo_from_prev``): a peer copy across
  cards, a device-local copy on one card. The kernels read a halo only from
  that buffer, never from the neighbour's shard, so one card runs the copy
  path of several.

The exchange is bulk-synchronous, as ``ppermute`` is: within a level every
shard's predict reads its neighbour's s row from before that neighbour's
update, so every step runs as all halo copies, then the step on every
shard. The strip form needs n | H, 2^levels | H/n and 2^levels | W
(the reference's limits, mesh.py:258-260), and takes parity 0: an odd size
or origin is the reference's GSPMD form (make_auto_sharded_dwt), which the
port does not have yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.errors import UnsupportedFeatureError
from ..core.rect import Rect
from ..kernels import on_device as on
from ..ops import transform as tr
from . import ops

_HALO_COPIES = [0]


def halo_copies() -> int:
    """Halo rows copied since the last ``reset_halo_copies``."""
    return _HALO_COPIES[0]


def reset_halo_copies() -> None:
    _HALO_COPIES[0] = 0


def _indexed(d: torch.device) -> torch.device:
    """A card with its index, as a tensor on it reports its device."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An ordered list of devices, one a shard."""

    def __init__(self, devices):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def virtual(self) -> bool:
        """Whether some card carries more than one shard."""
        return len(set(self.devices)) < len(self.devices)


def make_mesh(n: int | None = None, device=None) -> Mesh:
    """With no ``device``: the CUDA cards (the first n of them); raises when
    there are none, or fewer than n. With ``device``: n shards (default 1)
    on that one device, e.g. ``make_mesh(8, device="cpu")`` for the plain
    versions, or ``make_mesh(4, device="cuda:0")`` for a virtual mesh on one
    card."""
    if device is not None:
        return Mesh([torch.device(device)] * (n or 1))
    if not torch.cuda.is_available():
        raise RuntimeError("grok_tpu_torch.make_mesh takes the CUDA devices and none is "
                           "available; pass device='cpu' for a mesh of the plain versions")
    count = torch.cuda.device_count()
    if n is not None and n > count:
        raise RuntimeError(f"grok_tpu_torch.make_mesh: {n} cards asked, {count} present; "
                           "pass device= to put several shards on one card")
    return Mesh([torch.device("cuda", i) for i in range(n or count)])


# ------------------------------------------------------------ halos
def halo_from_next(shards: list[torch.Tensor], bufs: list[torch.Tensor],
                   w: int) -> list[torch.Tensor | None]:
    """Copy the first row of shard i + 1 into shard i's halo buffer; the
    last shard gets none (its step clamps). grok_tpu/parallel/mesh.py:36."""
    for i in range(len(shards) - 1):
        bufs[i][:w].copy_(shards[i + 1][0, :w])
    _HALO_COPIES[0] += len(shards) - 1
    return [*bufs[:-1], None]


def halo_from_prev(shards: list[torch.Tensor], bufs: list[torch.Tensor], h: int,
                   w: int) -> list[torch.Tensor | None]:
    """Copy row h - 1 of shard i - 1 (its last row of the sub-block) into
    shard i's halo buffer; the first shard gets none. mesh.py:45."""
    for i in range(1, len(shards)):
        bufs[i][:w].copy_(shards[i - 1][h - 1, :w])
    _HALO_COPIES[0] += len(shards) - 1
    return [None, *bufs[1:]]


def _halo_bufs(shards: list[torch.Tensor]) -> list[torch.Tensor]:
    return [torch.empty(s.shape[1], dtype=s.dtype, device=s.device) for s in shards]


# ------------------------------------------------------------ the strip wavelet
def check_strip(H: int, W: int, n: int, levels: int) -> None:
    """Refuse by name the sizes the strip form excludes."""
    bad = []
    if H % n:
        bad.append(f"{n} shards do not divide the height {H}")
    elif (H // n) % (1 << levels):
        bad.append(f"2^{levels} does not divide the shard height {H // n}")
    if W % (1 << levels):
        bad.append(f"2^{levels} does not divide the width {W}")
    if bad:
        raise UnsupportedFeatureError(
            "outside the ported slices: the sharded strip wavelet needs n | H, 2^levels | H/n "
            f"and 2^levels | W ({'; '.join(bad)}); odd sizes take the GSPMD form, "
            "make_auto_sharded_dwt, not ported")


def _check_shards(shards: list[torch.Tensor], levels: int, dtype) -> tuple[int, int]:
    S, W = shards[0].shape
    for s in shards:
        if s.dtype != dtype or s.dim() != 2 or not s.is_contiguous() or s.shape != (S, W):
            raise ValueError(f"want {len(shards)} contiguous {dtype} shards of one shape, got "
                             f"{[(x.dtype, tuple(x.shape)) for x in shards]}")
    check_strip(S * len(shards), W, len(shards), levels)
    return S, W


def _each(shards, fn) -> None:
    for s in shards:
        with on(s.device):
            fn(s)


def _each_card(shards, fn) -> None:
    """fn on the list of shards of each device, in the mesh's order: one
    launch of a horizontal half takes every shard of a card."""
    groups: dict[torch.device, list[torch.Tensor]] = {}
    for s in shards:
        groups.setdefault(s.device, []).append(s)
    for dev, group in groups.items():
        with on(dev):
            fn(group)


def _fwd_v(shards, bufs, h: int, w: int, irreversible: bool) -> None:
    """One vertical forward pass over the mesh, then the packing."""
    steps = ops.STEPS_97 if irreversible else ((False, 0.0), (True, 0.0))
    for update, coef in steps:
        halos = (halo_from_prev(shards, bufs, h, w) if update
                 else halo_from_next(shards, bufs, w))
        for s, halo in zip(shards, halos):
            with on(s.device):
                if irreversible:
                    ops.strip97_step(s, h, w, halo, update, coef)
                else:
                    ops.strip53_step(s, h, w, halo, update)
    _each(shards, lambda s: ops.strip_pack_v(s, h, w))


def _inv_v(shards, bufs, h: int, w: int, irreversible: bool) -> None:
    """The unpacking, then one vertical inverse pass over the mesh."""
    _each(shards, lambda s: ops.strip_unpack_v(s, h, w))
    steps = ops.STEPS_97 if irreversible else ((False, 0.0), (True, 0.0))
    for update, coef in reversed(steps):
        halos = (halo_from_prev(shards, bufs, h, w) if update
                 else halo_from_next(shards, bufs, w))
        for s, halo in zip(shards, halos):
            with on(s.device):
                if irreversible:
                    ops.strip97_step(s, h, w, halo, update, coef, inverse=True)
                else:
                    ops.strip53_step(s, h, w, halo, update, inverse=True)


def _strip_forward(shards, levels: int, irreversible: bool) -> list[torch.Tensor]:
    S, W = _check_shards(shards, levels, torch.float32 if irreversible else torch.int32)
    h_pass = tr.dwt97_fwd_h if irreversible else tr.dwt53_fwd_h
    bufs = _halo_bufs(shards)
    for lvl in range(levels):
        h, w = S >> lvl, W >> lvl
        _fwd_v(shards, bufs, h, w, irreversible)
        _each_card(shards, lambda g: h_pass(g, h, w, 0))
    return shards


def _strip_inverse(shards, levels: int, irreversible: bool) -> list[torch.Tensor]:
    S, W = _check_shards(shards, levels, torch.float32 if irreversible else torch.int32)
    h_pass = tr.dwt97_inv_h if irreversible else tr.dwt53_inv_h
    bufs = _halo_bufs(shards)
    for lvl in range(levels, 0, -1):
        h, w = S >> (lvl - 1), W >> (lvl - 1)
        _each_card(shards, lambda g: h_pass(g, h, w, 0))
        _inv_v(shards, bufs, h, w, irreversible)
    return shards


def sharded_dwt53_forward(shards: list[torch.Tensor], levels: int) -> list[torch.Tensor]:
    """Multi-level forward 5/3 of a Y-sharded strip, in place on the int32
    shards [S, W] (one a mesh device, in row order); returns them. Layout:
    per-shard packed, level l's low band in the first S/2^l rows of every
    shard (grok_tpu/parallel/mesh.py:253)."""
    return _strip_forward(shards, levels, False)


def sharded_dwt53_inverse(shards: list[torch.Tensor], levels: int) -> list[torch.Tensor]:
    """Inverse of ``sharded_dwt53_forward``, in place. mesh.py:274."""
    return _strip_inverse(shards, levels, False)


def sharded_dwt97_forward(shards: list[torch.Tensor], levels: int) -> list[torch.Tensor]:
    """Multi-level forward 9/7 of a Y-sharded float32 strip, in place, in
    the per-shard packed layout. mesh.py:287."""
    return _strip_forward(shards, levels, True)


def sharded_dwt97_inverse(shards: list[torch.Tensor], levels: int) -> list[torch.Tensor]:
    """Inverse of ``sharded_dwt97_forward``, in place. mesh.py:304."""
    return _strip_inverse(shards, levels, True)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def split_rows(x, mesh: Mesh, dtype=torch.int32) -> list[torch.Tensor]:
    """A global [H, W] plane (numpy or tensor) as len(mesh) row strips, each
    a new contiguous tensor on its shard's device."""
    x = _tensor(x).to(dtype)
    n = len(mesh)
    if x.dim() != 2 or x.shape[0] % n:
        raise UnsupportedFeatureError(
            f"outside the ported slices: {n} shards do not divide the height of a "
            f"{tuple(x.shape)} plane")
    S = x.shape[0] // n
    return [x[i * S:(i + 1) * S].to(d, copy=True).contiguous() for i, d in enumerate(mesh.devices)]


def join_rows(shards: list[torch.Tensor]) -> torch.Tensor:
    """The shards stacked back into one [H, W] plane on the first shard's
    device."""
    dev = shards[0].device
    return torch.cat([s.to(dev) for s in shards])


def make_sharded_strip_dwt(mesh: Mesh, levels: int, irreversible: bool = False):
    """The forward and inverse sharded-strip wavelet over ``mesh``: 5/3 on
    int32 or 9/7 on float32 per ``irreversible`` (mesh.py:490). Each takes
    a global [H, W] plane (numpy or tensor) or a list of shards and returns
    new shards in the per-shard packed layout (forward) or natural order
    (inverse)."""
    dtype = torch.float32 if irreversible else torch.int32
    f = sharded_dwt97_forward if irreversible else sharded_dwt53_forward
    g = sharded_dwt97_inverse if irreversible else sharded_dwt53_inverse

    def shards_of(x):
        if isinstance(x, (list, tuple)):
            if len(x) != len(mesh):
                raise ValueError(f"want {len(mesh)} shards, got {len(x)}")
            return [s.to(d, dtype, copy=True).contiguous() for s, d in zip(x, mesh.devices)]
        return split_rows(x, mesh, dtype)

    return (lambda x: f(shards_of(x), levels)), (lambda x: g(shards_of(x), levels))


# ------------------------------------------- strip <-> codestream layout
def _strip_row_provenance(H: int, n_shards: int, levels: int) -> np.ndarray:
    """strip_row -> provenance id (the natural input row whose coefficient
    chain lands there), by simulating the per-shard packing on indices."""
    S = H // n_shards
    out = np.arange(H).reshape(n_shards, S).copy()
    cur = S
    for _ in range(levels):
        sub = out[:, :cur]
        out[:, :cur] = np.concatenate([sub[:, 0::2], sub[:, 1::2]], axis=1)
        cur //= 2
    return out.reshape(-1)


def _mallat_row_provenance(H: int, levels: int) -> np.ndarray:
    out = np.arange(H).copy()
    cur = H
    for _ in range(levels):
        sub = out[:cur].copy()
        out[: (cur + 1) // 2] = sub[0::2]
        out[(cur + 1) // 2 : cur] = sub[1::2]
        cur //= 2
    return out


def _row_perm_at_level(H: int, n_shards: int, level: int) -> np.ndarray:
    """mallat = strip_rows[perm] for rows packed ``level`` times."""
    strip = _strip_row_provenance(H, n_shards, level)
    mallat = _mallat_row_provenance(H, level)
    inv = np.empty(H, dtype=np.int64)
    inv[strip] = np.arange(H)
    return inv[mallat]


def _band_perms(H: int, W: int, n_shards: int, levels: int) -> list[tuple[int, int, np.ndarray]]:
    """(first column, end column, row permutation) of each column band: the
    h-high band of level l keeps the row order after exactly l vertical
    packings, and the deepest low band that of the last level."""
    out = []
    for lvl in range(1, levels + 1):
        out.append((W >> lvl, W >> (lvl - 1), _row_perm_at_level(H, n_shards, lvl)))
    if levels:
        out.append((0, W >> levels, out[-1][2]))
    return out


def strip_to_mallat_map(H: int, W: int, n_shards: int, levels: int) -> np.ndarray:
    """[H, W] row-index map m with mallat = strip[m, arange(W)]: converts the
    per-shard packed layout of the sharded forward into the codestream
    (Mallat) layout of one tile (mesh.py:352)."""
    m = np.empty((H, W), dtype=np.int64)
    m[:] = np.arange(H)[:, None]
    for lo, hi, perm in _band_perms(H, W, n_shards, levels):
        m[:, lo:hi] = perm[:, None]
    return m


def strip_to_mallat(y, n_shards: int, levels: int):
    """The layout bridge on a gathered [H, W] strip result: a numpy array
    through the map (mesh.py:376), or a tensor, on its device, through one
    row permutation a column band (index_select with an index vector of
    length H; no [H, W] map is uploaded)."""
    H, W = y.shape[-2], y.shape[-1]
    if not isinstance(y, torch.Tensor):
        return np.take_along_axis(y, strip_to_mallat_map(H, W, n_shards, levels), axis=-2)
    out = y.clone()
    for lo, hi, perm in _band_perms(H, W, n_shards, levels):
        out[:, lo:hi] = y[:, lo:hi].index_select(0, torch.from_numpy(perm).to(y.device))
    return out


def mallat_to_strip(y, n_shards: int, levels: int):
    """The inverse bridge (mesh.py:384), numpy or tensor as above."""
    H, W = y.shape[-2], y.shape[-1]
    if not isinstance(y, torch.Tensor):
        out = np.empty_like(y)
        np.put_along_axis(out, strip_to_mallat_map(H, W, n_shards, levels), y, axis=-2)
        return out
    out = y.clone()
    for lo, hi, perm in _band_perms(H, W, n_shards, levels):
        band = out[:, lo:hi]
        band.index_copy_(0, torch.from_numpy(perm).to(y.device), y[:, lo:hi])
    return out


# --------------------------------------------------- tile-parallel encode
def make_sharded_transform(mesh: Mesh, levels: int = 5):
    """The tile-parallel encode transform over ``mesh`` (mesh.py:442): for
    an 8-bit RGB batch [T, 3, H, W] (T a multiple of the mesh size; H and W
    multiples of 64), shard k takes tiles [kT/n, (k+1)T/n) and runs the DC
    shift and RCT (K-a), ``levels`` 5/3 levels (K-b) and the block
    statistics (K-w). Returns (packed int32 [T, 3, H, W], blk_max int32 [T,
    3, H/64, W/64], dist): the first two joined on the first device, dist
    the sum of squares of every coefficient, the shards' float64 partials
    added in shard order on the first device, as float32 (the reference's
    psum)."""
    n = len(mesh)

    def fn(batch):
        x = _tensor(batch).to(torch.int32)
        T, C, H, W = x.shape
        if T % n or C != 3:
            raise ValueError(f"want [T, 3, H, W] with T a multiple of {n}, got {tuple(x.shape)}")
        per = T // n
        rect = Rect(0, 0, W, H)
        outs = []
        for k, dev in enumerate(mesh.devices):
            local = x[k * per:(k + 1) * per].to(dev).contiguous()
            with on(dev):
                packed = torch.stack([
                    torch.stack(tr.forward_transform(list(tile), [rect] * 3, [levels] * 3,
                                                     [128] * 3, True))
                    for tile in local]) if per else local.clone()
                outs.append((packed, *ops.blk_stats(packed)))
        first = mesh.devices[0]
        dist = torch.zeros((), dtype=torch.float64, device=first)
        for _, _, part in outs:
            dist = dist + part.to(first)
        return (torch.cat([p.to(first) for p, _, _ in outs]),
                torch.cat([b.to(first) for _, b, _ in outs]), dist.to(torch.float32))

    return fn
