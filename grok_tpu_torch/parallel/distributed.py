"""The distributed encode and decode over a tile mesh: tiles (or frames)
dealt to the shards of a ``Mesh``, each shard running the port's transform
chain on its device, the codestream assembled on the host in tile order.

Counterpart of grok_tpu/parallel/distributed.py. There every device runs
the whole forward chain (DC shift -> MCT -> DWT -> quantization) for its
shard of tiles as one jitted shard_map program; here each shard runs the
port's CUDA kernels for its tiles on its own device (K-a/K-j/K-r,
K-b/K-k, K-l, K-t forward; K-t, K-m/K-g, K-n/K-h, K-o/K-s inverse), and a
tile whose coefficients come from a shard is also entropy-coded (or, on
decode, entropy-decoded) on that shard's device, so T1 spreads over the
cards. T2 and the assembly stay on the host, in tile order.

Tiles are grouped by a transform fingerprint, the per-level (origin parity,
size) chain that fixes the wavelet's split structure, as in the reference:
two same-size tiles whose origins differ in parity at some level transform
differently. A group's plan (its geometry and quantization, the arguments
of ``forward_transform``) is built once a call; the reference caches
compiled programs there, which are costly to build, and a plan is not. The
groups are dealt to the shards one mesh-full at a time, tile k of each
chunk to shard k.

Irreversible (9/7, Part-2 MCT) tiles ride the mesh by default on every
device: the port's float kernels round as its host path does, bit for bit
(PERF.md §6), so the stream stays the one-shot encoder's. The reference
keeps them per tile on its CPU backend, where XLA contracts to FMA; a
caller may still pass ``device_irreversible=False`` to do the same.

Tiles that stay on the per-tile path: subsampled images, single-tile
images (compress_distributed), irreversible or Part-2 MCT tiles when
``device_irreversible`` is False, and on decode tiles whose headers or
entropy decode fail. That path is the port's ordinary compress/decompress
tile path on the mesh's first device, never the CPU behind a card's back;
the output is the same either way.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..codestream.compress import _extract_tile, build_siz, build_tcp, check_supported
from ..codestream.compress import compress as _compress
from ..codestream.decompress import Decoder
from ..core.errors import GrokTpuError
from ..core.image import Image
from ..core.params import CompressParams, DecompressParams
from ..core.timing import StageClock
from ..ops.transform import forward_transform
from ..tile.tile_processor import TileProcessor
from .mesh import Mesh, make_mesh, on


def _tile_fingerprint(siz, tcp, ti):
    """Transform-equivalence key: the per-level (x0 & 1, y0 & 1, w, h)
    chain of every component's tile rect (distributed.py:69)."""
    tb = siz.tile_bounds(ti)
    key = []
    for c in range(siz.num_comps):
        comp = siz.comps[c]
        x0 = -(-tb.x0 // comp.dx)
        y0 = -(-tb.y0 // comp.dy)
        x1 = -(-tb.x1 // comp.dx)
        y1 = -(-tb.y1 // comp.dy)
        lev = []
        for _ in range(tcp.tccps[c].num_resolutions):
            lev.append((x0 & 1, y0 & 1, x1 - x0, y1 - y0))
            x0, y0 = -(-x0 // 2), -(-y0 // 2)
            x1, y1 = -(-x1 // 2), -(-y1 // 2)
        key.append(tuple(lev))
    return tuple(key)


def _inverse_key(tcp):
    """Everything a tile's inverse chain depends on besides its geometry
    (distributed.py:342): tiles with equal keys and fingerprints form one
    group."""
    mat = tcp.mct_dec_matrix
    off = tcp.mct_offsets
    return (
        tcp.mct,
        None if mat is None else np.asarray(mat, np.float64).tobytes(),
        None if off is None else tuple(float(o) for o in off),
        tuple(
            (t.num_resolutions, t.irreversible, t.roi_shift, int(t.quant_style),
             t.guard_bits, tuple(t.step_exps), tuple(t.step_mants))
            for t in tcp.tccps
        ),
    )


def _plan(siz, tcp, params, ti) -> dict:
    """The forward plan (geometry and quantization) of tile ``ti``'s group."""
    tp = TileProcessor(siz, tcp, ti, torch.device("cpu"), params)
    tp._apply_band_quant()
    return tp.forward_plan()


def _upload(arrays, dev) -> list[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev) for a in arrays]


def transform_tiles_on_mesh(image: Image, siz, tcp, params, tiles, mesh: Mesh,
                            device_irreversible: bool = True) -> dict[int, list[torch.Tensor]]:
    """Run the forward chain for ``tiles`` over ``mesh``: the tiles grouped
    by fingerprint, each group dealt to the shards one mesh-full at a time,
    each tile transformed on its shard's device. Returns the packed int32
    coefficient planes by tile (distributed.py:131); tiles that cannot ride
    the mesh (subsampled components, irreversible tiles without
    ``device_irreversible``, empty tiles) are absent."""
    subsampled = any(c.dx != 1 or c.dy != 1 for c in siz.comps)
    irrev = bool(tcp.tccps and tcp.tccps[0].irreversible)
    coeffs_of: dict[int, list[torch.Tensor]] = {}
    if subsampled or (irrev and not device_irreversible):
        return coeffs_of
    groups: dict[tuple, list[int]] = {}
    for ti in tiles:
        if not siz.tile_bounds(ti).empty():
            groups.setdefault(_tile_fingerprint(siz, tcp, ti), []).append(ti)
    n = len(mesh)
    for batch in groups.values():
        plan = _plan(siz, tcp, params, batch[0])
        for c0 in range(0, len(batch), n):
            for ti, dev in zip(batch[c0:c0 + n], mesh.devices):
                with on(dev):
                    coeffs_of[ti] = forward_transform(
                        _upload(_extract_tile(image, siz, ti), dev), **plan)
    return coeffs_of


def _normalized(params: CompressParams | None) -> CompressParams:
    """The params as compress reads them: the Part-2 MCT forces 9/7 (on a
    copy), validated, the options outside the ported slices refused by
    name."""
    params = params or CompressParams()
    if params.mct_matrix is not None:
        params = dataclasses.replace(params, irreversible=True)
    params.validate()
    check_supported(params)
    return params


def _sync_ms(mesh: Mesh, t0: float, stage_ms: dict | None, name: str) -> None:
    """Charge the wall time since t0 to ``name``, every card synchronised."""
    if stage_ms is None:
        return
    for d in set(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    stage_ms[name] = stage_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def compress_distributed(image: Image, params: CompressParams | None = None,
                         mesh: Mesh | None = None, device_irreversible: bool = True,
                         entropy_workers: int | None = None,
                         entropy_threads: int | None = None,
                         stage_ms: dict[str, float] | None = None) -> bytes:
    """Distributed encode over a tile mesh (default: every CUDA card);
    byte-identical to ``compress`` (distributed.py:293). A multi-tile image
    has its tiles transformed on the shards and entropy-coded on the
    shards' devices; the rest runs on the mesh's first device.
    ``entropy_workers`` and ``entropy_threads`` size the reference's host
    pool of native coders and have no effect on the port, whose T1 runs on
    the card. ``stage_ms`` gains ``dist_transform`` beside compress's
    stages."""
    del entropy_workers, entropy_threads  # accepted for the reference's signature
    params = _normalized(params)
    mesh = mesh or make_mesh()
    image.finalize()
    siz = build_siz(image, params)
    tcp = build_tcp(image, params)
    coeffs_of: dict[int, list[torch.Tensor]] = {}
    if siz.num_tiles > 1:
        t0 = time.perf_counter()
        coeffs_of = transform_tiles_on_mesh(image, siz, tcp, params, range(siz.num_tiles), mesh,
                                            device_irreversible)
        _sync_ms(mesh, t0, stage_ms, "dist_transform")
    return _compress(image, params, device=mesh.devices[0], stage_ms=stage_ms,
                     tile_coeff_fn=coeffs_of.get)


_TILE_FAULTS = (GrokTpuError, ValueError, IndexError, OverflowError)


def decompress_distributed(data, params: DecompressParams | None = None,
                           mesh: Mesh | None = None, device_irreversible: bool = True,
                           entropy_workers: int | None = None,
                           entropy_threads: int | None = None,
                           stage_ms: dict[str, float] | None = None) -> Image:
    """Distributed decode over a tile mesh; the planes of ``decompress``
    (distributed.py:366). The tiles of a multi-tile stream are grouped by
    (inverse key, fingerprint) and dealt to the shards; each shard
    entropy-decodes its tiles into staging planes on its device
    (``TileProcessor.decompress(staging_only=True)``) and runs the inverse
    chain there, and the samples ride ``Decoder.decompress(tile_arrays_fn=)``.
    Every group rides the mesh, as in the reference's loop. A tile whose
    headers or entropy decode fail takes the per-tile path, which decodes
    it as ``decompress`` does. ``reduce`` and ``window`` are refused by
    name, as ``decompress`` refuses them. ``entropy_workers`` and
    ``entropy_threads`` have no effect (see compress_distributed)."""
    del entropy_workers, entropy_threads  # accepted for the reference's signature
    mesh = mesh or make_mesh()
    dec = Decoder(data, params, device=mesh.devices[0], stage_ms=stage_ms)
    siz = dec.header.siz
    groups: dict[tuple, list[int]] = {}
    parsed: dict[int, tuple] = {}
    if siz.num_tiles > 1:
        for ti in range(siz.num_tiles):
            if ti not in dec.spans:
                continue
            try:
                tcp, body = dec._parse_tile_headers(ti)
            except _TILE_FAULTS:
                continue  # the per-tile path fills it, or refuses it by name
            if (tcp.tccps[0].irreversible or tcp.mct == 2) and not device_irreversible:
                continue
            parsed[ti] = (tcp, body)
            groups.setdefault((_inverse_key(tcp), _tile_fingerprint(siz, tcp, ti)),
                              []).append(ti)
    dec.clock.mark("markers")
    n = len(mesh)
    arrays: dict[int, list[np.ndarray]] = {}
    for batch in groups.values():
        for c0 in range(0, len(batch), n):
            for ti, dev in zip(batch[c0:c0 + n], mesh.devices):
                tcp, body = parsed[ti]
                clock = StageClock(dev, stage_ms)
                with on(dev):
                    tp = TileProcessor(siz, tcp, ti, dev)
                    try:
                        staging = tp.decompress(body, clock, dec.params.max_layers,
                                                staging_only=True)
                    except _TILE_FAULTS:
                        continue
                    planes = tp.inverse(staging, clock)
                arrays[ti] = [p.cpu().numpy() for p in planes]
                clock.mark("to_host")
    dec.clock = StageClock(dec.device, stage_ms)  # the shards' stages are charged already
    return dec.decompress(tile_arrays_fn=arrays.get)


def compress_frames(images: list[Image], params: CompressParams | None = None,
                    mesh: Mesh | None = None, device_irreversible: bool = True,
                    stage_ms: dict[str, float] | None = None) -> list[bytes]:
    """Frame-parallel encode (distributed.py:546): single-tile frames of the
    first frame's geometry are dealt to the shards, frame k of each
    mesh-full to shard k, transformed and entropy-coded on the shard's
    device; each stream is ``compress(frame)``'s. Other frames (another
    geometry, subsampled or multi-tile, irreversible without
    ``device_irreversible``) take the per-frame path on the first device.
    ``profile`` is refused by name, as ``compress`` refuses it."""
    params = _normalized(params)
    if not images:
        return []
    mesh = mesh or make_mesh()
    for im in images:
        im.finalize()
    first = images[0]
    siz = build_siz(first, params)
    tcp = build_tcp(first, params)
    subsampled = any(c.dx != 1 or c.dy != 1 for c in siz.comps)

    def same_geometry(im) -> bool:
        return (im.x0, im.y0, im.x1, im.y1) == (first.x0, first.y0, first.x1, first.y1) \
            and len(im.components) == len(first.components) and all(
                (a.prec, a.signed, a.dx, a.dy) == (b.prec, b.signed, b.dx, b.dy)
                for a, b in zip(im.components, first.components))

    batch_idx = [i for i, im in enumerate(images)
                 if same_geometry(im) and not subsampled and siz.num_tiles == 1]
    if tcp.tccps[0].irreversible and not device_irreversible:
        batch_idx = []
    coeffs_of: dict[int, list[torch.Tensor]] = {}
    if len(batch_idx) >= 2:
        t0 = time.perf_counter()
        plan = _plan(siz, tcp, params, 0)
        for j, i in enumerate(batch_idx):
            dev = mesh.devices[j % len(mesh)]
            with on(dev):
                coeffs_of[i] = forward_transform(
                    _upload(_extract_tile(images[i], siz, 0), dev), **plan)
        _sync_ms(mesh, t0, stage_ms, "dist_transform")
    outs = []
    for i, im in enumerate(images):
        cf = coeffs_of.pop(i, None)
        outs.append(_compress(im, params, device=mesh.devices[0], stage_ms=stage_ms,
                              tile_coeff_fn=None if cf is None else (lambda ti, cf=cf: cf)))
    return outs
