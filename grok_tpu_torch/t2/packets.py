"""Packet header coding, packet assembly and packet parsing (T.800
B.9/B.10); counterpart of grok_tpu/t2/packets.py without SOP, EPH and
packed headers. Host-side serial work: the payload bytes come from, and go
to, the device T1 coders."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..codestream.bitio import BitReader, BitWriter
from ..core.errors import CorruptPacketError
from ..tile.geometry import BandGeom, PrecinctGeom
from .tagtree import TagTree


def _floor_log2(n: int) -> int:
    return n.bit_length() - 1


def _segment_splits(style: int, start_pass: int, npasses: int) -> list[int]:
    """Pass counts of the codeword segments covering passes
    [start_pass, start_pass + npasses) (T.800 D.4 termination rules)."""
    if style & 0x40:
        # HT (T.814): the cleanup pass terminates its segment; SigProp and
        # MagRef of the same HT set share the following segment
        out = []
        for p in range(start_pass, start_pass + npasses):
            if p % 3 == 2 and out and p - 1 >= start_pass and (p - 1) % 3 == 1:
                out[-1] += 1
            else:
                out.append(1)
        return out
    if style & 0x04:  # TERMALL: every pass is its own segment
        return [1] * npasses
    if style & 0x01:  # BYPASS: boundaries at MQ<->raw coder switches
        def term_after(p):
            t = 2 if p == 0 else (p - 1) % 3
            return p == 9 or (p > 9 and t in (1, 2))

        out = []
        cur = 0
        for p in range(start_pass, start_pass + npasses):
            cur += 1
            if term_after(p):
                out.append(cur)
                cur = 0
        if cur:
            out.append(cur)
        return out
    return [npasses]


def write_numpasses(bio: BitWriter, n: int) -> None:
    if n == 1:
        bio.write_bit(0)
    elif n == 2:
        bio.write_bits(0b10, 2)
    elif n <= 5:
        bio.write_bits(0b11, 2)
        bio.write_bits(n - 3, 2)
    elif n <= 36:
        bio.write_bits(0b1111, 4)
        bio.write_bits(n - 6, 5)
    else:
        bio.write_bits(0b111111111, 9)
        bio.write_bits(n - 37, 7)


def read_numpasses(bio: BitReader) -> int:
    if not bio.read_bit():
        return 1
    if not bio.read_bit():
        return 2
    v = bio.read_bits(2)
    if v < 3:
        return 3 + v
    v = bio.read_bits(5)
    if v < 31:
        return 6 + v
    return 37 + bio.read_bits(7)


@dataclass
class CblkEnc:
    """Encoder-side codeblock T2 record."""

    data: np.ndarray  # uint8 segment bytes
    total_len: int
    npasses: int
    numbps: int  # coded magnitude planes (imsb = band Mb - numbps)
    layer_passes: list[int] = field(default_factory=list)
    layer_bytes: list[int] = field(default_factory=list)
    lblock: int = 3
    included: bool = False
    passes_done: int = 0
    bytes_done: int = 0
    first_layer: int = 0
    style: int = 0  # codeblock style (segmentation: TERMALL/BYPASS)
    pass_rates: object = None  # cumulative byte offsets per pass


@dataclass
class CblkDec:
    """Decoder-side codeblock T2 record. ``segments`` holds the kept
    contribution pieces, ``seg_passes`` the passes of each; ``npasses``
    counts the kept passes and ``passes_seen`` every pass the headers
    announced, dropped layers included (it places the segment splits)."""

    segments: list[bytes] = field(default_factory=list)
    seg_passes: list[int] = field(default_factory=list)
    npasses: int = 0
    passes_seen: int = 0
    numbps: int = 0  # set on first inclusion from the imsb tree
    lblock: int = 3
    included: bool = False
    style: int = 0


class PrecinctCtx:
    """Per-(band, precinct) mutable header-coding state."""

    def __init__(self, band: BandGeom, prc: PrecinctGeom):
        self.band = band
        self.prc = prc
        self.incl_tree = TagTree(prc.cblk_grid_w, prc.cblk_grid_h)
        self.imsb_tree = TagTree(prc.cblk_grid_w, prc.cblk_grid_h)
        self.cblks: list = [None] * len(prc.cblks)

    def set_encoder_trees(self, num_layers: int) -> None:
        gw, gh = self.prc.cblk_grid_w, self.prc.cblk_grid_h
        if gw == 0 or gh == 0:
            return
        incl = np.full((gh, gw), num_layers, dtype=np.int64)
        imsb = np.zeros((gh, gw), dtype=np.int64)
        for geom, cb in zip(self.prc.cblks, self.cblks):
            if cb is None:
                continue
            incl[geom.cy, geom.cx] = cb.first_layer if cb.npasses > 0 else num_layers
            imsb[geom.cy, geom.cx] = self.band.num_bps - cb.numbps
        self.incl_tree.set_values(incl)
        self.imsb_tree.set_values(imsb)


def encode_packet(prc_ctxs: list[PrecinctCtx], layer: int, simulate: bool = False):
    """Encode one packet: all bands of one precinct of one res/comp/layer.
    Returns its bytes, or with ``simulate`` only its length (the header
    state advances either way)."""
    bio = BitWriter()
    body = bytearray()
    body_len = 0
    any_data = any(
        cb is not None and layer < len(cb.layer_passes)
        and cb.layer_passes[layer] > 0
        for ctx in prc_ctxs for cb in ctx.cblks)

    if not any_data:
        bio.write_bit(0)
    else:
        bio.write_bit(1)
        for ctx in prc_ctxs:
            for geom, cb in zip(ctx.prc.cblks, ctx.cblks):
                if cb is None:
                    continue
                npl = cb.layer_passes[layer] if layer < len(cb.layer_passes) else 0
                if not cb.included:
                    ctx.incl_tree.encode(bio, geom.cx, geom.cy, layer + 1)
                else:
                    bio.write_bit(1 if npl > 0 else 0)
                if npl == 0:
                    continue
                if not cb.included:
                    # first inclusion: missing MSBs via the imsb tree
                    imsb = ctx.band.num_bps - cb.numbps
                    ctx.imsb_tree.encode(bio, geom.cx, geom.cy, imsb + 1)
                    cb.included = True
                write_numpasses(bio, npl)
                # one length per codeword segment (T.800 B.10.7.2)
                splits = _segment_splits(cb.style, cb.passes_done, npl)
                if len(splits) == 1:
                    seg_bytes = [cb.layer_bytes[layer]]
                else:
                    r = cb.pass_rates
                    p0 = cb.passes_done
                    seg_bytes = []
                    prev = int(r[p0 - 1]) if p0 > 0 else 0
                    pcur = p0
                    for np_s in splits:
                        pcur += np_s
                        cur = int(r[pcur - 1])
                        seg_bytes.append(cur - prev)
                        prev = cur
                inc = 0
                for np_s, nb_s in zip(splits, seg_bytes):
                    needed = max(1, int(nb_s).bit_length())
                    inc = max(inc, needed - (cb.lblock + _floor_log2(np_s)))
                for _ in range(inc):
                    bio.write_bit(1)
                cb.lblock += inc
                bio.write_bit(0)
                for np_s, nb_s in zip(splits, seg_bytes):
                    bio.write_bits(nb_s, cb.lblock + _floor_log2(np_s))
                nbytes = sum(seg_bytes)
                if not simulate:
                    body += cb.data[cb.bytes_done: cb.bytes_done + nbytes].tobytes()
                body_len += nbytes
                cb.bytes_done += nbytes
                cb.passes_done += npl
    bio.flush()
    if simulate:
        return len(bio.getvalue()) + body_len
    return bio.getvalue() + bytes(body)


def decode_packet(data, pos: int, prc_ctxs: list[PrecinctCtx], layer: int,
                  drop: bool = False) -> tuple[int, bool]:
    """Parse one packet starting at data[pos]; returns the position after
    it and whether the packet was whole. Each included codeblock's
    contribution is appended to its segments, unless ``drop``: then the
    packet (of a layer the caller does not want) is parsed only to keep
    the stream position and the header state, and its bodies are skipped.

    A corrupt header or a body that runs past the end of ``data`` ends the
    tile's T2 (False): the contributions before it whose bytes are present
    are kept, those of a corrupt header are not (the reference's default
    native T2, grok_tpu/t2/native_t2.py:262-279 over native/t2_codec.cpp
    t2_decode_packets)."""
    n = len(data)
    bio = BitReader(data, pos)
    contributions: list[tuple[CblkDec, int, int]] = []  # (cblk, npasses, nbytes)
    try:
        if bio.read_bit():
            for ctx in prc_ctxs:
                for geom, cb in zip(ctx.prc.cblks, ctx.cblks):
                    if cb is None:
                        continue
                    if not cb.included:
                        inc = ctx.incl_tree.decode(bio, geom.cx, geom.cy, layer + 1)
                    else:
                        inc = bool(bio.read_bit())
                    if not inc:
                        continue
                    if not cb.included:
                        cb.numbps = ctx.band.num_bps - ctx.imsb_tree.decode_value(
                            bio, geom.cx, geom.cy)
                        if cb.numbps < 0:
                            raise CorruptPacketError("negative numbps")
                        cb.included = True
                    npl = read_numpasses(bio)
                    while bio.read_bit():
                        cb.lblock += 1
                        if cb.lblock > 32:
                            raise CorruptPacketError("runaway lblock")
                    if cb.passes_seen + npl > 165:
                        raise CorruptPacketError("too many coding passes")
                    for np_s in _segment_splits(cb.style, cb.passes_seen, npl):
                        contributions.append(
                            (cb, np_s, bio.read_bits(cb.lblock + _floor_log2(np_s))))
                    cb.passes_seen += npl
    except CorruptPacketError:
        return pos, False
    bio.align()
    pos = bio.byte_pos
    for cb, npl, nbytes in contributions:
        if pos + nbytes > n:
            return pos, False  # body truncated
        if not drop:
            cb.segments.append(bytes(data[pos:pos + nbytes]))
            cb.seg_passes.append(npl)
            cb.npasses += npl
        pos += nbytes
    return pos, True


def merge_segments(style: int, piece_bytes: list[int], piece_passes: list[int]) -> list[int]:
    """Byte lengths of whole codeword segments from a codeblock's
    contribution pieces (bytes and passes of each, in order): a layer
    boundary may split a TERMALL or BYPASS segment into pieces. The
    reference's object path (grok_tpu/tile/tile_processor.py:1218-1238),
    trailing bytes of an unfinished segment included."""
    targets = _segment_splits(style, 0, sum(piece_passes))
    merged: list[int] = []
    acc_b = acc_p = ti = 0
    for nb, np_c in zip(piece_bytes, piece_passes):
        acc_b += nb
        acc_p += np_c
        while ti < len(targets) and acc_p >= targets[ti]:
            acc_p -= targets[ti]
            merged.append(acc_b)
            acc_b = 0
            ti += 1
    if acc_b:
        merged.append(acc_b)
    return merged
