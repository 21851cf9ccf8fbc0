"""J2K marker segment writers (T.800 Annex A); counterpart of the writer
half of grok_tpu/codestream/markers.py: SOC, SIZ, COD, QCD/QCC, COM, SOT,
SOD and EOC."""

from __future__ import annotations

import struct

from ..core.params import QuantStyle
from .structs import Siz, Tcp, TccpStyle

SOC = 0xFF4F
SOT = 0xFF90
SOD = 0xFF93
EOC = 0xFFD9
SIZ = 0xFF51
COD = 0xFF52
QCD = 0xFF5C
QCC = 0xFF5D
COM = 0xFF64


def _u8(b: int) -> bytes:
    return struct.pack(">B", b)


def _u16(v: int) -> bytes:
    return struct.pack(">H", v)


def _u32(v: int) -> bytes:
    return struct.pack(">I", v)


def segment(marker: int, payload: bytes) -> bytes:
    """marker + Lxxx (payload length + 2) + payload."""
    return _u16(marker) + _u16(len(payload) + 2) + payload


def write_siz(siz: Siz) -> bytes:
    p = bytearray()
    p += _u16(siz.rsiz)
    p += _u32(siz.x1) + _u32(siz.y1) + _u32(siz.x0) + _u32(siz.y0)
    p += (_u32(siz.tile_w) + _u32(siz.tile_h)
          + _u32(siz.tile_x0) + _u32(siz.tile_y0))
    p += _u16(len(siz.comps))
    for c in siz.comps:
        ssiz = (c.prec - 1) | (0x80 if c.signed else 0)
        p += _u8(ssiz) + _u8(c.dx) + _u8(c.dy)
    return segment(SIZ, bytes(p))


def _write_spcod(tccp: TccpStyle) -> bytes:
    p = bytearray()
    p += _u8(tccp.num_resolutions - 1)
    p += _u8(tccp.cblk_w_exp - 2)
    p += _u8(tccp.cblk_h_exp - 2)
    p += _u8(tccp.cblk_style)
    p += _u8(1)  # Table A-20: 1 = reversible 5/3
    return bytes(p)


def write_cod(tcp: Tcp) -> bytes:
    p = bytearray()
    p += _u8(tcp.csty)
    p += _u8(int(tcp.progression))
    p += _u16(tcp.num_layers)
    p += _u8(tcp.mct)
    p += _write_spcod(tcp.tccps[0])
    return segment(COD, bytes(p))


def _write_sqcd(tccp: TccpStyle) -> bytes:
    """Reversible quantization: the guard bits and one exponent per band."""
    p = bytearray()
    p += _u8(int(QuantStyle.NO_QUANT) | (tccp.guard_bits << 5))
    for e in tccp.step_exps:
        p += _u8(e << 3)
    return bytes(p)


def write_qcd(tcp: Tcp) -> bytes:
    return segment(QCD, _write_sqcd(tcp.tccps[0]))


def write_qcc(tcp: Tcp, comp: int, num_comps: int) -> bytes:
    head = _u8(comp) if num_comps <= 256 else _u16(comp)
    return segment(QCC, head + _write_sqcd(tcp.tccps[comp]))


def write_com(text: bytes, is_text: bool = True) -> bytes:
    return segment(COM, _u16(1 if is_text else 0) + text)


def write_sot(tile_index: int, psot: int, tp_index: int, num_tps: int) -> bytes:
    return segment(SOT, _u16(tile_index) + _u32(psot) + _u8(tp_index)
                   + _u8(num_tps))
