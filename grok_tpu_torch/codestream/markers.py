"""J2K marker segments (T.800 Annex A; T.814 CAP; T.801 A.3.7-A.3.9 MCT,
MCC and MCO); counterpart of grok_tpu/codestream/markers.py for SOC, SIZ,
CAP, COD/COC, QCD/QCC, RGN, MCT/MCC/MCO, COM, SOT, SOD and EOC: the
writers, and the readers of the main and tile-part headers. Markers
outside the ported slices are refused by name."""

from __future__ import annotations

import struct

import numpy as np

from ..core.errors import CodestreamError, InvalidMarkerError, UnsupportedFeatureError
from ..core.params import ProgressionOrder, QuantStyle
from .structs import HeaderInfo, Siz, SizComponent, Tcp, TccpStyle

SOC = 0xFF4F
SOT = 0xFF90
SOD = 0xFF93
EOC = 0xFFD9
SIZ = 0xFF51
COD = 0xFF52
QCD = 0xFF5C
QCC = 0xFF5D
COM = 0xFF64
CAP = 0xFF50
COC = 0xFF53
RGN = 0xFF5E
MCT = 0xFF74
MCC = 0xFF75
MCO = 0xFF77
# markers the decoder refuses (outside the ported slices)
REFUSED = {0xFF5F: "POC", 0xFF60: "PPM", 0xFF61: "PPT", 0xFF58: "PLT", 0xFF57: "PLM",
           0xFF55: "TLM"}


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
    p += _u8(0 if tccp.irreversible else 1)  # Table A-20: 0 = 9/7, 1 = 5/3
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
    """Sqcd and its SPqcd: an exponent byte per band (no quantization), or
    16-bit exponent and mantissa words, every band's (expounded) or the
    LL band's only (derived)."""
    p = bytearray()
    p += _u8(int(tccp.quant_style) | (tccp.guard_bits << 5))
    if tccp.quant_style == QuantStyle.NO_QUANT:
        for e in tccp.step_exps:
            p += _u8(e << 3)
    else:
        for e, m in zip(tccp.step_exps, tccp.step_mants):
            p += _u16((e << 11) | m)
    return bytes(p)


def write_qcd(tcp: Tcp) -> bytes:
    return segment(QCD, _write_sqcd(tcp.tccps[0]))


def write_qcc(tcp: Tcp, comp: int, num_comps: int) -> bytes:
    head = _u8(comp) if num_comps <= 256 else _u16(comp)
    return segment(QCC, head + _write_sqcd(tcp.tccps[comp]))


def write_rgn(comp: int, shift: int, num_comps: int) -> bytes:
    """RGN: the component, Srgn 0 (maxshift) and the shift."""
    head = _u8(comp) if num_comps <= 256 else _u16(comp)
    return segment(RGN, head + _u8(0) + _u8(shift))


def write_mct_markers(dec_matrix, offsets) -> bytes:
    """The Part-2 array MCT as grok_tpu writes it (markers.py:474-507): one
    MCT of float32 elements with the [N, N] decoding matrix (index 1,
    decorrelation), one with the N offsets (index 2), one MCC collection
    (index 3, irreversible, array-based) over components 0..N-1, one MCO
    ordering it."""
    n = len(offsets)

    def mct_record(index, array_type, values):
        data = b"".join(struct.pack(">f", float(v)) for v in values)
        imct = (index & 0xFF) | (array_type << 8) | (2 << 10)  # float32 elements
        return segment(MCT, _u16(0) + _u16(imct) + _u16(0) + data)

    out = bytearray()
    out += mct_record(1, 1, [v for row in dec_matrix for v in row])
    out += mct_record(2, 2, offsets)
    p = bytearray()
    p += _u16(0) + _u8(3) + _u16(0)  # Zmcc, Imcc, Ymcc
    p += _u16(1) + _u8(0x1)  # Qmcc: one collection; Xmcc: array-based decorrelation
    p += _u16(n) + b"".join(_u8(i) for i in range(n))  # Nmcc, input components
    p += _u16(n) + b"".join(_u8(i) for i in range(n))  # Mmcc, output components
    p += bytes([0, 2, 1])  # Tmcc: irreversible, offsets index 2, decorrelation index 1
    out += segment(MCC, bytes(p))
    out += segment(MCO, _u8(1) + _u8(3))
    return bytes(out)


def write_com(text: bytes, is_text: bool = True) -> bytes:
    return segment(COM, _u16(1 if is_text else 0) + text)


def write_sot(tile_index: int, psot: int, tp_index: int, num_tps: int) -> bytes:
    return segment(SOT, _u16(tile_index) + _u32(psot) + _u8(tp_index)
                   + _u8(num_tps))


def write_cap(pcap: int, ccaps: list[int]) -> bytes:
    return segment(CAP, _u32(pcap) + b"".join(_u16(cc) for cc in ccaps))


# ================================================================ readers
class Cursor:
    """Bounded big-endian byte reader for marker payloads."""

    def __init__(self, data, pos: int = 0, end: int | None = None):
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else end

    def remaining(self) -> int:
        return self.end - self.pos

    def u8(self) -> int:
        if self.pos + 1 > self.end:
            raise CodestreamError("truncated marker payload")
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        if self.pos + 2 > self.end:
            raise CodestreamError("truncated marker payload")
        v = (self.data[self.pos] << 8) | self.data[self.pos + 1]
        self.pos += 2
        return v

    def u32(self) -> int:
        return (self.u16() << 16) | self.u16()


def read_siz(c: Cursor) -> Siz:
    siz = Siz()
    siz.rsiz = c.u16()
    siz.x1, siz.y1, siz.x0, siz.y0 = c.u32(), c.u32(), c.u32(), c.u32()
    siz.tile_w, siz.tile_h, siz.tile_x0, siz.tile_y0 = c.u32(), c.u32(), c.u32(), c.u32()
    ncomp = c.u16()
    if ncomp == 0 or ncomp > 16384:
        raise CodestreamError(f"SIZ: bad component count {ncomp}")
    if siz.x1 <= siz.x0 or siz.y1 <= siz.y0:
        raise CodestreamError("SIZ: empty image area")
    if siz.tile_w == 0 or siz.tile_h == 0:
        raise CodestreamError("SIZ: zero tile size")
    if siz.tile_x0 > siz.x0 or siz.tile_y0 > siz.y0:
        raise CodestreamError("SIZ: tile origin beyond image origin")
    if siz.num_tiles > 65535:
        raise CodestreamError(f"SIZ: tile grid {siz.num_tiles_x}x{siz.num_tiles_y} "
                              "exceeds 65535 tiles")
    for _ in range(ncomp):
        ssiz, dx, dy = c.u8(), c.u8(), c.u8()
        if dx == 0 or dy == 0:
            raise CodestreamError("SIZ: zero subsampling")
        siz.comps.append(SizComponent(dx=dx, dy=dy, prec=(ssiz & 0x7F) + 1,
                                      signed=bool(ssiz & 0x80)))
    return siz


def _read_spcod(c: Cursor, tccp: TccpStyle, with_precincts: bool) -> None:
    tccp.num_resolutions = c.u8() + 1
    if tccp.num_resolutions > 33:
        raise CodestreamError("COD: too many resolutions")
    tccp.cblk_w_exp = c.u8() + 2
    tccp.cblk_h_exp = c.u8() + 2
    if not (2 <= tccp.cblk_w_exp <= 10) or not (2 <= tccp.cblk_h_exp <= 10):
        raise CodestreamError("COD: bad codeblock exponent")
    if tccp.cblk_w_exp + tccp.cblk_h_exp > 12:
        raise CodestreamError("COD: codeblock area > 4096")
    tccp.cblk_style = c.u8()
    tccp.irreversible = c.u8() == 0
    tccp.precinct_exps = None
    if with_precincts:
        tccp.precinct_exps = []
        for _ in range(tccp.num_resolutions):
            v = c.u8()
            tccp.precinct_exps.append((v & 0x0F, v >> 4))


def read_cod(c: Cursor, tcp: Tcp, num_comps: int) -> None:
    tcp.csty = c.u8()
    tcp.progression = ProgressionOrder(c.u8())
    tcp.num_layers = c.u16()
    if tcp.num_layers == 0:
        raise CodestreamError("COD: zero layers")
    tcp.mct = c.u8()
    base = TccpStyle()
    _read_spcod(c, base, bool(tcp.csty & 0x01))
    tcp.tccps = [base.copy() for _ in range(num_comps)]


def read_coc(c: Cursor, tcp: Tcp, num_comps: int) -> None:
    comp = c.u8() if num_comps <= 256 else c.u16()
    if comp >= num_comps:
        raise CodestreamError("COC: bad component index")
    _read_spcod(c, tcp.tccps[comp], bool(c.u8() & 0x01))


def _read_sqcd(c: Cursor, tccp: TccpStyle) -> None:
    sqcd = c.u8()
    tccp.quant_style = QuantStyle(sqcd & 0x1F)  # ValueError on a bad style, as grok_tpu
    tccp.guard_bits = sqcd >> 5
    if tccp.quant_style == QuantStyle.NO_QUANT:
        tccp.step_exps = [c.u8() >> 3 for _ in range(c.remaining())]
        tccp.step_mants = [0] * len(tccp.step_exps)
        return
    n = 1 if tccp.quant_style == QuantStyle.SCALAR_DERIVED else c.remaining() // 2
    words = [c.u16() for _ in range(n)]
    tccp.step_exps = [v >> 11 for v in words]
    tccp.step_mants = [v & 0x7FF for v in words]


def read_qcd(c: Cursor, tcp: Tcp) -> None:
    base = tcp.tccps[0]
    _read_sqcd(c, base)
    for t in tcp.tccps[1:]:
        t.quant_style, t.guard_bits = base.quant_style, base.guard_bits
        t.step_exps = list(base.step_exps)
        t.step_mants = list(base.step_mants)


def read_qcc(c: Cursor, tcp: Tcp, num_comps: int) -> None:
    comp = c.u8() if num_comps <= 256 else c.u16()
    if comp >= num_comps:
        raise CodestreamError("QCC: bad component index")
    _read_sqcd(c, tcp.tccps[comp])


def read_rgn(c: Cursor, tcp: Tcp, num_comps: int) -> None:
    comp = c.u8() if num_comps <= 256 else c.u16()
    if comp >= num_comps:
        raise CodestreamError("RGN: bad component index")
    if c.u8() != 0:
        raise CodestreamError("RGN: unsupported style")
    tcp.tccps[comp].roi_shift = c.u8()


_MCT_ELEMS = {0: ">h", 1: ">i", 2: ">f", 3: ">d"}  # Imct bits 10-11


def read_mct(c: Cursor, store: dict) -> None:
    """One MCT segment into ``store[index] = (array type, values)``
    (grok_tpu/codestream/markers.py:510-529)."""
    c.u16()  # Zmct
    imct = c.u16()
    c.u16()  # Ymct
    fmt = _MCT_ELEMS[(imct >> 10) & 0x3]
    size = struct.calcsize(fmt)
    raw = bytes(c.data[c.pos:c.end])
    c.pos = c.end
    store[imct & 0xFF] = ((imct >> 8) & 0x3,
                          [struct.unpack(fmt, raw[i:i + size])[0]
                           for i in range(0, len(raw) - size + 1, size)])


def apply_mct_arrays(hi: HeaderInfo, arrays: dict) -> None:
    """Install the MCT arrays parsed so far (``read_mct``'s store) in the
    main header's coding parameters: an N x N decorrelation array (type 1)
    as the float64 decoding matrix, N offsets (type 2) as the offsets
    (grok_tpu/codestream/markers.py :552-564); MCC and MCO are not read, as
    there."""
    n = hi.siz.num_comps
    for atype, vals in arrays.values():
        if atype == 1 and len(vals) == n * n:
            hi.default_tcp.mct_dec_matrix = np.asarray(vals, dtype=np.float64).reshape(n, n)
        elif atype == 2 and len(vals) == n:
            hi.default_tcp.mct_offsets = [float(v) for v in vals]


def read_cap(c: Cursor) -> tuple[int, list[int]]:
    pcap = c.u32()
    return pcap, [c.u16() for _ in range(c.remaining() // 2)]


def read_sot(c: Cursor) -> tuple[int, int, int, int]:
    return c.u16(), c.u32(), c.u8(), c.u8()


def refuse(m: int) -> None:
    """Raise for a marker outside the ported slices."""
    if m in REFUSED:
        raise UnsupportedFeatureError(f"outside the ported slices: {REFUSED[m]} marker")


def read_tile_marker(m: int, sub: Cursor, tcp: Tcp, num_comps: int) -> None:
    """COD/COC/QCD/QCC/RGN of a main or tile-part header into ``tcp``; MCT,
    MCC and MCO are main-header markers, skipped here as the reference
    does."""
    refuse(m)
    if m == RGN:
        read_rgn(sub, tcp, num_comps)
    elif m == COD:
        read_cod(sub, tcp, num_comps)
    elif m == COC:
        read_coc(sub, tcp, num_comps)
    elif m == QCD:
        read_qcd(sub, tcp)
    elif m == QCC:
        read_qcc(sub, tcp, num_comps)


def parse_main_header(data) -> tuple[HeaderInfo, int]:
    """Parse SOC..first SOT. Returns (HeaderInfo, offset of the first SOT).
    COM, MCC and MCO are skipped; CRG, PRF and CPF are skipped as the
    reference does."""
    c = Cursor(data)
    if c.u16() != SOC:
        raise InvalidMarkerError("no SOC marker")
    hi = HeaderInfo()
    mct_arrays: dict[int, tuple[int, list[float]]] = {}
    siz_seen = False
    while True:
        m = c.u16()
        if m == SOT:
            if not siz_seen:
                raise CodestreamError("SOT before SIZ")
            return hi, c.pos - 2
        if m == EOC:
            raise CodestreamError("EOC before any tile")
        if m < 0xFF00:
            raise InvalidMarkerError(f"bad marker 0x{m:04X} in main header")
        ln = c.u16()
        if ln < 2:
            raise CodestreamError("bad marker length")
        sub = Cursor(c.data, c.pos, c.pos + ln - 2)
        if m == SIZ:
            hi.siz = read_siz(sub)
            hi.default_tcp.tccps = [TccpStyle() for _ in hi.siz.comps]
            siz_seen = True
        elif m == CAP:
            hi.cap = read_cap(sub)
        elif m in (COD, COC, QCD, QCC, RGN) and not siz_seen:
            raise CodestreamError("coding style before SIZ")
        elif m == MCT:
            read_mct(sub, mct_arrays)
            apply_mct_arrays(hi, mct_arrays)
        elif m not in (COM, MCC, MCO):
            read_tile_marker(m, sub, hi.default_tcp, hi.siz.num_comps)
        c.pos += ln - 2
