"""Codestream state: SIZ geometry, coding styles and the parsed main
header (counterpart of grok_tpu/codestream/structs.py)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..core.params import ProgressionOrder, QuantStyle
from ..core.rect import Rect, ceil_div


@dataclass
class SizComponent:
    dx: int = 1
    dy: int = 1
    prec: int = 8
    signed: bool = False


@dataclass
class Siz:
    """Canvas geometry of the SIZ marker (T.800 A.5.1)."""

    rsiz: int = 0
    x1: int = 0  # Xsiz
    y1: int = 0  # Ysiz
    x0: int = 0  # XOsiz
    y0: int = 0  # YOsiz
    tile_w: int = 0  # XTsiz
    tile_h: int = 0  # YTsiz
    tile_x0: int = 0  # XTOsiz
    tile_y0: int = 0  # YTOsiz
    comps: list[SizComponent] = field(default_factory=list)

    @property
    def num_comps(self) -> int:
        return len(self.comps)

    @property
    def num_tiles_x(self) -> int:
        return ceil_div(self.x1 - self.tile_x0, self.tile_w)

    @property
    def num_tiles_y(self) -> int:
        return ceil_div(self.y1 - self.tile_y0, self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.num_tiles_x * self.num_tiles_y

    def tile_bounds(self, tile_index: int) -> Rect:
        """Tile rect on the reference grid, clipped to the image area
        (T.800 B.3 eq. B-7/B-8)."""
        p = tile_index % self.num_tiles_x
        q = tile_index // self.num_tiles_x
        return Rect(
            max(self.tile_x0 + p * self.tile_w, self.x0),
            max(self.tile_y0 + q * self.tile_h, self.y0),
            min(self.tile_x0 + (p + 1) * self.tile_w, self.x1),
            min(self.tile_y0 + (q + 1) * self.tile_h, self.y1),
        )


@dataclass
class TccpStyle:
    """Per-component coding style (COD SPcod) and quantization (QCD/QCC)."""

    num_resolutions: int = 6
    cblk_w_exp: int = 6  # log2 codeblock width
    cblk_h_exp: int = 6
    cblk_style: int = 0
    guard_bits: int = 2
    step_exps: list[int] = field(default_factory=list)  # per signalled band
    step_mants: list[int] = field(default_factory=list)  # 11-bit mantissas (9/7)
    irreversible: bool = False  # 9/7
    quant_style: QuantStyle = QuantStyle.NO_QUANT
    roi_shift: int = 0  # ROI maxshift (RGN SPrgn), 0 = none
    # as read from a stream; the decoder refuses what the slices lack
    precinct_exps: list[tuple[int, int]] | None = None

    def precinct_exp(self, res: int) -> tuple[int, int]:
        """Maximal precincts: these slices signal no precinct sizes."""
        return (15, 15)

    def copy(self) -> "TccpStyle":
        return replace(self, step_exps=list(self.step_exps), step_mants=list(self.step_mants),
                       precinct_exps=None if self.precinct_exps is None
                       else list(self.precinct_exps))


@dataclass
class Tcp:
    """Per-tile coding parameters (COD Scod/SGcod + per-component styles)."""

    csty: int = 0
    progression: ProgressionOrder = ProgressionOrder.LRCP
    num_layers: int = 1
    mct: int = 0  # 0: none, 1: RCT (5/3) or ICT (9/7), 2: Part-2 array MCT
    tccps: list[TccpStyle] = field(default_factory=list)
    # Part-2 MCT (mct = 2): the float64 [N, N] decoding matrix and the N
    # offsets (from the MCT markers, or what the encoder writes there), and
    # the encoder's float64 encoding matrix
    mct_dec_matrix: object | None = None
    mct_offsets: list[float] | None = None
    mct_enc_matrix: object | None = None

    def copy(self) -> "Tcp":
        return replace(self, tccps=[t.copy() for t in self.tccps])


@dataclass
class HeaderInfo:
    """What the decoder keeps of the main header."""

    siz: Siz = field(default_factory=Siz)
    default_tcp: Tcp = field(default_factory=Tcp)
    cap: tuple[int, list[int]] | None = None  # (Pcap, [Ccap...])
