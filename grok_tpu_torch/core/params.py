"""Coding parameters (counterpart of grok_tpu/core/params.py).

Field names and defaults are those of grok_tpu's CompressParams and
DecompressParams, so a dict of their fields carries over unchanged
(convert.params_from_dict). Fields outside the ported slices are kept so
that the codec can refuse them by name (codestream/compress.py
check_supported, codestream/decompress.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .errors import ParameterError


# Codeblock style bit of the HT block coder (T.814), COD SPcod
CBLK_HT = 0x40


class ProgressionOrder(enum.IntEnum):
    """The 5 standard progression orders (T.800 A.6.1)."""

    LRCP = 0
    RLCP = 1
    RPCL = 2
    PCRL = 3
    CPRL = 4


class ColorSpace(enum.IntEnum):
    UNKNOWN = 0
    SRGB = 1
    GRAY = 2
    SYCC = 3
    EYCC = 4
    CMYK = 5
    CIELAB = 6


class QuantStyle(enum.IntEnum):
    """Sqcd style (T.800 Table A-28)."""

    NO_QUANT = 0  # reversible, exponents only
    SCALAR_DERIVED = 1
    SCALAR_EXPOUNDED = 2


@dataclass
class ProgressionChange:
    """One POC progression bound (T.800 A.6.6)."""

    res_start: int
    comp_start: int
    layer_end: int
    res_end: int
    comp_end: int
    order: ProgressionOrder


@dataclass
class CompressParams:
    """Encoder configuration; same fields and defaults as grok_tpu's."""

    # --- canvas / tiling ---
    tile_size: tuple[int, int] | None = None  # (w, h); None = single tile
    tile_offset: tuple[int, int] = (0, 0)
    image_offset: tuple[int, int] = (0, 0)

    # --- transform ---
    num_resolutions: int = 6  # = decomposition levels + 1
    irreversible: bool = False  # False: 5/3 + RCT
    mct: int | None = None  # None: auto (on iff 3+ comps), 0: off, 1: on
    custom_mct: object | None = None

    # --- codeblocks / precincts ---
    cblk_width: int = 64  # power of two, 4..1024, w*h <= 4096
    cblk_height: int = 64
    cblk_style: int = 0  # T.800 Table A-19 style bits
    ht_refine: bool = False
    tp_divider: str | None = None
    write_plm: bool = False
    mct_matrix: object | None = None
    precinct_sizes: list[tuple[int, int]] | None = None

    # --- layers / rate control ---
    num_layers: int = 1
    layer_rates: list[float] | None = None  # compression ratios, e.g. [20, 10, 5]
    layer_psnrs: list[float] | None = None  # fixed-quality targets (dB)

    # --- progression ---
    progression: ProgressionOrder = ProgressionOrder.LRCP
    progression_changes: list[ProgressionChange] = field(default_factory=list)

    # --- quantization ---
    quant_style: QuantStyle | None = None  # None = auto from irreversible
    base_step: float = 1.0 / 8192.0
    guard_bits: int = 2
    roi_comp: int = -1
    roi_shift: int = 0

    # --- markers / stream features ---
    use_sop: bool = False
    use_eph: bool = False
    write_tlm: bool = False
    write_plt: bool = False
    write_ppt: bool = False
    write_ppm: bool = False
    comment: str | None = "grok_tpu"  # the COM marker is part of the stream
    profile: int = 0
    framerate: int = 0

    # --- HTJ2K ---
    ht: bool = False

    # --- misc ---
    num_threads: int = 0
    # PCRD threshold search: 0 = bisection with exact T2 simulations;
    # 1 = the body-rate bisection with an estimate of the header bytes
    rc_algorithm: int = 0

    def resolved_mct(self, num_comps: int, equal_sampling: bool = True) -> bool:
        if not equal_sampling:
            return False  # MCT requires identically-sampled first 3 comps
        if self.mct is None:
            return num_comps >= 3
        return bool(self.mct)

    def validate(self) -> None:
        if not (1 <= self.num_resolutions <= 33):
            raise ParameterError(
                f"num_resolutions {self.num_resolutions} out of [1,33]")
        for d, name in ((self.cblk_width, "cblk_width"),
                        (self.cblk_height, "cblk_height")):
            if d < 4 or d > 1024 or d & (d - 1):
                raise ParameterError(
                    f"{name}={d} must be a power of two in [4,1024]")
        if self.cblk_width * self.cblk_height > 4096:
            raise ParameterError("codeblock area must be <= 4096")
        if self.num_layers < 1 or self.num_layers > 65535:
            raise ParameterError("num_layers out of range")
        if self.layer_rates is not None and len(self.layer_rates) != self.num_layers:
            raise ParameterError("layer_rates length != num_layers")
        if self.layer_psnrs is not None and len(self.layer_psnrs) != self.num_layers:
            raise ParameterError("layer_psnrs length != num_layers")
        if self.layer_rates and self.layer_psnrs:
            # grok_tpu raises this when its rate control starts
            # (tile/tile_processor.py:778-779); here before any work
            raise ValueError("layer_rates and layer_psnrs are exclusive")


@dataclass
class DecompressParams:
    """Decoder configuration; same fields and defaults as grok_tpu's. The
    port decodes with the defaults only (codestream/decompress.py refuses
    any other value by name)."""

    reduce: int = 0  # discard this many highest resolution levels
    max_layers: int = 0  # 0 = all quality layers
    window: tuple[int, int, int, int] | None = None  # (x0, y0, x1, y1) canvas coords
    tile_index: int | None = None  # decode a single tile
    force_rgb: bool = False
    upsample: bool = False
    io_buffer_mb: int = 64
    tile_cache_all: bool = False
    num_threads: int = 0
    max_pixels: int | None = None
