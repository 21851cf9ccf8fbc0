"""Image container (counterpart of grok_tpu/core/image.py, encode side).

Planar per-component storage as host numpy arrays; the tile processor
moves each tile's planes to the device as int32 tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .params import ColorSpace
from .rect import ceil_div


@dataclass
class Component:
    dx: int = 1  # horizontal subsampling on the reference grid
    dy: int = 1
    prec: int = 8  # 1..16 bits
    signed: bool = False
    data: np.ndarray | None = None  # int32 [h, w] in component coords

    # component region on the reference grid (set by Image.finalize)
    x0: int = 0
    y0: int = 0
    w: int = 0
    h: int = 0


@dataclass
class Image:
    """An image on the JPEG 2000 reference grid: ``(x0, y0, x1, y1)`` is the
    image area; components sample it at (dx, dy) strides."""

    x0: int = 0
    y0: int = 0
    x1: int = 0
    y1: int = 0
    components: list[Component] = field(default_factory=list)
    color_space: ColorSpace = ColorSpace.UNKNOWN

    @property
    def num_comps(self) -> int:
        return len(self.components)

    def finalize(self) -> None:
        """Compute per-component regions from the image area (T.800 B.2)."""
        for c in self.components:
            c.x0 = ceil_div(self.x0, c.dx)
            c.y0 = ceil_div(self.y0, c.dy)
            c.w = ceil_div(self.x1, c.dx) - c.x0
            c.h = ceil_div(self.y1, c.dy) - c.y0

    @staticmethod
    def from_array(
        arr: np.ndarray,
        prec: int | None = None,
        signed: bool = False,
        color_space: ColorSpace | None = None,
    ) -> "Image":
        """Build an Image from an [H, W] or [H, W, C] array at origin 0."""
        if arr.ndim == 2:
            arr = arr[:, :, None]
        h, w, nc = arr.shape
        if prec is None:
            if arr.dtype.itemsize == 1:
                prec = 8
            elif arr.dtype == np.uint16:
                prec = 16
            else:
                # the smallest precision covering the data range
                hi = int(arr.max(initial=0))
                lo = int(arr.min(initial=0))
                if signed or lo < 0:
                    signed = True
                    prec = max(hi.bit_length(),
                               (-lo - 1).bit_length() if lo < 0 else 0) + 1
                else:
                    prec = max(hi.bit_length(), 1)
        if color_space is None:
            color_space = ColorSpace.GRAY if nc == 1 else ColorSpace.SRGB
        img = Image(0, 0, w, h, color_space=color_space)
        for i in range(nc):
            img.components.append(Component(
                prec=prec, signed=signed,
                data=np.ascontiguousarray(arr[:, :, i], dtype=np.int32)))
        img.finalize()
        return img
