"""Rectangle / canvas-coordinate math for the JPEG 2000 reference grid
(T.800 Annex B); counterpart of grok_tpu/core/rect.py, trimmed to what the
encoder uses.

All rects are half-open: [x0, x1) x [y0, y1).
"""

from __future__ import annotations

from dataclasses import dataclass


def ceil_div(a: int, b: int) -> int:
    """Ceiling division for non-negative b (a may be any sign)."""
    return -(-a // b)


def ceil_div_pow2(a: int, n: int) -> int:
    """ceil(a / 2**n) for ints (a may be negative)."""
    return -((-a) >> n)


def floor_div_pow2(a: int, n: int) -> int:
    return a >> n


@dataclass(frozen=True)
class Rect:
    x0: int = 0
    y0: int = 0
    x1: int = 0
    y1: int = 0

    @property
    def width(self) -> int:
        return max(0, self.x1 - self.x0)

    @property
    def height(self) -> int:
        return max(0, self.y1 - self.y0)

    @property
    def area(self) -> int:
        return self.width * self.height

    def empty(self) -> bool:
        return self.x1 <= self.x0 or self.y1 <= self.y0

    def intersect(self, o: "Rect") -> "Rect":
        return Rect(
            max(self.x0, o.x0),
            max(self.y0, o.y0),
            min(self.x1, o.x1),
            min(self.y1, o.y1),
        )

    def ceil_div_pow2(self, nx: int, ny: int | None = None) -> "Rect":
        """Map a rect down a dyadic level: ceil(coord / 2**n) on every edge.

        This is the T.800 B.5 resolution/component mapping primitive.
        """
        if ny is None:
            ny = nx
        return Rect(
            ceil_div_pow2(self.x0, nx),
            ceil_div_pow2(self.y0, ny),
            ceil_div_pow2(self.x1, nx),
            ceil_div_pow2(self.y1, ny),
        )
