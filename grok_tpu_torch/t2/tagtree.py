"""Tag trees (T.800 B.10.2): 2-D quad-tree coding of per-codeblock
inclusion layers and missing-MSB counts inside a precinct. Counterpart of
grok_tpu/t2/tagtree.py."""

from __future__ import annotations

import numpy as np

from ..codestream.bitio import BitReader, BitWriter
from ..core.errors import CorruptPacketError


class TagTree:
    def __init__(self, w: int, h: int):
        self.w = max(w, 0)
        self.h = max(h, 0)
        # level 0 = leaves; halve up to 1x1
        self.levels: list[tuple[int, int]] = []
        lw, lh = max(w, 1), max(h, 1)
        while True:
            self.levels.append((lw, lh))
            if lw == 1 and lh == 1:
                break
            lw = (lw + 1) // 2
            lh = (lh + 1) // 2
        self.values = [np.zeros((lh, lw), dtype=np.int64) for (lw, lh) in self.levels]
        self.lows = [np.zeros((lh, lw), dtype=np.int64) for (lw, lh) in self.levels]
        self.known = [np.zeros((lh, lw), dtype=bool) for (lw, lh) in self.levels]

    def set_values(self, vals: np.ndarray) -> None:
        """Set leaf values [h, w] and propagate mins up the tree."""
        self.values[0][: self.h, : self.w] = vals
        for lvl in range(1, len(self.levels)):
            below = self.values[lvl - 1]
            lw, lh = self.levels[lvl]
            cur = np.full((lh, lw), np.iinfo(np.int64).max, dtype=np.int64)
            for dy in range(2):
                for dx in range(2):
                    part = below[dy::2, dx::2]
                    cur[: part.shape[0], : part.shape[1]] = np.minimum(
                        cur[: part.shape[0], : part.shape[1]], part)
            self.values[lvl] = cur
        for a in self.lows:
            a[:] = 0
        for a in self.known:
            a[:] = False

    def _path(self, x: int, y: int):
        """Nodes root -> leaf as (level, y, x)."""
        out = []
        cx, cy = x, y
        for lvl in range(len(self.levels)):
            out.append((lvl, cy, cx))
            cx //= 2
            cy //= 2
        return list(reversed(out))

    def encode(self, bio: BitWriter, x: int, y: int, threshold: int) -> None:
        tmin = 0
        for (lvl, cy, cx) in self._path(x, y):
            low = self.lows[lvl][cy, cx]
            if low < tmin:
                low = tmin
            val = self.values[lvl][cy, cx]
            while low < threshold and not self.known[lvl][cy, cx]:
                if val > low:
                    bio.write_bit(0)
                    low += 1
                else:
                    bio.write_bit(1)
                    self.known[lvl][cy, cx] = True
            self.lows[lvl][cy, cx] = low
            tmin = low

    def decode(self, bio: BitReader, x: int, y: int, threshold: int) -> bool:
        """Consume bits until 'leaf value < threshold' is decided; True iff
        the leaf value is known and below the threshold."""
        tmin = 0
        for (lvl, cy, cx) in self._path(x, y):
            low = max(self.lows[lvl][cy, cx], tmin)
            while low < threshold and not self.known[lvl][cy, cx]:
                if bio.read_bit():
                    self.known[lvl][cy, cx] = True
                    self.values[lvl][cy, cx] = low
                else:
                    low += 1
            self.lows[lvl][cy, cx] = low
            tmin = low
        return bool(self.known[0][y, x] and self.values[0][y, x] < threshold)

    def decode_value(self, bio: BitReader, x: int, y: int, limit: int = 74) -> int:
        """Fully decode the leaf value (missing-MSB counts)."""
        t = 1
        while not self.decode(bio, x, y, t):
            t += 1
            if t > limit:
                raise CorruptPacketError("tag tree value out of range")
        return int(self.values[0][y, x])
