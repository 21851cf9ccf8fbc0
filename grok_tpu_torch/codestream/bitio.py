"""MSB-first bit writer and reader with the JPEG 2000 0xFF stuffing rule
(T.800 B.10.1); counterpart of grok_tpu/codestream/bitio.py.

Whenever an emitted byte equals 0xFF, the following byte carries only 7
payload bits (its MSB is a stuffed 0), so no marker can appear inside a
packet header.
"""

from __future__ import annotations


class BitWriter:
    def __init__(self) -> None:
        self._bytes = bytearray()
        self._buf = 0  # byte being accumulated
        self._ct = 8  # bits still free in _buf

    def write_bit(self, bit: int) -> None:
        if self._ct == 0:
            self._bytes.append(self._buf)
            self._ct = 7 if self._buf == 0xFF else 8
            self._buf = 0
        self._ct -= 1
        if bit:
            self._buf |= 1 << self._ct

    def write_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write_bit((value >> i) & 1)

    def flush(self) -> None:
        """Byte-align; a header never ends on a pending stuff bit, so a
        final 0xFF is followed by the stuffed zero byte."""
        if self._ct < 8:
            self._bytes.append(self._buf)
            if self._buf == 0xFF:
                self._bytes.append(0)
        self._buf = 0
        self._ct = 8

    def getvalue(self) -> bytes:
        return bytes(self._bytes)


class BitReader:
    def __init__(self, data, pos: int = 0) -> None:
        self._data = data
        self._pos = pos
        self._buf = 0
        self._ct = 0
        self._prev_ff = False

    @property
    def byte_pos(self) -> int:
        return self._pos

    def read_bit(self) -> int:
        if self._ct == 0:
            if self._pos >= len(self._data):
                self._buf = 0  # past the end: zeros end tag-tree reads safely
            else:
                self._buf = self._data[self._pos]
                self._pos += 1
            self._ct = 7 if self._prev_ff else 8
            self._prev_ff = self._buf == 0xFF
        self._ct -= 1
        return (self._buf >> self._ct) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def align(self) -> None:
        """Byte-align after a header; after a 0xFF the stuffed byte that
        follows is consumed too."""
        self._ct = 0
        if self._prev_ff:
            if self._pos < len(self._data):
                self._pos += 1
            self._prev_ff = False
