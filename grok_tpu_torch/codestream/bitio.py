"""MSB-first bit writer with the JPEG 2000 0xFF stuffing rule (T.800
B.10.1); counterpart of the BitWriter half of grok_tpu/codestream/bitio.py.

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
