"""Bit reversal and the LSB-first bit writer (copies of ``reverse_bits``
and ``BitWriter`` from ``swift_png_tpu/utils/bits.py``)."""

from __future__ import annotations


def reverse_bits(value: int, width: int) -> int:
    """Reverse the low ``width`` bits of ``value``."""
    result = 0
    for _ in range(width):
        result = (result << 1) | (value & 1)
        value >>= 1
    return result


class BitWriter:
    """LSB-first bit writer producing a byte buffer (DEFLATE packs bits
    LSB-first within each byte, RFC 1951 §3.1.1)."""

    __slots__ = ("_chunks", "_acc", "_accbits")

    def __init__(self) -> None:
        self._chunks: list[bytes] = []
        self._acc = 0
        self._accbits = 0

    def write(self, value: int, count: int) -> None:
        self._acc |= (value & ((1 << count) - 1)) << self._accbits
        self._accbits += count
        if self._accbits >= 64:
            nbytes = self._accbits >> 3
            self._chunks.append(
                self._acc.to_bytes(nbytes + 8, "little")[:nbytes])
            self._acc >>= 8 * nbytes
            self._accbits -= 8 * nbytes

    def pad_to_byte(self) -> None:
        if self._accbits & 7:
            self._accbits = (self._accbits + 7) & ~7

    def write_bytes(self, data: bytes) -> None:
        self.pad_to_byte()
        self._flush_acc()
        self._chunks.append(bytes(data))

    def _flush_acc(self) -> None:
        nbytes = (self._accbits + 7) >> 3
        if nbytes:
            self._chunks.append(self._acc.to_bytes(nbytes, "little"))
        self._acc = 0
        self._accbits = 0

    def drain(self) -> bytes:
        """Remove and return all completed bytes, leaving any partial byte
        (0–7 bits) in the accumulator."""
        nbytes = self._accbits >> 3
        if nbytes:
            mask = (1 << (8 * nbytes)) - 1
            self._chunks.append((self._acc & mask).to_bytes(nbytes, "little"))
            self._acc >>= 8 * nbytes
            self._accbits -= 8 * nbytes
        out = b"".join(self._chunks)
        self._chunks = []
        return out
