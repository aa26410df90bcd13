"""Gzip (RFC 1952): the streaming compressor and the one-shot helpers (a
copy of ``swift_png_tpu/lz77/gzip.py``; the inflate side,
:class:`~swift_png_tpu_torch._host.lz77.inflate.GzipInflator`, lives with
the other inflators).

The header is the reference's fixed one: no MTIME, XFL 0, OS 0xff
(``Gzip.StreamHeader.swift:86-96``).
"""

from __future__ import annotations

from .checksums import crc32
from .deflate import RawDeflator
from .inflate import GzipInflator

__all__ = ["GzipInflator", "GzipDeflator", "extract", "archive"]

_HEADER = bytes([0x1F, 0x8B, 0x08, 0x00, 0, 0, 0, 0, 0x00, 0xFF])


class GzipDeflator:
    """Streaming gzip compressor (``Gzip.Deflator``): input is compressed
    once more than 4,096 bytes wait or at ``last``; the CRC-32 is folded as
    the input arrives."""

    def __init__(self, level: int = 9, exponent: int = 15,
                 hint: int = 1 << 15) -> None:
        self._raw = RawDeflator(level, exponent)
        self._raw.out.write_bytes(_HEADER)
        self._pending = b""
        self._buffer = bytearray()
        self._finished = False
        self._crc = 0
        self._total = 0
        self.hint = hint

    def push(self, data: bytes, last: bool = False) -> None:
        assert not self._finished
        data = bytes(data)
        self._crc = crc32(data, self._crc)
        self._total += len(data)
        self._pending += data
        if last or len(self._pending) > 4096:
            self._raw.push(self._pending, last)
            self._pending = b""
        if last:
            self._raw.out.write_bytes(
                self._crc.to_bytes(4, "little")
                + (self._total & 0xFFFFFFFF).to_bytes(4, "little"))
            self._finished = True
        self._buffer += self._raw.out.drain()

    def pop(self) -> bytes | None:
        """All the output so far once it reaches ``hint`` bytes (or the
        member is finished), else ``None``."""
        if not self._buffer or (not self._finished
                                and len(self._buffer) < self.hint):
            return None
        return self.pull()

    def pull(self) -> bytes:
        """Drain all available output."""
        out = bytes(self._buffer)
        self._buffer.clear()
        return out


def extract(data: bytes) -> bytes:
    """One-shot gzip decompression (``Gzip.extract``, ``Gzip.swift:6``)."""
    inflator = GzipInflator()
    inflator.push(data)
    return inflator.pull()


def archive(data: bytes, level: int = 9, hint: int = 1 << 15) -> bytes:
    """One-shot gzip compression (``Gzip.archive``, ``Gzip.swift:34``)."""
    deflator = GzipDeflator(level=level, hint=hint)
    deflator.push(data, last=True)
    return deflator.pull()
