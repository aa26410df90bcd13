"""Streaming DEFLATE/zlib/gzip inflate on the host (copies of
``RawInflator``, ``Inflator`` and ``GzipInflator`` from
``swift_png_tpu/lz77/inflate.py``).

* push compressed bytes incrementally; decoding resumes where it starved
  (checkpoint and rollback at item granularity);
* pull decompressed bytes (``pull(count)`` returns ``None`` until that
  many bytes exist);
* formats ``zlib`` (RFC 1950 header and Adler-32) and ``ios`` (headerless
  raw DEFLATE with no checksum, the CgBI framing) in :class:`Inflator`,
  ``gzip`` (RFC 1952 header and CRC-32) in :class:`GzipInflator`.

``BatchCodec.decode_filtered(device_inflate=False)`` and the single-image
decoder (:mod:`swift_png_tpu_torch._host.png.decoder`) run this engine.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .checksums import adler32, crc32
from .errors import (DecompressionError, GzipStreamHeaderError,
                     StreamHeaderError)
from .huffman import HuffmanError, decode_table

__all__ = ["RawInflator", "Inflator", "GzipInflator"]


class _Starved(Exception):
    """Internal: not enough input bits yet; roll back to checkpoint."""


def _decode_lists(lengths: np.ndarray, max_len: int) -> tuple[list[int], int]:
    """Flat decode LUT as a Python list of packed (len<<16|sym) ints."""
    table = decode_table(np.asarray(lengths), max_len)
    return table.tolist(), max_len


_FIXED_LITERAL = None
_FIXED_DISTANCE = None


def _fixed_tables() -> tuple[list[int], list[int]]:
    global _FIXED_LITERAL, _FIXED_DISTANCE
    if _FIXED_LITERAL is None:
        _FIXED_LITERAL, _ = _decode_lists(C.FIXED_LITERAL_LENGTHS, 9)
        _FIXED_DISTANCE, _ = _decode_lists(C.FIXED_DISTANCE_LENGTHS, 5)
    return _FIXED_LITERAL, _FIXED_DISTANCE


class RawInflator:
    """DEFLATE block-layer inflator over a growable bit buffer: expect a
    block header, decode the block, ``done`` once the final block ends."""

    def __init__(self) -> None:
        self.data = b""
        self.bitpos = 0
        self.nbits = 0
        self.out = bytearray()
        self.out_base = 0   # bytes released from the front of ``out``
        self.done = False
        # persisted mid-block state (compressed blocks)
        self._block: tuple | None = None  # (final, litlut, litmax, distlut, distmax)
        self._stored: tuple | None = None  # (final, end)

    # -- input management ---------------------------------------------------

    def push(self, data: bytes) -> None:
        self._rebase_input()
        self.data += bytes(data)
        self.nbits = 8 * len(self.data)

    def _rebase_input(self) -> None:
        """Drop consumed input bytes so a long stream needs O(window)
        memory, not O(stream)."""
        shift = self.bitpos >> 3
        if shift < (1 << 16):
            return  # amortize: rebase every ≥64 KB of consumed input
        self.data = self.data[shift:]
        self.bitpos -= 8 * shift
        self.nbits -= 8 * shift

    @property
    def produced(self) -> int:
        """Total decompressed bytes (including released ones)."""
        return self.out_base + len(self.out)

    def release(self, upto: int) -> bytes:
        """Drop output before ``upto`` (absolute), always retaining the
        32 KB LZ77 window; returns the dropped bytes so callers can fold
        their stream checksum incrementally."""
        keep_from = min(upto, self.produced - (1 << 15))
        cut = keep_from - self.out_base
        if cut <= 0:
            return b""
        dropped = bytes(self.out[:cut])
        del self.out[:cut]
        self.out_base = keep_from
        return dropped

    # -- bit primitives (LSB-first, zero-padded peek) -----------------------

    def _peek(self, pos: int, count: int) -> int:
        byte0 = pos >> 3
        window = int.from_bytes(self.data[byte0: byte0 + 9], "little")
        return (window >> (pos & 7)) & ((1 << count) - 1)

    def _read(self, count: int) -> int:
        if self.bitpos + count > self.nbits:
            raise _Starved
        v = self._peek(self.bitpos, count)
        self.bitpos += count
        return v

    # -- the block FSM ------------------------------------------------------

    def advance(self) -> None:
        """Decode as much as possible; returns when starved or done.

        Block headers/tables roll back wholesale on starvation; compressed
        and stored block bodies commit token-by-token (their cursors stay
        consistent with the bytes already appended to ``out``).
        """
        while not self.done:
            if self._block is not None:
                if not self._read_compressed():
                    return
            elif self._stored is not None:
                if not self._read_stored():
                    return
            else:
                checkpoint = self.bitpos
                try:
                    self._read_block_header()
                except _Starved:
                    self.bitpos = checkpoint
                    return

    def _read_block_header(self) -> None:
        final = self._read(1)
        btype = self._read(2)
        if btype == 0:
            # stored block: skip to byte boundary, read LEN/NLEN
            pad = -self.bitpos % 8
            self._read(pad)
            l = self._read(16)
            m = self._read(16)
            if l != (~m & 0xFFFF):
                raise DecompressionError.invalid_block_element_count_parity(
                    l, m)
            self._stored = (final, self.produced + l)
        elif btype == 1:
            lit, dist = _fixed_tables()
            self._block = (final, lit, 9, dist, 5)
        elif btype == 2:
            self._read_dynamic_tables(final)
        else:
            raise DecompressionError.invalid_block_type_code(btype)

    def _read_dynamic_tables(self, final: int) -> None:
        hlit = self._read(5) + 257
        hdist = self._read(5) + 1
        hclen = self._read(4) + 4
        if hlit > 286:
            raise DecompressionError.invalid_huffman_run_literal_symbol_count(
                hlit)
        meta_lengths = np.zeros(19, dtype=np.int64)
        for i in range(hclen):
            meta_lengths[C.CODELENGTH_ORDER[i]] = self._read(3)
        try:
            meta_lut, _ = _decode_lists(meta_lengths, 7)
        except HuffmanError:
            raise DecompressionError.invalid_huffman_codelength_huffman_table(
            ) from None
        if not any(meta_lut):
            raise DecompressionError.invalid_huffman_codelength_huffman_table()

        total = hlit + hdist
        lengths = np.zeros(total, dtype=np.int64)
        i = 0
        while i < total:
            entry = meta_lut[self._peek(self.bitpos, 7)]
            l = entry >> 16
            if l == 0:
                raise DecompressionError.invalid_huffman_codelength_sequence()
            sym = entry & 0xFFFF
            if sym < 16:
                if self.bitpos + l > self.nbits:
                    raise _Starved
                self.bitpos += l
                lengths[i] = sym
                i += 1
            elif sym == 16:
                if self.bitpos + l + 2 > self.nbits:
                    raise _Starved
                self.bitpos += l
                repeat = 3 + self._read(2)
                if i == 0 or i + repeat > total:
                    raise DecompressionError.invalid_huffman_codelength_sequence()
                lengths[i: i + repeat] = lengths[i - 1]
                i += repeat
            elif sym == 17:
                if self.bitpos + l + 3 > self.nbits:
                    raise _Starved
                self.bitpos += l
                repeat = 3 + self._read(3)
                if i + repeat > total:
                    raise DecompressionError.invalid_huffman_codelength_sequence()
                i += repeat
            else:  # 18
                if self.bitpos + l + 7 > self.nbits:
                    raise _Starved
                self.bitpos += l
                repeat = 11 + self._read(7)
                if i + repeat > total:
                    raise DecompressionError.invalid_huffman_codelength_sequence()
                i += repeat

        lit_lengths = lengths[:hlit]
        dist_lengths = lengths[hlit:]
        if lit_lengths[lit_lengths > 0].size == 0:
            raise DecompressionError.invalid_huffman_table()
        try:
            lit_lut, _ = _decode_lists(lit_lengths, 15)
            dist_lut, _ = _decode_lists(dist_lengths, 15)
        except HuffmanError:
            raise DecompressionError.invalid_huffman_table() from None
        self._block = (final, lit_lut, 15, dist_lut, 15)

    def _read_stored(self) -> bool:
        final, end = self._stored
        need = end - self.produced
        assert self.bitpos % 8 == 0
        avail = (self.nbits - self.bitpos) >> 3
        take = min(need, avail)
        start = self.bitpos >> 3
        self.out += self.data[start: start + take]
        self.bitpos += 8 * take
        if self.produced == end:
            self._stored = None
            self.done = bool(final)
            return True
        return False

    def _read_compressed(self) -> bool:
        """The token loop.  Returns ``True`` when the block's end-of-block
        symbol was consumed, ``False`` when starved at a token boundary."""
        final, lit_lut, lit_max, dist_lut, dist_max = self._block
        out = self.out
        data = self.data
        nbits = self.nbits
        pos = self.bitpos
        lit_mask = (1 << lit_max) - 1
        dist_mask = (1 << dist_max) - 1
        run_base = C.RUN_BASE
        run_extra = C.RUN_EXTRA
        dist_base = C.DISTANCE_BASE
        dist_extra = C.DISTANCE_EXTRA
        try:
            while True:
                start = pos
                byte0 = pos >> 3
                window = int.from_bytes(data[byte0: byte0 + 9],
                                        "little") >> (pos & 7)
                entry = lit_lut[window & lit_mask]
                l = entry >> 16
                if pos + l > nbits or l == 0:
                    if pos + lit_max > nbits:
                        return False  # starved at a token boundary
                    raise DecompressionError.invalid_huffman_table()
                sym = entry & 0xFFFF
                if sym < 256:
                    pos += l
                    out.append(sym)
                    continue
                if sym == 256:
                    pos += l
                    self._block = None
                    self.done = bool(final)
                    return True
                if sym > 285:
                    raise DecompressionError.invalid_huffman_table()
                window >>= l
                decade = sym - 257
                eb = int(run_extra[decade])
                consumed = l + eb
                if start + consumed > nbits:
                    return False
                run = int(run_base[decade]) + (window & ((1 << eb) - 1))
                window >>= eb
                entry = dist_lut[window & dist_mask]
                dl = entry >> 16
                if dl == 0 or start + consumed + dl > nbits:
                    if start + consumed + dist_max > nbits:
                        return False
                    raise DecompressionError.invalid_string_reference()
                dsym = entry & 0xFFFF
                if dsym > 29:
                    raise DecompressionError.invalid_string_reference()
                window >>= dl
                consumed += dl
                db = int(dist_extra[dsym])
                consumed += db
                if start + consumed > nbits:
                    return False
                distance = int(dist_base[dsym]) + (window & ((1 << db) - 1))
                pos = start + consumed
                n = len(out)
                if distance > n + self.out_base:
                    raise DecompressionError.invalid_string_reference()
                if distance >= run:
                    out += out[n - distance: n - distance + run]
                else:
                    # overlapping copy — forward byte semantics
                    chunk = out[n - distance:]
                    repeats = run // distance + 1
                    out += (chunk * repeats)[:run]
        finally:
            self.bitpos = pos


class Inflator:
    """Streaming inflate of the ``zlib`` and ``ios`` formats."""

    def __init__(self, format: str = "zlib") -> None:
        if format not in ("zlib", "ios"):
            raise ValueError(f"unknown format {format!r}")
        self.format = format
        self._raw = RawInflator()
        self._state = "initial" if format == "zlib" else "block"
        self._read_cursor = 0
        self._integral = 1  # Adler-32 folded over released output
        self.window_exponent = 15

    # -- container FSM ------------------------------------------------------

    def push(self, data: bytes) -> None:
        self._raw.push(data)
        self._advance()

    def _advance(self) -> None:
        raw = self._raw
        if self._state == "initial":
            if raw.nbits - raw.bitpos >= 16:
                self._read_zlib_header()
                self._state = "block"
            else:
                return
        if self._state == "block":
            raw.advance()
            if raw.done:
                self._state = "checksum"
        if self._state == "checksum":
            if self.format == "ios":
                self._state = "terminal"
                return
            aligned = (raw.bitpos + 7) & ~7
            if raw.nbits - aligned >= 32:
                raw.bitpos = aligned
                declared = int.from_bytes(
                    raw.data[raw.bitpos >> 3: (raw.bitpos >> 3) + 4], "big")
                raw.bitpos += 32
                computed = adler32(raw.out, self._integral)
                if computed != declared:
                    raise DecompressionError.invalid_stream_checksum(
                        declared, computed)
                self._state = "terminal"

    def _read_zlib_header(self) -> None:
        raw = self._raw
        cmf = raw._read(8)
        flg = raw._read(8)
        if cmf & 0x0F != 0x08:
            raise StreamHeaderError.invalid_compression_method(cmf & 0x0F)
        e = cmf >> 4
        if e >= 8:
            raise StreamHeaderError.invalid_window_size(e + 8)
        if (cmf * 256 + flg) % 31 != 0:
            raise StreamHeaderError.invalid_check_bits()
        if flg & 0x20:
            raise StreamHeaderError.unexpected_dictionary()
        self.window_exponent = 8 + e

    # -- output -------------------------------------------------------------

    def pull(self, count: int | None = None) -> bytes | None:
        """Pull exactly ``count`` bytes (or ``None`` if unavailable); with no
        argument, pull everything decoded so far.  Pulled bytes beyond the
        32 KB window are released, with the Adler-32 folded over them."""
        raw = self._raw
        start = self._read_cursor - raw.out_base
        avail = raw.produced - self._read_cursor
        if count is None:
            out = bytes(raw.out[start:])
            self._read_cursor = raw.produced
        elif avail < count:
            return None
        else:
            out = bytes(raw.out[start: start + count])
            self._read_cursor += count
        self._integral = adler32(raw.release(self._read_cursor),
                                 self._integral)
        return out

    @property
    def terminal(self) -> bool:
        return self._state == "terminal"


class GzipInflator:
    """Streaming gzip inflate (``Gzip.Inflator``): the RFC 1952 header
    (FEXTRA, FNAME and FCOMMENT skipped, FHCRC refused), the DEFLATE blocks
    and the CRC-32 trailer (``Gzip.StreamHeader.swift:19-84``)."""

    def __init__(self) -> None:
        self._raw = RawInflator()
        self._state = "initial"
        self._read_cursor = 0
        self._integral = 0  # CRC-32 folded over released output
        self._skip = 0
        self._strings = 0

    def push(self, data: bytes) -> None:
        self._raw.push(data)
        self._advance()

    def _advance(self) -> None:
        raw = self._raw
        if self._state == "initial":
            if not self._read_header():
                return
        if self._state == "strings":
            if not self._skip_strings():
                return
        if self._state == "block":
            raw.advance()
            if raw.done:
                self._state = "checksum"
        if self._state == "checksum":
            aligned = (raw.bitpos + 7) & ~7
            if raw.nbits - aligned >= 64:
                raw.bitpos = aligned
                base = raw.bitpos >> 3
                declared = int.from_bytes(raw.data[base: base + 4], "little")
                # ISIZE (the length modulo 2^32) is read past, not checked
                raw.bitpos += 64
                computed = crc32(raw.out, self._integral)
                if computed != declared:
                    raise DecompressionError.invalid_stream_checksum(
                        declared, computed)
                self._state = "terminal"

    def _read_header(self) -> bool:
        raw = self._raw
        if raw.nbits - raw.bitpos < 80:
            return False
        base = raw.bitpos >> 3
        hdr = raw.data[base: base + 10]
        if hdr[0] != 0x1F or hdr[1] != 0x8B:
            raise GzipStreamHeaderError.invalid_sigil()
        if hdr[2] != 0x08:
            raise GzipStreamHeaderError.invalid_compression_method(hdr[2])
        flags = hdr[3]
        if flags & 0b1110_0000:
            raise GzipStreamHeaderError.invalid_flag_bits(flags)
        if flags & 0x02:
            raise GzipStreamHeaderError.header_checksum_unsupported()
        xlen = 0
        consumed = 80
        if flags & 0x04:
            if raw.nbits - raw.bitpos < 96:
                return False
            xlen = int.from_bytes(raw.data[base + 10: base + 12], "little")
            consumed = 96
        raw.bitpos += consumed
        self._skip = 8 * xlen
        self._strings = (1 if flags & 0x08 else 0) + (1 if flags & 0x10
                                                      else 0)
        self._state = "strings" if (self._skip or self._strings) else "block"
        return True

    def _skip_strings(self) -> bool:
        raw = self._raw
        if self._skip:
            if raw.bitpos + self._skip > raw.nbits:
                return False
            raw.bitpos += self._skip
            self._skip = 0
        while self._strings:
            # the NUL that ends FNAME or FCOMMENT
            idx = raw.data.find(b"\x00", raw.bitpos >> 3)
            if idx < 0:
                return False
            raw.bitpos = 8 * (idx + 1)
            self._strings -= 1
        self._state = "block"
        return True

    def pull(self, count: int | None = None) -> bytes | None:
        """As :meth:`Inflator.pull`, with the CRC-32 folded over the
        released output."""
        raw = self._raw
        start = self._read_cursor - raw.out_base
        avail = raw.produced - self._read_cursor
        if count is None:
            out = bytes(raw.out[start:])
            self._read_cursor = raw.produced
        elif avail < count:
            return None
        else:
            out = bytes(raw.out[start: start + count])
            self._read_cursor += count
        self._integral = crc32(raw.release(self._read_cursor),
                               self._integral)
        return out

    @property
    def terminal(self) -> bool:
        return self._state == "terminal"
