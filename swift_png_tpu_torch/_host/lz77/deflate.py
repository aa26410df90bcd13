"""The host DEFLATE encoder: the level table, the ``Depths`` cost model,
the hash-chain window, block serialization and the streaming
``RawDeflator``/``Deflator`` with their greedy, lazy and full
(minimum-cost path) strategies, and the ``NativeDeflator`` over the native
library with the ``make_deflator`` that picks between them (copies of
``search_parameters`` through ``make_deflator`` in
``swift_png_tpu/lz77/deflate.py``).

Levels 0–3 are greedy, 4–7 lazy and 8–13 the full strategy; greedy and
lazy emit a match only when its run is 6 or more.  The Python engine is
what the batched encoder runs for levels <= 7 without the native library;
the ``iCCP`` and compressed text chunks and gzip deflate with it, and the
single-image encoder with the engine that ``make_deflator`` picks.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .checksums import adler32
from .huffman import canonical_codes, lengths_from_frequencies
from ..bits import BitWriter, reverse_bits

GREEDY, LAZY, FULL = 0, 1, 2


def search_parameters(level: int) -> tuple[int, int, int, int]:
    """Return (strategy, attempts, goal, iterations) for a compression
    level."""
    table = {
        0: (GREEDY, 1, 6, 0),
        1: (GREEDY, 2, 8, 0),
        2: (GREEDY, 4, 10, 0),
        3: (GREEDY, 40, 24, 0),
        4: (LAZY, 20, 32, 0),
        5: (LAZY, 40, 54, 0),
        6: (LAZY, 64, 80, 0),
        7: (LAZY, 100, 160, 0),
        8: (FULL, 14, 20, 1),
        9: (FULL, 20, 32, 2),
        10: (FULL, 30, 50, 3),
        11: (FULL, 60, 80, 4),
        12: (FULL, 100, 133, 5),
    }
    if level <= 0:
        return table[0]
    if level >= 13:
        return (FULL, 1 << 30, 258, 6)
    return table[level]


def _default_depths() -> np.ndarray:
    d = np.zeros(542, dtype=np.uint32)
    d[:256] = 33  # literal: 8.25 bits
    runs = np.arange(3, 259)
    d[256:512] = 30 + (C.RUN_EXTRA[C.RUN_DECADE[runs]] << 2)  # 7.5 bits base
    d[512:542] = 19 + (C.DISTANCE_EXTRA << 2)  # 4.75 bits base
    return d


class Depths:
    """Adaptive cost table of the optimal parse, in quarter bits.

    Layout: [0,256) literal costs, [256,512) run costs for lengths 3…258,
    [512,542) distance-decade costs.
    """

    def __init__(self) -> None:
        self.storage = _default_depths()
        self.generic = True

    def update(self, lit_lengths: np.ndarray,
               dist_lengths: np.ndarray) -> None:
        s = self.storage
        for sym in range(min(286, lit_lengths.size)):
            l = int(lit_lengths[sym])
            if l == 0:
                continue
            if sym < 256:
                s[sym] = l << 2
            elif sym > 256:
                decade = sym - 257
                extra = int(C.RUN_EXTRA[decade])
                base = int(C.RUN_BASE[decade])
                lo = 253 + base
                s[lo: min(lo + (1 << extra), 512)] = (l + extra) << 2
        for sym in range(min(30, dist_lengths.size)):
            l = int(dist_lengths[sym])
            if l:
                s[512 + sym] = (l + int(C.DISTANCE_EXTRA[sym])) << 2
        self.generic = False

    def generalize(self) -> None:
        d = _default_depths()
        s = self.storage
        self.storage = (s & d) + ((s ^ d) >> 1)


class Window:
    """Exact-4-byte-key hash chains over the input history.

    The reference chains window slots through ``Element.next``
    (``LZ77.DeflatorWindow.swift:78-113``); here ``head`` maps the exact
    4-byte key to the most recent absolute position and ``prev`` (sized to
    the window) chains to earlier positions with the same key.
    """

    __slots__ = ("exponent", "mask", "head", "prev")

    def __init__(self, exponent: int) -> None:
        self.exponent = exponent
        self.mask = (1 << exponent) - 1
        self.head: dict[int, int] = {}
        self.prev = np.full(1 << exponent, -1, dtype=np.int64)

    def insert(self, data: bytes, pos: int) -> int:
        """Insert position ``pos`` (requires 4 bytes available); returns the
        previous head position for the same key, or -1."""
        key = (data[pos] | data[pos + 1] << 8 | data[pos + 2] << 16
               | data[pos + 3] << 24)
        nxt = self.head.get(key, -1)
        self.head[key] = pos
        self.prev[pos & self.mask] = nxt
        return nxt

    def candidates(self, pos: int, first: int, attempts: int):
        """Yield chain positions (newest first) within the window."""
        # the reference treats a distance ≥ mask as out of range
        window = self.mask
        cur = first
        remaining = attempts
        while cur >= 0 and remaining > 0 and pos - cur < window:
            yield cur
            remaining -= 1
            nxt = int(self.prev[cur & self.mask])
            if nxt >= cur:  # slot overwritten by a newer position
                break
            cur = nxt


def _match_length(data: bytes, cand: int, pos: int, limit: int) -> int:
    """Length of the match between ``cand`` and ``pos`` (≥4 guaranteed by the
    exact key), allowing self-referential overlap, capped at ``limit``."""
    n = 4
    while n < limit and data[cand + n] == data[pos + n]:
        n += 1
    return n


# ---------------------------------------------------------------------------
# term packing (LZ77.DeflatorTerm.swift)
# ---------------------------------------------------------------------------

def _pack_literal(value: int) -> int:
    return 0xF800_0000 | value


def _pack_match(run: int, distance: int) -> int:
    rd = int(C.RUN_DECADE[run])
    dd = int(C.DISTANCE_DECADE[distance])
    return (
        (dd << 27)
        | ((distance - int(C.DISTANCE_BASE[dd])) << 14)
        | ((run - int(C.RUN_BASE[rd])) << 9)
        | 0x100
        | rd
    )


def _metaterms(lengths: list[int]) -> list[tuple[int, int]]:
    """Code-length RLE → (symbol, extra-bits value) metaterms."""
    terms: list[tuple[int, int]] = []
    i = 0
    n = len(lengths)
    while i < n:
        value = lengths[i]
        j = i
        while j < n and lengths[j] == value:
            j += 1
        reps = j - i
        if value == 0:
            while reps > 138:
                terms.append((18, 138 - 11))
                reps -= 138
            if reps > 10:
                terms.append((18, reps - 11))
            elif reps > 2:
                terms.append((17, reps - 3))
            else:
                terms.extend([(0, 0)] * reps)
        else:
            terms.append((value, 0))
            reps -= 1
            while reps > 6:
                terms.append((16, 6 - 3))
                reps -= 6
            if reps > 2:
                terms.append((16, reps - 3))
            else:
                terms.extend([(value, 0)] * reps)
        i = j
    return terms


_META_EXTRA = {16: 2, 17: 3, 18: 7}


def _write_dynamic_block(
    out: BitWriter, terms: list[int], final: bool,
    lit_lengths: np.ndarray, dist_lengths: np.ndarray,
) -> None:
    """Serialize one dynamic (BTYPE=2) block from packed terms.

    (``…Buffers.Stream.swift:440-708``.)
    """
    lit_codes = canonical_codes(lit_lengths)
    dist_codes = canonical_codes(dist_lengths)
    # bit-reversed codewords for LSB-first emission
    lit_emit = [
        (reverse_bits(int(lit_codes[s]), int(lit_lengths[s])),
         int(lit_lengths[s]))
        for s in range(lit_lengths.size)
    ]
    dist_emit = [
        (reverse_bits(int(dist_codes[s]), int(dist_lengths[s])),
         int(dist_lengths[s]))
        for s in range(dist_lengths.size)
    ]

    r = max(257, int(np.max(np.nonzero(lit_lengths)[0], initial=0)) + 1)
    used_d = np.nonzero(dist_lengths)[0]
    d = max(1, int(used_d.max()) + 1 if used_d.size else 1)

    sequence = [int(lit_lengths[s]) for s in range(r)] + [
        int(dist_lengths[s]) if s < dist_lengths.size else 0 for s in range(d)
    ]
    meta = _metaterms(sequence)

    meta_freq = np.zeros(19, dtype=np.int64)
    for sym, _ in meta:
        meta_freq[sym] += 1
    meta_lengths = lengths_from_frequencies(meta_freq, 7, force=False)
    meta_codes = canonical_codes(meta_lengths)
    meta_emit = [
        (reverse_bits(int(meta_codes[s]), int(meta_lengths[s])),
         int(meta_lengths[s]))
        for s in range(19)
    ]

    # HCLEN: number of transmitted code-length lengths (≥4), trailing zeros
    # in transmission order trimmed (``…Stream.swift:577-612``)
    order_lengths = [int(meta_lengths[sym]) for sym in C.CODELENGTH_ORDER]
    hclen = 19
    while hclen > 4 and order_lengths[hclen - 1] == 0:
        hclen -= 1

    out.write(1 if final else 0, 1)
    out.write(2, 2)
    out.write(r - 257, 5)
    out.write(d - 1, 5)
    out.write(hclen - 4, 4)
    for i in range(hclen):
        out.write(order_lengths[i], 3)
    for sym, extra in meta:
        bits, length = meta_emit[sym]
        out.write(bits, length)
        eb = _META_EXTRA.get(sym, 0)
        if eb:
            out.write(extra, eb)

    run_base = C.RUN_BASE
    dist_base = C.DISTANCE_BASE
    run_extra = C.RUN_EXTRA
    dist_extra = C.DISTANCE_EXTRA
    for term in terms:
        if term >> 27 == 31 and not term & 0x100:
            bits, length = lit_emit[term & 0xFF]
            out.write(bits, length)
        else:
            rd = term & 0xFF
            dd = term >> 27
            bits, length = lit_emit[257 + rd]
            out.write(bits, length)
            eb = int(run_extra[rd])
            if eb:
                out.write((term >> 9) & 0x1F, eb)
            bits, length = dist_emit[dd]
            out.write(bits, length)
            eb = int(dist_extra[dd])
            if eb:
                out.write((term >> 14) & 0x1FFF, eb)
    del run_base, dist_base
    bits, length = lit_emit[256]
    out.write(bits, length)


def _write_stored_block(out: BitWriter, data: bytes, final: bool) -> None:
    out.write(1 if final else 0, 1)
    out.write(0, 2)
    out.pad_to_byte()
    out.write(len(data), 16)
    out.write(~len(data) & 0xFFFF, 16)
    out.write_bytes(data)


# ---------------------------------------------------------------------------
# the encoder core
# ---------------------------------------------------------------------------

#: term-buffer capacity per emitted block.  The reference flushes every 2047
#: terms (``LZ77.DeflatorMatches.swift:59-66``); a larger budget means
#: fewer table headers and a better ratio.
BLOCK_TERMS = 16384
GRAPH_NODES = 16384


class _SlidingBytes:
    """Byte buffer addressed by ABSOLUTE stream offsets with a released
    prefix — the ``LZ77.DeflatorIn`` O(window) analog
    (``Sources/LZ77/Deflator/LZ77.DeflatorIn.swift:158-200``)."""

    __slots__ = ("buf", "base")

    def __init__(self) -> None:
        self.buf = bytearray()
        self.base = 0

    def __len__(self) -> int:
        return self.base + len(self.buf)

    def __getitem__(self, i):
        if isinstance(i, slice):
            start = (0 if i.start is None else i.start) - self.base
            stop = (len(self) if i.stop is None else i.stop) - self.base
            return bytes(self.buf[max(start, 0):max(stop, 0)])
        return self.buf[i - self.base]

    def extend(self, b) -> None:
        self.buf += b

    def trim(self, keep_from: int) -> bytes:
        """Release bytes before ``keep_from``; returns them for checksum
        folding."""
        cut = keep_from - self.base
        if cut <= 0:
            return b""
        dropped = bytes(self.buf[:cut])
        del self.buf[:cut]
        self.base = keep_from
        return dropped


class RawDeflator:
    """DEFLATE block-layer encoder over accumulated input."""

    def __init__(self, level: int, exponent: int = 15) -> None:
        (self.strategy, self.attempts, self.goal,
         self.iterations) = search_parameters(level)
        self.exponent = exponent
        self.window = Window(exponent)
        self.depths = Depths()
        self.data = _SlidingBytes()
        self.integral = 1  # Adler-32 over released input
        self.pos = 0  # next unprocessed byte
        self.inserted = 0  # next position to insert into the hash chains
        self.out = BitWriter()
        self.finished = False

    # -- public ---------------------------------------------------------

    def push(self, data: bytes, last: bool = False) -> None:
        assert not self.finished
        self.data.extend(bytes(data))
        self._compress(last)
        if last:
            self.finished = True
        else:
            # release input more than a window behind the parse cursor,
            # folding the stream checksum over what leaves the buffer
            keep_from = min(self.pos, self.inserted) - (1 << self.exponent) - 8
            if keep_from - self.data.base >= (1 << 16):
                self.integral = adler32(self.data.trim(keep_from),
                                        self.integral)

    def checksum(self) -> int:
        """Adler-32 of the complete input (released prefix + live tail)."""
        return adler32(self.data.buf, self.integral)

    # -- helpers ---------------------------------------------------------

    def _insert_upto(self, pos: int) -> None:
        """Insert hash keys for every position < pos (with 4 bytes there)."""
        data = self.data
        hi = min(pos, len(data) - 3)
        w = self.window
        for p in range(self.inserted, hi):
            w.insert(data, p)
        self.inserted = max(self.inserted, hi)

    def _best_match(self, pos: int, limit: int) -> tuple[int, int]:
        """Best (run, distance) from the chains at ``pos`` (run may be < 4 ⇒
        no match).  Chain walk respects attempts/goal like
        ``DeflatorWindow.match`` (``…Window.swift:115-212``)."""
        if limit < 4 or pos + 4 > len(self.data):
            return 0, 0
        data = self.data
        # position ``pos`` is already inserted; its prev pointer is the chain
        # head excluding ``pos`` itself (reference: match walks head.next)
        first = int(self.window.prev[pos & self.window.mask])
        best_run, best_dist = 0, 0
        for cand in self.window.candidates(pos, first, self.attempts):
            if cand >= pos:
                continue
            run = _match_length(data, cand, pos, limit)
            if run > best_run:
                best_run, best_dist = run, pos - cand
                if run >= self.goal or run >= limit:
                    break
        return best_run, best_dist

    def _all_matches(self, pos: int, limit: int) -> list[tuple[int, int]]:
        """All chain candidates for the match DAG (full strategy)."""
        if limit < 4 or pos + 4 > len(self.data):
            return []
        data = self.data
        first = int(self.window.prev[pos & self.window.mask])
        results = []
        for cand in self.window.candidates(pos, first, self.attempts):
            if cand >= pos:
                continue
            run = _match_length(data, cand, pos, limit)
            results.append((run, pos - cand))
            if run >= self.goal:
                break
        return results

    # -- strategies -------------------------------------------------------

    def _compress(self, last: bool) -> None:
        # hold back a full lookahead margin unless finalizing, so matches
        # never get truncated at a push boundary (compress(all:) lookahead,
        # ``…Buffers.Stream.swift:222-227``)
        margin = 0 if last else 262
        end = len(self.data) - margin
        if self.strategy == FULL:
            self._compress_full(end, last)
        else:
            self._compress_greedy_lazy(end, last)

    def _emit_terms(self, terms: list[int], final: bool) -> None:
        freq = np.zeros(320, dtype=np.int64)
        for term in terms:
            if term >> 27 == 31 and not term & 0x100:
                freq[term & 0xFF] += 1
            else:
                freq[257 + (term & 0xFF)] += 1
                freq[288 + (term >> 27)] += 1
        freq[256] = 1
        lit_lengths = lengths_from_frequencies(freq[:286], 15, force=True)
        dist_lengths = lengths_from_frequencies(freq[288:318], 15, force=False)
        _write_dynamic_block(self.out, terms, final, lit_lengths, dist_lengths)

    def _compress_greedy_lazy(self, end: int, last: bool) -> None:
        data = self.data
        lazy = self.strategy == LAZY
        terms: list[int] = []
        pos = self.pos
        while pos < end:
            if len(terms) >= BLOCK_TERMS:
                self._emit_terms(terms, False)
                terms = []
            limit = min(len(data) - pos, 258)
            self._insert_upto(pos + 1)
            run, dist = self._best_match(pos, limit)
            if run >= 6:
                if lazy and pos + 1 < end:
                    self._insert_upto(pos + 2)
                    run2, dist2 = self._best_match(
                        pos + 1, min(len(data) - pos - 1, 258))
                    if run2 > run:
                        terms.append(_pack_literal(data[pos]))
                        terms.append(_pack_match(run2, dist2))
                        self._insert_upto(pos + 1 + run2)
                        pos += 1 + run2
                        continue
                terms.append(_pack_match(run, dist))
                self._insert_upto(pos + run)
                pos += run
            else:
                terms.append(_pack_literal(data[pos]))
                pos += 1
        self.pos = pos
        if not last:
            if terms:
                self._emit_terms(terms, False)
            return
        remaining = len(data) - pos
        if terms or remaining >= 3 or (remaining and pos > 0):
            # consume the tail as literals inside the final dynamic block
            for p in range(pos, len(data)):
                terms.append(_pack_literal(data[p]))
            self.pos = len(data)
            self._emit_terms(terms, True)
        else:
            # entire stream shorter than 3 bytes → final stored block
            # (``…Buffers.Stream.swift:43-60``)
            tail = data[pos:]
            self.pos = len(data)
            _write_stored_block(self.out, tail, True)

    def _compress_full(self, end: int, last: bool) -> None:
        data = self.data
        pos = self.pos
        while True:
            remaining = end - pos
            if not last and remaining < GRAPH_NODES:
                break  # wait for more input to fill a whole graph
            if last and remaining < 3:
                # 0–2 byte tail → final stored block
                # (``…Buffers.Stream.swift:43-60``)
                _write_stored_block(self.out, data[pos:end], True)
                pos = end
                break
            node_end = min(end, pos + GRAPH_NODES)
            final = last and node_end == end
            terms = self._optimal_parse(pos, node_end)
            self._emit_terms_full(terms, final)
            pos = node_end
            if final:
                break
        self.pos = pos

    def _optimal_parse(self, start: int, stop: int) -> list[int]:
        """Minimum-cost path over the match DAG for data[start:stop].

        Mirrors ``DeflatorMatches.minimize/explore``
        (``…Matches.swift:265-379``) with the same adaptive ``Depths`` cost
        model and per-level refinement iterations.

        This pure-Python tier is O(n · edges · runlen) and impractical
        past ~64 KB inputs: the batched encoder's levels 8–13 run the
        device parse (``ops.deflate_optimal``) or ``native.deflate``.
        """
        data = self.data
        n = stop - start
        iterations = self.iterations * (2 if self.depths.generic else 1)
        # gather edges once: per node, list of (run, distance)
        edges: list[list[tuple[int, int]]] = []
        for p in range(start, stop):
            limit = min(len(data) - p, 258, stop - p)
            self._insert_upto(p + 1)
            edges.append(self._all_matches(p, limit))
            # skip-ahead for very long matches (degenerate-input guard,
            # ``…Buffers.Stream.swift:369-374``)

        terms: list[int] = []
        for it in range(max(1, iterations)):
            depths = self.depths.storage
            INF = 1 << 60
            cost = [INF] * (n + 1)
            cost[0] = 0
            from_len = [0] * (n + 1)  # chosen source edge length
            from_dist = [0] * (n + 1)
            for i in range(n):
                ci = cost[i]
                if ci >= INF:
                    continue
                # literal edge
                c = ci + int(depths[data[start + i]])
                if c < cost[i + 1]:
                    cost[i + 1] = c
                    from_len[i + 1] = 1
                    from_dist[i + 1] = 0
                if n - i < 3:
                    continue
                for run, dist in edges[i]:
                    dd = int(C.DISTANCE_DECADE[dist])
                    dc = ci + int(depths[512 + dd])
                    maxlen = min(run, n - i)
                    for length in range(3, maxlen + 1):
                        c = dc + int(depths[253 + length])
                        if c < cost[i + length]:
                            cost[i + length] = c
                            from_len[i + length] = length
                            from_dist[i + length] = dist
            # backtrack
            terms = []
            i = n
            while i > 0:
                length = from_len[i]
                if length == 1:
                    terms.append(_pack_literal(data[start + i - 1]))
                else:
                    terms.append(_pack_match(length, from_dist[i]))
                i -= length
            terms.reverse()
            if it + 1 < max(1, iterations):
                # refine cost model from this parse's tree
                freq = np.zeros(320, dtype=np.int64)
                for term in terms:
                    if term >> 27 == 31 and not term & 0x100:
                        freq[term & 0xFF] += 1
                    else:
                        freq[257 + (term & 0xFF)] += 1
                        freq[288 + (term >> 27)] += 1
                freq[256] = 1
                lit = lengths_from_frequencies(freq[:286], 15, force=True)
                dist = lengths_from_frequencies(freq[288:318], 15, force=False)
                self.depths.update(lit, dist)
        return terms

    def _emit_terms_full(self, terms: list[int], final: bool) -> None:
        self._emit_terms(terms, final)
        self.depths.generalize()


class Deflator:
    """The public streaming deflater for ``zlib`` / ``ios`` formats.

    ``LZ77.Deflator`` counterpart
    (``Sources/LZ77/Deflator/LZ77.Deflator.swift:8-44``); flush policy mirrors
    ``DeflatorBuffers.push`` (compress when buffered input > 4096 or last,
    ``…Buffers.swift:68-94``).
    """

    def __init__(self, format: str = "zlib", level: int = 9,
                 exponent: int = 15, hint: int = 1 << 15) -> None:
        if format not in ("zlib", "ios"):
            raise ValueError(f"unknown format {format!r}")
        if not 8 <= exponent <= 15:
            raise ValueError(
                "exponent cannot be less than 8 or greater than 15")
        self.format = format
        self.hint = hint
        if format == "ios":
            exponent = 15
        self._raw = RawDeflator(level, exponent)
        self._pending = b""
        self._buffer = bytearray()
        self._finished = False
        if format == "zlib":
            # FLG check bits exactly as the reference computes them
            # (``LZ77.StreamHeader.swift:56-62``): FLEVEL=0, FDICT=0
            cmf = (exponent - 8) << 4 | 0x08
            flg = ~((cmf * 256) % 31) & 31
            self._raw.out.write_bytes(bytes([cmf, flg]))

    def push(self, data: bytes, last: bool = False) -> None:
        assert not self._finished
        self._pending += bytes(data)
        if last or len(self._pending) > 4096:
            self._raw.push(self._pending, last)
            self._pending = b""
        if last:
            if self.format == "zlib":
                self._raw.out.write_bytes(
                    self._raw.checksum().to_bytes(4, "big")
                )
            else:
                self._raw.out.pad_to_byte()
            self._finished = True
        self._buffer += self._raw.out.drain()

    def pop(self) -> bytes | None:
        """Return a completed output chunk of at least ``hint`` bytes, else
        ``None`` (reference ``Deflator.pop``)."""
        if not self._buffer or (not self._finished
                                and len(self._buffer) < self.hint):
            return None
        out = bytes(self._buffer)
        self._buffer.clear()
        return out

    def pull(self) -> bytes:
        """Drain all available output."""
        out = bytes(self._buffer)
        self._buffer.clear()
        return out


class NativeDeflator:
    """``Deflator``'s push/pop/pull surface over the native engine.

    The input is gathered and compressed in one call at ``last`` (the
    engine blocks it itself), then handed out in ``hint``-sized pieces,
    which become the image's IDAT chunks (``PNG.Image.swift:568-574``) and
    keep each under the 2^31 − 1 byte chunk limit.
    """

    def __init__(self, format: str = "zlib", level: int = 9,
                 exponent: int = 15, hint: int = 1 << 15) -> None:
        if format not in ("zlib", "ios"):
            raise ValueError(f"unknown format {format!r}")
        if not 8 <= exponent <= 15:
            raise ValueError(
                "exponent cannot be less than 8 or greater than 15")
        self.format = format
        self.level = level
        self.exponent = exponent
        self.hint = max(1, hint)
        self._parts: list[bytes] = []
        self._out = b""
        self._cursor = 0
        self._finished = False

    def push(self, data: bytes, last: bool = False) -> None:
        assert not self._finished
        self._parts.append(bytes(data))
        if last:
            from .. import native

            self._out = native.deflate(b"".join(self._parts), self.level,
                                       self.format, exponent=self.exponent)
            self._finished = True

    def pop(self) -> bytes | None:
        """The next ``hint``-sized piece, or ``None`` before ``last``."""
        if len(self._out) - self._cursor <= 0:
            return None
        return self.pull()

    def pull(self) -> bytes:
        """The next ``hint``-sized piece (empty once all are out)."""
        take = min(len(self._out) - self._cursor, self.hint)
        out = self._out[self._cursor: self._cursor + take]
        self._cursor += take
        return out


def make_deflator(format: str = "zlib", level: int = 9, exponent: int = 15,
                  hint: int = 1 << 15, engine: str = "auto"):
    """A ``Deflator`` (``engine="python"``) or a :class:`NativeDeflator`
    (``"native"``); ``"auto"`` takes the native engine when the library is
    available."""
    if engine == "auto":
        from .. import native

        engine = "native" if native.available() else "python"
    if engine == "native":
        return NativeDeflator(format, level, exponent, hint)
    return Deflator(format, level, exponent, hint)
