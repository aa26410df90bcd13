"""Checkpoint index for parallel DEFLATE decoding (the port's copy of
``swift_png_tpu/lz77/index.py``: the same format, parser, serializer and
host walker; :func:`build_index` walks in the port's native library when it
is available, as the JAX package's does in its own).

The reference inflator is a sequential state machine — one token at a time
(``Sources/LZ77/Inflator/LZ77.InflatorBuffers.Stream.swift:266-381``).  The
TPU decode path instead splits a stream's *output* into fixed ``OB``-byte
units and decodes every unit's token span in lockstep (SPMD over units,
one token per step).  That requires knowing, for each unit, the bit
position of the first token that produces bytes in its span — which is
what this index records.  It is the PNG/DEFLATE analog of sequence
parallelism: the scan dependency (bit position) is checkpointed at encode
or ingest time, and the expensive token decode becomes embarrassingly
parallel.

Index construction is a cheap single pass (done by the encoder for free,
or by :func:`build_index` for arbitrary streams — the same idea as gzip
random-access indexes à la rapidgzip).  Indexed streams remain 100 %
standard zlib/DEFLATE; the index is carried out of band (for PNG, in a
private ancillary ``spIx`` chunk).

v2 scope: any mix of dynamic-Huffman, fixed-Huffman, and stored blocks,
with two structural limits that keep the lockstep kernel's per-unit state
bounded:

* a unit's token walk crosses at most ONE block boundary (its per-unit
  record carries the next block's header length as an ``eob_jump``, and
  the device kernel switches to the unit's second table column when it
  decodes the boundary EOB);
* stored-block data regions begin and end on unit boundaries (so a unit
  is either pure tokens or a pure byte copy — never both).

Streams outside those limits (pathological runs of tiny blocks, unaligned
stored blocks) fall back to the general engines.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from .. import native as _native
from . import constants as C
from .errors import DecompressionError

__all__ = ["CheckpointIndex", "build_index", "index_from_arrays",
           "INDEX_VERSION", "MATCH_SEG",
           "FIXED_LIT_LENGTHS", "FIXED_DIST_LENGTHS"]

INDEX_VERSION = 5
MATCH_SEG = 64   # output bytes per match-segment (expansion compaction)
MAX_STORED_GAPS = 8   # copy-source interruptions per stored unit (v5)

KIND_HUFFMAN = 0
KIND_STORED = 1
GAP_NONE = 0xFFFF  # gap_off sentinel: stored unit reads contiguous bytes

# RFC 1951 §3.2.6 fixed-Huffman code lengths
FIXED_LIT_LENGTHS = np.concatenate([
    np.full(144, 8), np.full(112, 9), np.full(24, 7), np.full(8, 8),
]).astype(np.uint8)
FIXED_DIST_LENGTHS = np.full(32, 5, np.uint8)


@dataclass
class CheckpointIndex:
    """Per-unit decode entry points for one raw-DEFLATE body.

    Unit ``u`` owns output bytes ``[u*ob, (u+1)*ob)``.  Its first token is
    the one containing byte ``u*ob``; ``skip[u]`` bytes of that token
    belong to earlier units and are skipped.  ``n_tokens[u]`` tokens fully
    cover the unit's span (the last may extend past it; the excess belongs
    to the next unit, which re-decodes that token).  A boundary EOB
    counts as one (zero-output) token of the unit that decodes it.
    """

    ob: int                    # output bytes per unit
    out_size: int              # total decompressed size
    bit_pos: np.ndarray        # (U,) uint64 — absolute bit of first token
    skip: np.ndarray           # (U,) uint32 — bytes of first token to skip
    n_tokens: np.ndarray       # (U,) uint32 — tokens covering the unit
    lit_lengths: np.ndarray    # (NB, 288) uint8 — per-block lit/run lengths
    dist_lengths: np.ndarray   # (NB, 32) uint8 — per-block dist lengths
    end_bit: int               # bit position after the final EOB / block
    match_bytes: int = 0       # total bytes produced by match tokens
    match_segs: int = -1       # MATCH_SEG-byte segments containing a match
                               # byte (-1 = unknown; sizes the device
                               # expansion's segment compaction)
    unit_block: np.ndarray | None = None  # (U,) int32 — block id of the
                               # unit's first token (None ⇒ all 0)
    unit_kind: np.ndarray | None = None   # (U,) uint8 — KIND_HUFFMAN /
                               # KIND_STORED (None ⇒ all huffman)
    eob_jump: np.ndarray | None = None    # (U,) uint32 — bits from the end
                               # of the boundary EOB to the next block's
                               # first token (0 ⇒ unit may not cross)
    gap_off: np.ndarray | None = None     # (U,) uint16 — stored units
                               # only: local byte offset where stored
                               # headers interrupt the copy source
                               # (GAP_NONE ⇒ contiguous)
    gap_len: np.ndarray | None = None     # (U,) uint16 — bytes skipped at
                               # gap_off: 5 per header crossed (flush
                               # markers between stored blocks stack;
                               # v3 and older indexes imply 5)
    pair_steps: np.ndarray | None = None  # (U,) uint32 — lockstep steps
                               # when the kernel absorbs a literal that
                               # follows a literal or match in the same
                               # step (v3; None ⇒ unknown — callers
                               # bound by n_tokens)
    extra_gaps: dict | None = None        # v5: unit → [(off, len), …] for
                               # stored units whose copy source is
                               # interrupted MORE than once (flush-heavy
                               # chains with blocks smaller than ob);
                               # at most MAX_STORED_GAPS gaps total/unit

    def __post_init__(self):
        self.lit_lengths = np.atleast_2d(np.asarray(self.lit_lengths,
                                                    np.uint8))
        self.dist_lengths = np.atleast_2d(np.asarray(self.dist_lengths,
                                                     np.uint8))
        U = self.units
        if self.unit_block is None:
            self.unit_block = np.zeros(U, np.int32)
        if self.unit_kind is None:
            self.unit_kind = np.zeros(U, np.uint8)
        if self.eob_jump is None:
            self.eob_jump = np.zeros(U, np.uint32)
        if self.gap_off is None:
            self.gap_off = np.full(U, GAP_NONE, np.uint16)
        if self.gap_len is None:
            self.gap_len = np.where(self.gap_off != GAP_NONE, 5,
                                    0).astype(np.uint16)

    @property
    def units(self) -> int:
        return int(self.bit_pos.shape[0])

    @property
    def n_blocks(self) -> int:
        return int(self.lit_lengths.shape[0])

    @property
    def max_tokens(self) -> int:
        return int(self.n_tokens.max()) if self.units else 0

    @property
    def multiblock(self) -> bool:
        """True when the kernel needs table switching or stored fills."""
        return bool(self.n_blocks > 1 or self.unit_kind.any()
                    or self.eob_jump.any())

    def max_span_bytes(self) -> int:
        """Largest compressed span any unit reads (incl. lookahead).

        A unit's last decoded token is the first one whose output reaches
        its owned byte count.  Token bit positions are monotone and
        ``bit_pos[u+1]`` is the position of a token at-or-after that one
        (the next unit's first token — possibly the same crossing token),
        so every token this unit decodes *starts* at ``<= bit_pos[u+1]``.
        The decoder reads at most 96 bits from a token's start (three
        32-bit words), so the span must cover bit ``bit_pos[u+1] + 95``.
        This holds for multi-block units too (the boundary-EOB jump only
        advances the cursor toward later, still-monotone positions).
        """
        ends = np.empty_like(self.bit_pos)
        ends[:-1] = self.bit_pos[1:]
        ends[-1] = self.end_bit
        spans = ((ends + 95) >> 3) - (self.bit_pos >> 3) + 1
        return int(spans.max()) + 4

    # ---- serialization (spIx chunk payload) ----------------------------

    def serialize(self) -> bytes:
        """Compact byte form: header + per-block tables + unit records."""
        U = self.units
        NB = self.n_blocks
        out = bytearray()
        # streams without multi-gap units serialize as v4 (readable by
        # round-4 parsers); the v5 tail section exists only when needed
        ver = 5 if self.extra_gaps else 4
        out += bytes([ver])
        out += int(self.ob).to_bytes(4, "big")
        out += int(self.out_size).to_bytes(8, "big")
        out += int(self.end_bit).to_bytes(8, "big")
        out += U.to_bytes(4, "big")
        out += NB.to_bytes(2, "big")
        for b in range(NB):
            out += bytes(self.lit_lengths[b].tobytes())
            out += bytes(self.dist_lengths[b].tobytes())
        prev = 0
        for u in range(U):
            bp = int(self.bit_pos[u])
            out += (bp - prev).to_bytes(4, "big")
            prev = bp
            out += int(self.skip[u]).to_bytes(2, "big")
            out += int(self.n_tokens[u]).to_bytes(2, "big")
            out += int(self.unit_block[u]).to_bytes(2, "big")
            out += bytes([int(self.unit_kind[u])])
            out += int(self.eob_jump[u]).to_bytes(4, "big")
            out += int(self.gap_off[u]).to_bytes(2, "big")
            ps = (int(self.pair_steps[u]) if self.pair_steps is not None
                  else int(self.n_tokens[u]))
            out += ps.to_bytes(2, "big")
            out += int(self.gap_len[u]).to_bytes(2, "big")
        if ver >= 5:
            recs = [(u, off, ln) for u in sorted(self.extra_gaps)
                    for off, ln in self.extra_gaps[u]]
            out += len(recs).to_bytes(4, "big")
            for u, off, ln in recs:
                out += int(u).to_bytes(4, "big")
                out += int(off).to_bytes(2, "big")
                out += int(ln).to_bytes(2, "big")
        return bytes(out)

    @classmethod
    def parse(cls, data: bytes) -> "CheckpointIndex":
        if not data or data[0] not in (1, 2, 3, 4, 5):
            raise ValueError("unsupported checkpoint index version")
        ver = data[0]
        ob = int.from_bytes(data[1:5], "big")
        if ob < 64 or ob % 64 != 0:
            # both builders require ob >= 64; a hostile spIx chunk must
            # not drive the kernels with unit shapes they never see
            raise ValueError("unsupported checkpoint index unit size")
        out_size = int.from_bytes(data[5:13], "big")
        end_bit = int.from_bytes(data[13:21], "big")
        U = int.from_bytes(data[21:25], "big")
        o = 25
        if ver == 1:
            NB = 1
        else:
            NB = int.from_bytes(data[25:27], "big")
            o = 27
        lit = np.zeros((NB, 288), np.uint8)
        dist = np.zeros((NB, 32), np.uint8)
        for b in range(NB):
            lit[b] = np.frombuffer(data[o:o + 288], np.uint8)
            o += 288
            dist[b] = np.frombuffer(data[o:o + 32], np.uint8)
            o += 32
        rs = {1: 8, 2: 17, 3: 19, 4: 21, 5: 21}[ver]
        rec = np.frombuffer(data[o:o + rs * U], np.uint8).reshape(U, rs)
        deltas = (rec[:, 0].astype(np.uint64) << 24 |
                  rec[:, 1].astype(np.uint64) << 16 |
                  rec[:, 2].astype(np.uint64) << 8 | rec[:, 3])
        bit_pos = np.cumsum(deltas).astype(np.uint64)
        skip = (rec[:, 4].astype(np.uint32) << 8) | rec[:, 5]
        n_tokens = (rec[:, 6].astype(np.uint32) << 8) | rec[:, 7]
        ub = uk = ej = gp = ps = None
        if ver >= 2:
            ub = ((rec[:, 8].astype(np.int32) << 8) | rec[:, 9]).astype(
                np.int32)
            uk = rec[:, 10].copy()
            ej = (rec[:, 11].astype(np.uint32) << 24 |
                  rec[:, 12].astype(np.uint32) << 16 |
                  rec[:, 13].astype(np.uint32) << 8 | rec[:, 14])
            gp = ((rec[:, 15].astype(np.uint16) << 8)
                  | rec[:, 16]).astype(np.uint16)
        gl = None
        if ver >= 3:
            ps = ((rec[:, 17].astype(np.uint32) << 8) | rec[:, 18])
        if ver >= 4:
            gl = ((rec[:, 19].astype(np.uint16) << 8)
                  | rec[:, 20]).astype(np.uint16)
        eg = None
        if ver >= 5:
            o += rs * U
            cnt = int.from_bytes(data[o:o + 4], "big")
            o += 4
            if cnt > U * (MAX_STORED_GAPS - 1):
                raise ValueError("oversized extra-gap section")
            eg = {}
            for _ in range(cnt):
                u = int.from_bytes(data[o:o + 4], "big")
                off = int.from_bytes(data[o + 4:o + 6], "big")
                ln = int.from_bytes(data[o + 6:o + 8], "big")
                o += 8
                if u >= U:
                    raise ValueError("extra-gap unit out of range")
                eg.setdefault(u, []).append((off, ln))
        return cls(ob=ob, out_size=out_size, bit_pos=bit_pos, skip=skip,
                   n_tokens=n_tokens, lit_lengths=lit, dist_lengths=dist,
                   end_bit=end_bit, unit_block=ub, unit_kind=uk,
                   eob_jump=ej, gap_off=gp, pair_steps=ps, gap_len=gl,
                   extra_gaps=eg)


class _BitWalker:
    """Host scalar bit reader over a raw-DEFLATE body (index building)."""

    def __init__(self, body: bytes):
        self.d = body
        self.pos = 0

    def peek(self, n: int) -> int:
        byte = self.pos >> 3
        w = int.from_bytes(self.d[byte:byte + 7], "little")
        return (w >> (self.pos & 7)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v


def _flat_lut(lengths: np.ndarray, max_len: int):
    from .huffman import decode_table

    return decode_table(np.asarray(lengths, np.int64), max_len)


def _parse_dynamic_tables(w: _BitWalker):
    """Parse a dynamic block's table description at ``w``; returns
    ``(lit_lengths (288,), dist_lengths (32,))`` int64."""
    hlit = w.read(5) + 257
    hdist = w.read(5) + 1
    hclen = w.read(4) + 4
    if hlit > 286 or hdist > 30:
        raise DecompressionError.invalid_huffman_table()
    ml = np.zeros(19, np.int64)
    for i in range(hclen):
        ml[C.CODELENGTH_ORDER[i]] = w.read(3)
    try:
        mlut = _flat_lut(ml, 7)
    except Exception:
        raise DecompressionError.invalid_huffman_table()
    lengths: list[int] = []
    while len(lengths) < hlit + hdist:
        e = int(mlut[w.peek(7)])
        ln, sym = e >> 16, e & 0xFFFF
        if ln == 0:
            raise DecompressionError.invalid_huffman_table()
        w.pos += ln
        if sym < 16:
            lengths.append(sym)
        elif sym == 16:
            if not lengths:
                raise DecompressionError.invalid_huffman_table()
            lengths += [lengths[-1]] * (3 + w.read(2))
        elif sym == 17:
            lengths += [0] * (3 + w.read(3))
        else:
            lengths += [0] * (11 + w.read(7))
    if len(lengths) != hlit + hdist:
        raise DecompressionError.invalid_huffman_table()
    la = np.array(lengths, np.int64)
    lit_lengths = np.zeros(288, np.int64)
    lit_lengths[:hlit] = la[:hlit]
    dist_lengths = np.zeros(32, np.int64)
    dist_lengths[:hdist] = la[hlit:]
    return lit_lengths, dist_lengths


def build_index(body: bytes, out_size: int, ob: int = 1024,
                ) -> CheckpointIndex | None:
    """Build a checkpoint index for a raw-DEFLATE body.

    Handles any sequence of dynamic/fixed/stored blocks within the v2
    structural limits (one block boundary per unit; stored regions
    aligned to unit boundaries).  Returns ``None`` when the stream is
    outside the fast path.  One sequential pass over the token
    *boundaries*; no output is materialized.  The pass runs in the native
    library when it is available and ``ob >= 64``, else in Python
    (:func:`_build_index_host`); both give the same index.
    """
    if out_size == 0 or len(body) < 4:
        return None
    if _native.available() and ob >= 64:
        try:
            r = _native.build_index(body, out_size, ob)
        except _native.NativeError:
            # keep the host taxonomy for malformed streams
            raise DecompressionError.invalid_huffman_table()
        if r == "host-retry":
            # multi-gap stored chain — only the v5 host walker
            # records per-unit extra gaps
            return _build_index_host(body, out_size, ob)
        if r is None:
            return None  # outside the fast path (host walker agrees)
        (bit_pos, skip, n_tokens, ub, uk, ej, gp, gl, ps, lit,
         dist, end_bit, mb, ms) = r
        if uk.any() and not lit.any():
            # all-stored stream: dummy fixed table column
            lit = FIXED_LIT_LENGTHS[None, :]
            dist = FIXED_DIST_LENGTHS[None, :]
        return CheckpointIndex(
            ob=ob, out_size=out_size, bit_pos=bit_pos,
            skip=skip.astype(np.uint32),
            n_tokens=n_tokens.astype(np.uint32),
            lit_lengths=lit, dist_lengths=dist, end_bit=end_bit,
            match_bytes=mb, match_segs=ms, unit_block=ub,
            unit_kind=uk, eob_jump=ej, gap_off=gp, gap_len=gl,
            pair_steps=ps.astype(np.uint32))
    return _build_index_host(body, out_size, ob)


def index_from_arrays(fields: dict) -> CheckpointIndex:
    """A :class:`CheckpointIndex` from another index's fields.

    ``fields`` maps each field name of the JAX package's ``CheckpointIndex``
    (``ob``, ``out_size``, ``bit_pos``, …, ``extra_gaps``) to its value:
    numpy arrays for the per-unit and per-block fields, integers (or 0-d
    arrays) for the scalars, and ``None`` or a ``{unit: [(off, len), …]}``
    dict for ``extra_gaps``.  This is how the same index state crosses
    between the two packages without a byte round trip.
    """
    names = {f.name for f in dataclasses.fields(CheckpointIndex)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown index fields: {sorted(unknown)}")
    kw = {}
    for name, value in fields.items():
        if name in ("ob", "out_size", "end_bit", "match_bytes", "match_segs"):
            kw[name] = int(value)
        elif name == "extra_gaps":
            kw[name] = ({int(u): [(int(o), int(n)) for o, n in v]
                         for u, v in value.items()} if value else None)
        else:
            kw[name] = None if value is None else np.array(value)
    return CheckpointIndex(**kw)


def _build_index_host(body: bytes, out_size: int, ob: int,
                      ) -> CheckpointIndex | None:
    w = _BitWalker(body)
    nbits = len(body) * 8
    d = body
    run_base, run_extra = C.RUN_BASE, C.RUN_EXTRA
    dist_base, dist_extra = C.DISTANCE_BASE, C.DISTANCE_EXTRA

    U = (out_size + ob - 1) // ob
    bit_pos = np.zeros(U, np.uint64)
    skip = np.zeros(U, np.uint32)
    n_tokens = np.zeros(U, np.uint32)
    unit_block = np.zeros(U, np.int32)
    unit_kind = np.zeros(U, np.uint8)
    eob_jump = np.zeros(U, np.uint32)
    gap_off = np.full(U, GAP_NONE, np.uint16)
    gap_len = np.zeros(U, np.uint16)
    extra_gaps: dict[int, list[tuple[int, int]]] = {}
    pair_steps = np.zeros(U, np.uint32)
    blocks: list[tuple[np.ndarray, np.ndarray]] = []

    o = 0
    unit = 0
    unit_end = ob
    toks = 0
    # lockstep steps when the kernel absorbs trailing literals: a step
    # consumes token t, plus token t+1 iff t is a literal or match (not
    # EOB) and t+1 is a literal
    psteps = 0
    pend_open = False
    unit_open = False
    match_bytes = 0
    match_segs = 0
    last_seg = -1
    final = 0
    # the unit whose boundary EOB was just decoded (its eob_jump is set
    # once the next block's header has been parsed)
    pending_unit = -1
    pending_end = 0
    # open stored chain: a stored block ended mid-unit; the next block
    # must also be stored (its data continues the unit's copy source
    # after the inter-block headers — stored ends are byte-aligned, so
    # the gap is 5 bytes per header crossed: one LEN/NLEN header, plus 5
    # per empty stored flush marker stacked in between)
    stored_open = False
    chain_gap = 0

    while True:
        if w.pos + 3 > nbits:
            raise DecompressionError.invalid_huffman_table()
        final = w.read(1)
        btype = w.read(2)
        if btype == 3:
            raise DecompressionError.invalid_block_type_code(3)
        if btype == 0:
            # ---- stored block -----------------------------------------
            w.pos = (w.pos + 7) & ~7
            if w.pos + 32 > nbits:
                raise DecompressionError.invalid_huffman_table()
            ln = w.read(16)
            nl = w.read(16)
            if ln ^ 0xFFFF != nl:
                raise DecompressionError.invalid_block_element_count_parity(
                    ln, nl)
            db0 = w.pos >> 3
            if (db0 + ln) * 8 > nbits:
                raise DecompressionError.invalid_huffman_table()
            if ln == 0 and stored_open:
                # an empty stored block (a flush marker) inside an open
                # stored chain stacks another 5-byte header onto the
                # copy-source gap (v4 records the width per unit)
                chain_gap += 5
                if final:
                    break
                continue
            if ln > 0:
                if pending_unit >= 0:
                    return None  # unit mixes tokens and a stored copy
                if o + ln > out_size:
                    return None  # size mismatch → general engine errs
                if o % ob != 0:
                    # mid-unit entry: legal only when continuing a
                    # stored chain (the unit's copy source resumes after
                    # the accumulated headers → record the gap; tiny
                    # flush-heavy chains interrupt one unit several
                    # times — v5 carries up to MAX_STORED_GAPS of them)
                    if not stored_open:
                        return None  # huffman/stored mixed unit
                    if gap_off[unit] == GAP_NONE:
                        gap_off[unit] = o % ob
                        gap_len[unit] = chain_gap + 5
                    else:
                        ex = extra_gaps.setdefault(unit, [])
                        if len(ex) >= MAX_STORED_GAPS - 1:
                            return None  # beyond the v5 gap budget
                        ex.append((o % ob, chain_gap + 5))
                end_o = o + ln
                first_u = o // ob if o % ob == 0 else o // ob + 1
                for u in range(first_u, (end_o + ob - 1) // ob):
                    bit_pos[u] = (db0 + (u * ob - o)) * 8
                    skip[u] = 0
                    n_tokens[u] = 0
                    unit_kind[u] = KIND_STORED
                    unit_block[u] = max(len(blocks) - 1, 0)
                o = end_o
                unit = min(end_o // ob, U - 1)
                unit_end = (unit + 1) * ob
                toks = 0
                unit_open = False
                stored_open = end_o % ob != 0 and end_o != out_size
                chain_gap = 0
            w.pos = (db0 + ln) * 8
            if final:
                break
            continue
        # ---- huffman block --------------------------------------------
        if stored_open:
            return None  # huffman tokens would mix into a stored unit
        if btype == 1:
            lit_lengths = FIXED_LIT_LENGTHS.astype(np.int64)
            dist_lengths = FIXED_DIST_LENGTHS.astype(np.int64)
        else:
            lit_lengths, dist_lengths = _parse_dynamic_tables(w)
        bid = len(blocks)
        if bid >= 0xFFFF:
            return None
        blocks.append((lit_lengths.astype(np.uint8),
                       dist_lengths.astype(np.uint8)))
        try:
            litlut = _flat_lut(lit_lengths, 15)
            if np.count_nonzero(dist_lengths):
                distlut = _flat_lut(dist_lengths, 15)
            else:
                distlut = np.zeros(2, np.int64)
        except Exception:
            raise DecompressionError.invalid_huffman_table()
        litlut_l = litlut.tolist()
        distlut_l = distlut.tolist()
        # a pending boundary jump is finalized at this block's FIRST
        # token — not here — so empty flush blocks (header + EOB, no
        # output) fold into the jump instead of consuming the unit's
        # single table switch (round-4 widening; such blocks appear in
        # zlib Z_FULL_FLUSH output between data blocks)

        # ---- token walk -----------------------------------------------
        pos = w.pos
        eob = False
        first = True
        while True:
            if pos + 15 > nbits and pos + 1 > nbits:
                raise DecompressionError.invalid_huffman_table()
            byte0 = pos >> 3
            window = int.from_bytes(d[byte0:byte0 + 7], "little") >> (
                pos & 7)
            e = litlut_l[window & 0x7FFF]
            ln2, sym = e >> 16, e & 0xFFFF
            if ln2 == 0 or pos + ln2 > nbits:
                raise DecompressionError.invalid_huffman_table()
            if first and pending_unit >= 0:
                if sym == 256 and unit_open and not final:
                    # empty block: fold header+EOB into the pending jump
                    # (and drop its tables — the crossing unit's second
                    # table column is unit_block+1, the next REAL block)
                    blocks.pop()
                    pos += ln2
                    pending_end = pos
                    eob = True
                    break
                if eob_jump[pending_unit] != 0:
                    return None  # second boundary in one unit
                jump = pos - pending_end
                if jump <= 0 or jump > 0xFFFFFFFF:
                    return None
                eob_jump[pending_unit] = jump
                pending_unit = -1
            first = False
            if sym == 256:
                if unit_open and not final:
                    toks += 1  # boundary EOB: zero-output token
                    psteps += 1
                    pend_open = False
                    pending_unit = unit
                pos += ln2
                pending_end = pos
                eob = True
            elif sym < 256:
                if not unit_open:
                    bit_pos[unit] = pos
                    skip[unit] = 0
                    unit_block[unit] = bid
                    unit_open = True
                    toks = 0
                    psteps = 0
                    pend_open = False
                tpos, tlen = pos, 1
                pos += ln2
            elif sym > 285:
                raise DecompressionError.invalid_huffman_table()
            else:
                if not unit_open:
                    bit_pos[unit] = pos
                    skip[unit] = 0
                    unit_block[unit] = bid
                    unit_open = True
                    toks = 0
                    psteps = 0
                    pend_open = False
                dec = sym - 257
                eb = int(run_extra[dec])
                run = int(run_base[dec]) + ((window >> ln2) & (
                    (1 << eb) - 1))
                w2 = window >> (ln2 + eb)
                e2 = distlut_l[w2 & 0x7FFF]
                dln, dsym = e2 >> 16, e2 & 0xFFFF
                if dln == 0 or dsym > 29:
                    raise DecompressionError.invalid_huffman_table()
                db = int(dist_extra[dsym])
                if pos + ln2 + eb + dln + db > nbits:
                    raise DecompressionError.invalid_huffman_table()
                dist = int(dist_base[dsym]) + ((w2 >> dln) & (
                    (1 << db) - 1))
                if dist > o:
                    raise DecompressionError.invalid_string_reference()
                match_bytes += run
                s1 = (o + run - 1) // MATCH_SEG
                match_segs += s1 - max(o // MATCH_SEG - 1, last_seg)
                last_seg = s1
                tpos, tlen = pos, run
                pos += ln2 + eb + dln + db
            if eob:
                break
            toks += 1
            if sym < 256 and pend_open:
                pend_open = False         # absorbed into the open step
            else:
                psteps += 1
                pend_open = True          # lit/match both leave a slot
            o += tlen
            # token crossed into (or completed) unit(s)
            while o >= unit_end and unit + 1 < U:
                n_tokens[unit] = toks
                pair_steps[unit] = psteps
                unit += 1
                if o > unit_end:
                    # a crossing token is always a match (tlen > 1)
                    bit_pos[unit] = tpos
                    skip[unit] = tlen - (o - unit_end)
                    unit_block[unit] = bid
                    unit_open = True
                    toks = 1
                    psteps = 1
                else:
                    unit_open = False
                    toks = 0
                    psteps = 0
                # a crossing match (toks == 1 branch) may still absorb a
                # following literal; an exact boundary starts closed
                pend_open = toks == 1
                unit_end += ob
        w.pos = pos
        if final:
            break
    if unit_open or toks:
        n_tokens[unit] = toks
        pair_steps[unit] = psteps
    if o != out_size:
        return None  # declared size mismatch → let the general engine err
    if int(n_tokens.max()) > 0xFFFF or int(skip.max()) > 0xFFFF:
        return None
    if np.any(np.diff(bit_pos.astype(np.int64)) > 0xFFFFFFFF):
        return None
    if not blocks:
        # all-stored stream: carry one dummy (fixed) table so downstream
        # per-unit table packing has a valid column
        blocks.append((FIXED_LIT_LENGTHS, FIXED_DIST_LENGTHS))
    lit = np.stack([b[0] for b in blocks])
    dist = np.stack([b[1] for b in blocks])
    return CheckpointIndex(
        ob=ob, out_size=out_size, bit_pos=bit_pos, skip=skip,
        n_tokens=n_tokens, lit_lengths=lit, dist_lengths=dist,
        end_bit=w.pos, match_bytes=match_bytes, match_segs=match_segs,
        unit_block=unit_block, unit_kind=unit_kind, eob_jump=eob_jump,
        gap_off=gap_off, gap_len=gap_len, pair_steps=pair_steps,
        extra_gaps=extra_gaps or None)
