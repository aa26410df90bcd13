"""Checkpoint-parallel indexed inflate on the GPU.

Counterpart of ``swift_png_tpu/ops/inflate_checkpoint.py``'s main path
(``CheckpointInflator.run`` → ``prepare`` → ``inflate_indexed_pallas``).
A stream's output is split into ``ob``-byte units; the checkpoint index
gives each unit the bit and byte where its first token starts, so every
unit of every stream decodes independently (K1, :mod:`.inflate_stamp`).
The torch tail then places the literal and stored bytes, checks the flags,
resolves the back-references and computes the Adler-32 checksum.

Layout is unit-major: row ``u`` of every per-unit array is unit ``u`` (unit
``ul`` of stream ``u // Ui``).  The TPU version's lane transposes and tile
padding existed for the TPU's lockstep and are not here, but its step
budget is: every unit gets the bound and mode of its 1,024-unit tile
(:func:`tile_budget`), so a corrupt unit decodes exactly as far as it does
in the JAX package and flags the same way.

The tail has two branches, as the JAX version's has.  Literal-heavy
batches resolve their matches by pointer doubling and combine K1's literal
partials into the checksum.  Match-dominated batches (``collapse``) take
one of three expansions — the in-order records kernel K2
(:mod:`.inflate_seqcopy`), the dense distance sweeps, or the dense pointer
collapse — and checksum the output bytes.  As in the JAX package, a
fourth choice serves noisy match-dominated streams (near-uniform match
distances) off the device: the native host tier inflates them on threads
(:mod:`.._host.native`), beside the device run of the rest of the batch.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import trace
from .._host import native as _native
from .._host.lz77 import constants as C
from .._host.lz77.errors import DecompressionError, StreamHeaderError
from .._kernels import resolve_device
from .._host.lz77.index import (FIXED_DIST_LENGTHS, FIXED_LIT_LENGTHS,
                                GAP_NONE, KIND_STORED, CheckpointIndex,
                                _BitWalker, _flat_lut, _parse_dynamic_tables,
                                build_index)
from . import inflate_seqcopy
from .inflate_stamp import SENTINEL, decode_stamp, prepare_block_tables

__all__ = ["CheckpointInflator", "inflate_indexed_stamp", "inflate_tail",
           "tail_pointers", "stamp", "stamp_match_total",
           "expand_matches", "expand_collapse", "expand_sweeps",
           "collapse_ptr", "top_distances", "adler_from_partials",
           "adler_batch", "probe_match_profile", "tile_budget", "TUB"]

F_BAD = 1
TUB = 1024         # units per tile of the TPU kernel's step budget
_MOD = 65521
SWEEP_K = 48       # distances swept when a batch takes the sweeps


def _r8k(n: int) -> int:
    """Expansion caps round to 8K (``run`` in the JAX version)."""
    return max(1 << 10, -(-n // 8192) * 8192)


def _pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def expand_matches(ptr: torch.Tensor, litv: torch.Tensor) -> torch.Tensor:
    """Resolve LZ77 back-references over the flat output.

    ``ptr[j]`` is ``j`` for a literal (or stored, or flagged) byte and the
    source position ``j - dist`` for a match byte; ``litv`` holds the
    literal values.  Every match points strictly backward, so the pointer
    graph is a forest whose roots are literals: pointer doubling
    (``ptr = ptr[ptr]``) reaches every byte's root in ``log2(depth) + 1``
    rounds, and the output is ``litv[root]``.  This realizes the byte-by-
    byte forward copy of an overlapping match (``dist < len``) exactly,
    and it needs no capacity: there is nothing to overflow, so the TPU
    version's expansion caps and their retry loop have no counterpart.
    """
    while True:
        nxt = ptr[ptr]
        with trace.sync():
            same = torch.equal(nxt, ptr)
        if same:
            break
        ptr = nxt
    return litv[ptr]


def adler_from_partials(s1u, s2u, mv, ob: int, out_size: int):
    """Adler-32 per stream from per-unit literal partials plus the
    match-byte sums, in int64 (no modular folding is needed: the sums of a
    stream stay far below 2^63).

    ``s1u/s2u``: ``(B, Ui)`` — Σd and Σ(ob - b)·d over each unit's owned
    literal (and stored) bytes.  ``mv``: ``(B, Opad)`` int64 — the value of
    every live match byte, 0 elsewhere.  With ``n = out_size``, Adler's
    ``s2 = n + Σ_p (n - p)·d[p]``; a literal at ``p = ul·ob + b``
    contributes ``(n - (ul+1)·ob)·d + (ob - b)·d``.
    """
    Ui = s1u.shape[1]
    ul = torch.arange(Ui, device=s1u.device)
    coef = out_size - (ul + 1) * ob
    a_lit = s1u.sum(1)
    s2_lit = (coef * s1u + s2u).sum(1)
    p = torch.arange(mv.shape[1], device=mv.device)
    a_cor = mv.sum(1)
    s2_cor = ((out_size - p) * mv).sum(1)
    s1 = (1 + a_lit + a_cor) % _MOD
    s2 = (out_size + s2_lit + s2_cor) % _MOD
    return (s2 << 16) | s1


def adler_batch(out2: torch.Tensor, out_size: int) -> torch.Tensor:
    """Adler-32 per row of ``(B, Opad)`` output bytes, over the first
    ``out_size`` bytes: ``s1 = 1 + Σd``, ``s2 = n + Σ(n - i)·d[i]``.  The
    collapse modes' checksum (they do not keep K1's literal partials).
    int64 with no modular folding until the end: the sums stay far below
    2^63.  Returns ``(B,)`` int64."""
    d = out2[:, :out_size].long()
    w = out_size - torch.arange(out_size, device=out2.device)
    s1 = (1 + d.sum(1)) % _MOD
    s2 = (out_size + (d * w).sum(1)) % _MOD
    return (s2 << 16) | s1


def collapse_ptr(ptr: torch.Tensor):
    """Dense pointer collapse (``_collapse_ptr`` in the JAX version).

    ``ptr[j] = j - d`` is the byte-by-byte forward copy; a self-
    overlapping match chains ``ceil(run/d)`` single steps deep.  Two
    closed forms remove every within-run step:

    * a maximal region ``[s, e)`` whose bytes all copy from ``j - d`` (one
      ``d ≥ 2``) is one virtual match, so ``out[j] = out[s - d + (j - s)
      mod d]`` — a source strictly before ``s``;
    * a ``d == 1`` (RLE) byte equals the nearest non-RLE byte to its
      left: one hop to ``lastn1[j]``, the running max of non-RLE
      positions.

    Returns ``(ptr' (N,) int64, m1 (N,) bool)``; every pointer of ``ptr'``
    is a literal's own position or strictly smaller than its byte's.
    """
    ptr = ptr.long()
    N = ptr.numel()
    j = torch.arange(N, device=ptr.device)
    d = j - ptr                       # 0 = literal / dead
    is_m = d > 0
    m1 = d == 1
    lastn1 = torch.cummax(torch.where(m1, -1, j), 0).values
    dm = torch.where(is_m & ~m1, d, 0)
    prev = torch.cat([dm.new_zeros(1), dm[:-1]])
    start = (dm > 0) & (dm != prev)
    s = torch.cummax(torch.where(start, j, -1), 0).values
    o = j - s
    src2 = torch.where(o < d, ptr, s - d + o % d.clamp(min=1))
    ptr2 = torch.where(m1, lastn1.clamp(min=0),
                       torch.where(is_m, src2, j))
    return ptr2, m1


def expand_collapse(ptr: torch.Tensor, litv: torch.Tensor) -> torch.Tensor:
    """The collapse expansion: :func:`collapse_ptr`, then pointer doubling
    to the fixed point and ``litv[p]``.  The function of the JAX version's
    identity-slot mode (``_expand_legacy`` with ``collapse_shape``) and of
    its compacted collapse branch (``_expand``); with no caps, nothing can
    overflow."""
    p, _ = collapse_ptr(ptr)
    return expand_matches(p, litv)


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """The int16 view of ``x``'s low 16 bits, kept in ``x``'s dtype."""
    return ((x + 32768) & 0xFFFF) - 32768


def top_distances(d16: torch.Tensor, K: int, stride: int = 509):
    """Top-``K`` match distances by frequency, from a strided sample
    (``_top_distances`` in the JAX version).

    ``d16`` holds each byte's distance in the int16 view (a distance of
    32,768 wraps negative and is never chosen), 0 for literals.  Returns
    ``(min(K, n),)`` int64, ``n`` the sample size, padded with zeros when
    fewer distinct distances exist; ties keep ascending distance order (a
    stable sort, as ``jnp.argsort``'s)."""
    s = d16[::stride].long()
    ss = torch.sort(s).values
    n = ss.numel()
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=s.device),
                       ss[1:] != ss[:-1]])
    sid = torch.cumsum(start.long(), 0) - 1
    counts = torch.zeros(n, dtype=torch.long, device=s.device)
    counts.index_add_(0, sid, torch.ones_like(sid))
    vals = torch.zeros(n, dtype=torch.long, device=s.device).scatter_reduce(
        0, sid, ss, "amax")
    counts = torch.where(vals > 0, counts, 0)
    idx = torch.argsort(-counts, stable=True)[:K]
    return torch.where(counts[idx] > 0, vals[idx], 0)


def expand_sweeps(ptr: torch.Tensor, litv: torch.Tensor,
                  sweep_k: int) -> torch.Tensor:
    """Distance-bucketed dense-shift expansion for match-rich streams
    (``_expand_sweeps`` in the JAX version).

    For each of the top-``sweep_k`` distances ``dk``, one shift of the
    whole output by ``dk`` and a masked select resolve every match byte of
    that distance whose source is already resolved; three rounds over the
    distances cover shallow chains.  A byte only takes the value of a
    final source, so the order cannot matter.  The residual (rare
    distances, deep chains) then goes through :func:`expand_collapse`,
    with every resolved byte a literal carrying its value.
    """
    ptr = ptr.long()
    N = ptr.numel()
    j = torch.arange(N, device=ptr.device)
    d = j - ptr
    d16 = _wrap16(d)
    with trace.sync():
        dists = top_distances(d16, sweep_k).tolist()
    resolved = d == 0
    out = litv
    for _ in range(3):
        for k in range(sweep_k):
            # a sample shorter than sweep_k repeats its last distance, as
            # the JAX version's clamped dynamic_slice does
            dk = dists[min(k, len(dists) - 1)]
            if dk <= 0 or dk >= N:
                continue            # no byte has this distance
            so = torch.cat([out.new_zeros(dk), out[:N - dk]])
            sr = torch.cat([resolved.new_zeros(dk), resolved[:N - dk]])
            m = (d16 == dk) & ~resolved & sr
            out = torch.where(m, so, out)
            resolved = resolved | m
    return expand_collapse(torch.where(resolved, j, ptr), out)


def probe_match_profile(body: bytes, max_tokens: int = 8000):
    """Host probe of a stream's match structure (one cheap partial walk;
    ``_probe_match_profile`` in the JAX version).

    Returns ``(cov48, runs, match_bytes, out_bytes)`` — the fraction of
    match bytes covered by the 48 most frequent distances, the count of
    merged uniform-distance runs, the match bytes and the bytes walked —
    or ``None`` when the walk fails.  :meth:`CheckpointInflator.run`
    estimates a batch's record count from it.
    """
    w = _BitWalker(body)
    nbits = len(body) * 8
    hist: dict[int, int] = {}
    runs = 0
    match_bytes = 0
    out_bytes = 0
    prev_d = -1
    toks = 0
    try:
        while toks < max_tokens:
            if w.pos + 3 > nbits:
                break
            final = w.read(1)
            btype = w.read(2)
            if btype == 0:
                w.pos = (w.pos + 7) & ~7
                ln = w.read(16)
                w.read(16)
                w.pos += ln * 8
                out_bytes += ln
                if final:
                    break
                continue
            if btype == 1:
                lit = FIXED_LIT_LENGTHS.astype(np.int64)
                dist = FIXED_DIST_LENGTHS.astype(np.int64)
            else:
                lit, dist = _parse_dynamic_tables(w)
            litlut = _flat_lut(lit, 15).tolist()
            distlut = (_flat_lut(dist, 15).tolist()
                       if np.count_nonzero(dist) else [0, 0])
            while toks < max_tokens:
                e = litlut[w.peek(15)]
                l, sym = e >> 16, e & 0xFFFF
                if l == 0:
                    return None
                w.pos += l
                toks += 1
                if sym == 256:
                    break
                if sym < 256:
                    out_bytes += 1
                    prev_d = -1
                    continue
                dec = sym - 257
                if dec > 28:
                    return None
                run = int(C.RUN_BASE[dec]) + w.read(int(C.RUN_EXTRA[dec]))
                e2 = distlut[w.peek(15)]
                dl, dsym = e2 >> 16, e2 & 0xFFFF
                if dl == 0 or dsym > 29:
                    return None
                w.pos += dl
                d = int(C.DISTANCE_BASE[dsym]) + w.read(
                    int(C.DISTANCE_EXTRA[dsym]))
                hist[d] = hist.get(d, 0) + run
                match_bytes += run
                out_bytes += run
                if d != prev_d:
                    runs += 1
                prev_d = d
            else:
                break
            if final:
                break
    except Exception:
        return None
    if match_bytes == 0:
        return 1.0, runs, 0, max(out_bytes, 1)
    top = sorted(hist.values(), reverse=True)[:48]
    return sum(top) / match_bytes, runs, match_bytes, max(out_bytes, 1)


def inflate_indexed_stamp(prep: dict, **modes):
    """Indexed inflate of a prepared batch (:meth:`CheckpointInflator.
    prepare`): K1, then the torch tail (:func:`inflate_tail`, which takes
    the expansion ``modes``).

    Returns ``(out (B, out_size) uint8, flag (U,) int32, adler (B,) int64,
    ovf)``.  ``flag`` is nonzero for a unit with a bad code, short
    coverage, an uncovered live byte, or a match reaching before its
    stream's start.  ``ovf`` is ``True`` only in records mode, when the
    batch has more records than ``records_cap``.
    """
    return inflate_tail(*stamp(prep), prep, **modes)


def stamp(prep: dict):
    """K1 on a prepared batch: ``(attr, flag, s1, s2)``."""
    return decode_stamp(prep["spans"], prep["meta"], prep["pool_t"],
                        prep["pool_s"], prep["ids"], prep["kbound"],
                        ob=prep["ob"])


def stamp_match_total(attr, prep: dict) -> int:
    """The batch's match bytes, counted from K1's stamp: the owned bytes
    whose attr is a distance.  Equals the indexes' ``match_bytes`` sum for
    a stream that decodes without flags."""
    owned = (torch.arange(prep["ob"], device=attr.device)
             < prep["meta"][:, 2:3])
    with trace.sync():
        return int(((attr >= 0) & owned).sum())


def _records_apply(prep: dict, records_cap: int | None) -> bool:
    """Whether the tail's collapse branch takes the records kernel: a cap
    is set, streams are 128-byte aligned, and the batch's expansion cap —
    computed as ``run`` computes it in the JAX version — covers half the
    flat output (match-dominated content)."""
    N = prep["B"] * prep["Ui"] * prep["ob"]
    expand_cap = min(_r8k(prep["match_total"] + 64), _pow2(N))
    return (records_cap is not None and (prep["Ui"] * prep["ob"]) % 128 == 0
            and expand_cap >= N >> 1)


def tail_pointers(attr, kflag, s1k, s2k, prep: dict):
    """The tail's first stage after K1: live mask, stored-unit byte fill
    and flags.  Returns ``(litv (B, Opad) uint8, ptr (B·Opad,) int64,
    flag (U,), s1u (U,), s2u (U,), mlive (U, ob) bool)``: the literal and
    stored bytes placed, each byte's copy source (its own position for a
    literal), the unit flags, the literal partials with the stored bytes
    added, and the live match bytes."""
    ob, B, Ui = prep["ob"], prep["B"], prep["Ui"]
    out_size = prep["out_size"]
    U = attr.shape[0]
    Opad = Ui * ob
    dev = attr.device
    b = torch.arange(ob, device=dev)
    u = torch.arange(U, device=dev)
    ul = u % Ui
    live = b < (out_size - ul * ob).clamp(max=ob)[:, None]
    ism = attr >= 0                     # match: attr = dist - 1
    is_lit = (attr < 0) & (attr != SENTINEL)
    uncovered = attr == SENTINEL
    litv = torch.where(live & is_lit, -attr - 1, 0).to(torch.uint8)
    s1u, s2u = s1k, s2k

    if prep["has_stored"]:
        # dense byte unpack of each stored unit's span head; the copy
        # source skips every recorded gap (stored headers and stacked flush
        # markers) at its offset, cumulatively over the unit's gaps
        gaps = prep["stored_gap"]
        ng = gaps.shape[0] // 2
        stored = (gaps[0] >= 0)[:, None]
        sb = prep["spans"].view(torch.uint8).reshape(U, -1).long()
        idx = b.expand(U, ob)
        for kg in range(ng):
            off = torch.where(gaps[kg] >= 0, gaps[kg], ob)
            idx = idx + torch.where(b >= off[:, None], gaps[ng + kg][:, None],
                                    0)
        sbytes = sb.gather(1, idx)
        sel = stored & live
        litv = torch.where(sel, sbytes.to(torch.uint8), litv)
        uncovered = uncovered & ~stored
        # stored bytes are literals for the checksum
        d = torch.where(sel, sbytes, 0)
        s1u = s1u + d.sum(1)
        s2u = s2u + ((ob - b) * d).sum(1)

    j = u[:, None] * ob + b
    src = j - (attr.long() + 1)
    sbase = (u // Ui * Opad)[:, None]
    mlive = live & ism
    flag = kflag | torch.where(((src < sbase) & mlive).any(1), F_BAD, 0)
    flag = flag | torch.where((live & uncovered).any(1), F_BAD, 0)

    # a match reaching before its stream's start flags its unit and keeps
    # its byte's own position, so no gather leaves the stream
    ptr = torch.where(mlive & (src >= sbase), src, j).reshape(-1)
    return litv.reshape(B, Opad), ptr, flag, s1u, s2u, mlive


def inflate_tail(attr, kflag, s1k, s2k, prep: dict, *, collapse=False,
                 records_cap: int | None = None, sweep_k: int | None = None):
    """The tail after K1: :func:`tail_pointers`, back-reference expansion
    and the Adler-32 checksum.  Same contract as
    :func:`inflate_indexed_stamp`.

    Without ``collapse``: pointer doubling and K1's literal partials.
    With it (``inflate_indexed_pallas`` and ``_expand``'s routing in the
    JAX version): the distance sweeps when ``sweep_k`` is set, else the
    records kernel K2 when :func:`_records_apply`, else the collapse
    expansion; then the Adler-32 of the output bytes.
    """
    ob, B, Ui = prep["ob"], prep["B"], prep["Ui"]
    out_size = prep["out_size"]
    Opad = Ui * ob
    litv, ptr, flag, s1u, s2u, mlive = tail_pointers(attr, kflag, s1k, s2k,
                                                     prep)
    ovf = False
    if not collapse:
        out = expand_matches(ptr, litv.reshape(-1)).reshape(B, Opad)
        mv = torch.where(mlive.reshape(B, Opad), out.long(), 0)
        adler = adler_from_partials(s1u.reshape(B, Ui), s2u.reshape(B, Ui),
                                    mv, ob, out_size)
    else:
        if sweep_k:
            out = expand_sweeps(ptr, litv.reshape(-1), sweep_k)
        elif _records_apply(prep, records_cap):
            starts, recs, ovf = inflate_seqcopy.build_records(
                ptr, B, Opad, records_cap)
            out = inflate_seqcopy.seqcopy_expand(starts, recs, litv)
        else:
            out = expand_collapse(ptr, litv.reshape(-1))
        out = out.reshape(B, Opad)
        adler = adler_batch(out, out_size)
    return (out[:, :out_size].contiguous(), flag.to(torch.int32), adler,
            ovf)


def tile_budget(n_tokens, pair_steps, lit_ok) -> np.ndarray:
    """K1's step budget per unit, ``(U, 2)`` int32 ``[bound, mode]``.

    The rule of the JAX version's ``prepare`` for its Pallas kernel: the
    units, stream-major, fall in tiles of :data:`TUB` (the last one padded
    with units of no tokens that count as all-literal), and every unit of
    a tile gets the tile's budget.  With ``kb`` and ``pb`` the tile's
    largest ``n_tokens`` and ``pair_steps``:

    * mode 1 when every unit of the tile is all-literal (``lit_ok``):
      ``ceil(kb / 2)`` literal pairs, run four pairs at a time, so a unit
      may decode ``8 · ((bound + 3) >> 2)`` literals;
    * mode 2 when ``pb · 8 <= kb · 7``: ``pb`` steps, each one token and,
      when the next code is a literal, that literal too;
    * mode 0 otherwise: ``kb`` steps of one token.

    A valid unit stops at its coverage long before; the budget decides
    only how far a corrupt one runs, so one stream's flags may depend on
    its neighbours in the tile, as they do in the JAX package.
    """
    U = len(n_tokens)
    T = -(-U // TUB)
    pad = (0, T * TUB - U)

    def tiles(a, fill=0):
        return np.pad(np.asarray(a, np.int64), pad,
                      constant_values=fill).reshape(T, TUB)

    kb = tiles(n_tokens).max(1)
    pb = tiles(pair_steps).max(1)
    lit_mode = tiles(lit_ok, 1).all(1)
    pair_mode = ~lit_mode & (pb * 8 <= kb * 7)
    mode = np.where(lit_mode, 1, np.where(pair_mode, 2, 0))
    bound = np.where(lit_mode, -(-kb // 2), np.where(pair_mode, pb, kb))
    return np.repeat(np.stack([bound, mode], 1), TUB, 0)[:U].astype(np.int32)


# the host arrays :func:`_stage_layout` builds and ``prepare`` uploads, in
# upload order (the byte buffer and the unit starts, then the tables)
_STAGED = ("buf", "starts", "meta", "pool_t", "pool_s", "ids", "kbound",
           "stored_gap")


def _stage_layout(bodies: list[bytes],
                  indexes: list[CheckpointIndex]) -> dict:
    """The host half of :meth:`CheckpointInflator.prepare`: the batch's
    scalars and its unit-major numpy arrays, ``buf`` (every body followed
    by its zero padding) and ``starts`` (each unit's first byte in it)
    from which the spans are cut on the device, and the rest as
    ``prepare`` returns them."""
    out_size = indexes[0].out_size
    ob = indexes[0].ob
    for ix in indexes:
        if ix.out_size != out_size or ix.ob != ob:
            raise ValueError("a batch needs one out_size and one ob")
    Ui = (out_size + ob - 1) // ob
    B = len(bodies)
    U = B * Ui
    multiblock = any(ix.multiblock for ix in indexes)
    has_stored = any(ix.unit_kind.any() for ix in indexes)
    # v5 multi-gap stored chains: per-unit total skipped bytes bound the
    # span; the gap table has one (off, len) row pair per gap rank
    n_gaps = 1
    gmax = 5
    for ix in indexes:
        gmax = max(gmax, int(ix.gap_len.max()))
        if ix.extra_gaps:
            n_gaps = max(n_gaps,
                         1 + max(len(v) for v in ix.extra_gaps.values()))
            for uu, ex in ix.extra_gaps.items():
                gmax = max(gmax, int(ix.gap_len[uu])
                           + sum(ln for _, ln in ex))
    span_bytes = max(ix.max_span_bytes() for ix in indexes)
    if has_stored:
        span_bytes = max(span_bytes, ob + 9 + gmax)
    S = -(-((span_bytes + 3) // 4) // 8) * 8
    # every body followed by S·4 zero bytes (a window past the body's
    # end reads zeros); the units' windows are cut on the device
    offs = np.cumsum([0] + [len(b) + S * 4 for b in bodies])
    buf = np.zeros(int(offs[-1]), np.uint8)
    starts = np.zeros(U, np.int64)
    meta = np.zeros((U, 4 if multiblock else 3), np.int32)
    n_tokens = np.zeros(U, np.int64)
    psteps = np.zeros(U, np.int64)
    lit_ok = np.zeros(U, bool)
    sgap = np.full((n_gaps, U), -1, np.int32)
    sgap[1:] = ob          # rank-2+ gaps: ob = "never" when absent
    sglen = np.zeros((n_gaps, U), np.int32)
    ids = np.zeros((U, 2 if multiblock else 1), np.int32)
    pool_lit, pool_dist = [], []
    for i, (body, ix) in enumerate(zip(bodies, indexes)):
        sb = (ix.bit_pos >> 3).astype(np.int64)
        # the index comes from the file: a unit entry past its body or
        # a block id past its tables would make the device gathers
        # read out of bounds
        if sb.size and (sb.max() > len(body)
                        or ix.unit_block.min() < 0
                        or ix.unit_block.max() >= ix.n_blocks):
            raise DecompressionError.invalid_huffman_table()
        base = i * Ui
        rows = slice(base, base + Ui)
        buf[offs[i]: offs[i] + len(body)] = np.frombuffer(body, np.uint8)
        starts[rows] = offs[i] + sb
        meta[rows, 0] = (ix.bit_pos
                         - (sb << 3).astype(np.uint64)).astype(np.int32)
        meta[rows, 1] = ix.skip
        st = ix.unit_kind == KIND_STORED
        ow = np.minimum(ob, out_size - np.arange(Ui) * ob)
        meta[rows, 2] = np.where(st, 0, ow)
        if multiblock:
            meta[rows, 3] = ix.eob_jump.astype(np.int32)
        n_tokens[rows] = ix.n_tokens
        psteps[rows] = (ix.pair_steps if ix.pair_steps is not None
                        else ix.n_tokens)
        # all-literal: n_tokens == owned with no skip on either side
        # of the unit (a match would leave one), no boundary EOB jump
        # and no stored fill
        nskip = np.append(ix.skip[1:], 0)
        lit_ok[rows] = ((meta[rows, 2] == 0)
                        | ((ix.n_tokens == meta[rows, 2])
                           & (ix.skip == 0) & (nskip == 0)
                           & (ix.eob_jump == 0) & ~st))
        sgap[0, rows] = np.where(
            st, np.where(ix.gap_off == GAP_NONE, ob,
                         ix.gap_off.astype(np.int32)), -1)
        sglen[0, rows] = np.where(st & (ix.gap_off != GAP_NONE),
                                  ix.gap_len.astype(np.int32), 0)
        if ix.extra_gaps:
            for uu, ex in ix.extra_gaps.items():
                for kg, (goff, glen) in enumerate(ex, start=1):
                    sgap[kg, base + uu] = goff
                    sglen[kg, base + uu] = glen
        p0 = len(pool_lit)
        for bnum in range(ix.n_blocks):
            pool_lit.append(ix.lit_lengths[bnum])
            pool_dist.append(ix.dist_lengths[bnum])
        ids[rows, 0] = p0 + ix.unit_block
        if multiblock:
            ids[rows, 1] = p0 + np.minimum(ix.unit_block + 1,
                                           ix.n_blocks - 1)
    pool_lit = np.stack(pool_lit)
    tabs_all, sym_all = prepare_block_tables(pool_lit,
                                             np.stack(pool_dist))
    # trim the packed literal-symbol rows to the populated range: a
    # structurally valid decode lands at symidx < nlit
    rows3 = -(-int(np.count_nonzero(pool_lit, 1).max()) // 3)
    R = max(8, -(-rows3 // 8) * 8)
    return dict(
        out_size=out_size, ob=ob, B=B, Ui=Ui, S=S, multiblock=multiblock,
        has_stored=has_stored,
        match_total=sum(int(ix.match_bytes) for ix in indexes),
        buf=buf, starts=starts, meta=meta, pool_t=tabs_all,
        pool_s=np.ascontiguousarray(sym_all[:, :R]), ids=ids,
        kbound=tile_budget(n_tokens, psteps, lit_ok),
        stored_gap=(np.concatenate([sgap, sglen]) if has_stored
                    else None))


class CheckpointInflator:
    """Host staging + device inflate for a batch of indexed streams.

    ``device``: where the batch decodes — ``cuda`` unless the caller names
    another (``"cpu"`` runs the plain PyTorch versions).  With no device
    named and no GPU present, construction raises.  ``ob``: the unit size
    :meth:`inflate_zlib_batch` indexes streams with (a batch given to
    :meth:`run` carries its own in its indexes).
    """

    def __init__(self, device=None, ob: int = 1024):
        self.device = resolve_device(device)
        self.ob = ob
        self.last_plan: dict | None = None

    @staticmethod
    def auto_collapse(match_total: int, n_streams: int, out_size: int,
                      ui_pad: int, ob: int) -> bool:
        """Expansion-mode policy: match-heavy content (smooth/RLE-ish
        images) goes through the collapse modes and the output-byte
        checksum; literal-heavy content keeps the literal-partial checksum
        path.  The JAX version's RLE fill packs ``(pos << 8) | byte`` in
        uint32, so the per-stream padded length must fit 24 bits; the
        port keeps the limit for parity."""
        return (match_total * 2 > n_streams * out_size
                and ui_pad * ob < (1 << 24))

    def prepare(self, bodies: list[bytes],
                indexes: list[CheckpointIndex]) -> dict:
        """Slice per-unit spans and tables to the unit-major device layout.

        Returns a dict of tensors on the device: ``spans (U, S)`` int32
        words, ``meta (U, 3|4)`` int32 (sub-bit, skip, owned bytes — 0 for
        stored units, which the tail fills —, and with multiblock tables
        the boundary-EOB bit jump), the table pool ``pool_t (P, 72)`` and
        ``pool_s (P, R)`` int32 (one row per DEFLATE block of the batch),
        ``ids (U, 1|2)`` int32 (each unit's block in the pool and, with
        multiblock tables, its next block), ``kbound (U, 2)`` int32 step
        budgets (:func:`tile_budget`) and, where any unit is
        stored, ``stored_gap (2·NG, U)`` int32 (rows ``0…NG``: gap
        offsets, ``-1`` in row 0 for token units and ``ob`` for absent
        gaps; rows ``NG…2·NG``: gap widths); plus the batch's scalars,
        ``match_total`` among them (the indexes' match bytes: 0 for an
        index parsed from a chunk, which does not carry the count).
        """
        with trace.span("checkpoint.prepare"):
            with trace.span("checkpoint.layout"):
                host = _stage_layout(bodies, indexes)
            dev = self.device
            with trace.span("checkpoint.upload"):
                staged = [k for k in _STAGED if host[k] is not None]
                S = host["S"]
                spans = trace.upload(host.pop("buf"), dev).unfold(
                    0, S * 4, 1)[trace.upload(host.pop("starts"), dev)]
                host["spans"] = spans.view(torch.int32)
                for k in staged[2:]:
                    host[k] = trace.upload(host[k], dev)
            return host

    def run(self, bodies: list[bytes], indexes: list[CheckpointIndex],
            collapse: bool | None = None):
        """Inflate a batch of same-size indexed streams.

        Returns ``(out (B, out_size) uint8 tensor on the device, adler (B,)
        uint32 numpy)``.  Raises :class:`DecompressionError` when any unit
        flags.  The Adler-32 is returned for the caller to hold against the
        stream trailers, as the JAX version's is.

        Routing follows the JAX version's ``run``.  ``collapse=None`` lets
        :meth:`auto_collapse` choose.  A match-dominated batch is probed
        per stream (a spread sample, every stream when the sample
        disagrees, else the sample's class for the whole batch).  A stream
        whose estimated records overflow ``RECORDS_SMEM_CAP`` goes to the
        native host tier when its 48 most frequent distances cover under
        half its match bytes and the native library is available, else to
        the distance sweeps.  Host streams inflate on native threads
        (``inflate_batch``), overlapped with the device streams' run when
        the batch is mixed.  Device streams take the records kernel at
        ``records_cap``, which grows ×4 up to the cap on overflow and then
        gives way to the sweeps, or the sweeps when any stream chose them.
        An index parsed from a PNG chunk does not carry its match-byte
        count (the JAX version then sees 0 and takes the literal branch);
        the port counts those match bytes from K1's stamp, so such a batch
        routes as a host-indexed one, on the device.  ``last_plan`` records
        the tier and mode taken.
        """
        with trace.span("checkpoint.run"):
            out_size, ob = indexes[0].out_size, indexes[0].ob
            if any(ix.out_size != out_size or ix.ob != ob for ix in indexes):
                raise ValueError("a batch needs one out_size and one ob")
            B = len(bodies)
            Ui = (out_size + ob - 1) // ob
            # host-built indexes carry their match bytes, so the tier is
            # chosen before any staging; otherwise K1's stamp counts them
            # first
            counted = all(ix.match_segs >= 0 for ix in indexes)
            prep = k1 = None
            if counted:
                match_total = sum(int(ix.match_bytes) for ix in indexes)
            else:
                prep = self.prepare(bodies, indexes)
                with trace.span("checkpoint.stamp"):
                    k1 = stamp(prep)
                    match_total = prep["match_total"] = stamp_match_total(
                        k1[0], prep)
            if collapse is None:
                collapse = self.auto_collapse(match_total, B, out_size, Ui,
                                              ob)
            aligned = (Ui * ob) % 128 == 0
            force_sweeps = False
            if collapse and aligned and match_total * 2 > B * out_size:
                with trace.span("checkpoint.probe"):
                    dec = self._probe_tiers(bodies, out_size, host_ok=counted)
                hostset = [i for i in range(B) if dec[i] == "host"]
                if 0 < len(hostset) < B:
                    return self._run_mixed(bodies, indexes, hostset, collapse)
                if hostset:
                    return self._run_host(bodies, out_size)
                force_sweeps = "sweeps" in dec.values()
            if prep is None:
                prep = self.prepare(bodies, indexes)
                with trace.span("checkpoint.stamp"):
                    k1 = stamp(prep)
            records_smem_cap = inflate_seqcopy.RECORDS_SMEM_CAP
            records_cap = sweep_k = None
            if collapse and aligned:
                records_cap = min(records_smem_cap,
                                  _r8k(max(4096, match_total // 16)))
                if force_sweeps:
                    records_cap, sweep_k = None, SWEEP_K
            with trace.span("checkpoint.tail"):
                while True:
                    out, flag, adler, ovf = inflate_tail(
                        *k1, prep, collapse=collapse, records_cap=records_cap,
                        sweep_k=sweep_k)
                    if not ovf:
                        break
                    # only the records kernel overflows: grow within the
                    # cap, then switch to the sweeps
                    if records_cap < records_smem_cap:
                        records_cap = min(records_cap * 4, records_smem_cap)
                    else:
                        records_cap, sweep_k = None, SWEEP_K
                with trace.sync():
                    bad = int(flag.max()) != 0
                if bad:
                    raise DecompressionError.invalid_huffman_table()
                adler = trace.fetch(adler).numpy().astype(np.uint32)
            self.last_plan = dict(tier="device", collapse=collapse,
                                  records_cap=records_cap, sweep_k=sweep_k)
            return out, adler

    @staticmethod
    def _probe_tiers(bodies: list[bytes], out_size: int,
                     host_ok: bool) -> dict[int, str]:
        """Each stream's tier, ``"device"``, ``"sweeps"`` or ``"host"``,
        from :func:`probe_match_profile` on a spread sample of the batch
        (every stream when the sample disagrees)."""
        B = len(bodies)
        host_ok = host_ok and _native.available()

        def decide(body):
            probe = probe_match_profile(body)
            if probe is None:
                return "device"
            cov48, runs, _, seen = probe
            est_runs = runs * out_size // max(seen, 1)
            if est_runs * B <= inflate_seqcopy.RECORDS_SMEM_CAP:
                return "device"
            # zlib -9-class noisy content: near-uniform match distances
            # defeat every dense device strategy; native threads serve it
            return "host" if cov48 < 0.5 and host_ok else "sweeps"

        sample = sorted({0, B // 3, (2 * B) // 3, B - 1})
        dec = {i: decide(bodies[i]) for i in sample}
        if len(set(dec.values())) > 1:
            return {i: dec[i] if i in dec else decide(bodies[i])
                    for i in range(B)}
        return dict.fromkeys(range(B), dec[sample[0]])

    def _run_host(self, bodies: list[bytes], out_size: int):
        """The whole batch on the native tier; the checksums ride a thread
        pool too (ctypes releases the GIL)."""
        outs = _native.inflate_batch(bodies, out_size, "ios")
        with ThreadPoolExecutor() as pool:
            adler = np.asarray(list(pool.map(_native.adler32, outs)),
                               np.uint32)
        arr = np.stack([np.frombuffer(o, np.uint8) for o in outs])
        self.last_plan = dict(tier="host")
        return trace.upload(arr, self.device), adler

    def _run_mixed(self, bodies: list[bytes], indexes: list[CheckpointIndex],
                   hostset: list[int], collapse: bool):
        """``hostset`` on native threads, overlapped with the other streams'
        run on the device; the two halves merged in batch order."""
        B, out_size = len(bodies), indexes[0].out_size
        devset = [i for i in range(B) if i not in hostset]
        with ThreadPoolExecutor(max_workers=4) as pool:
            fut = pool.submit(_native.inflate_batch,
                              [bodies[i] for i in hostset], out_size, "ios")
            dout, dadler = self.run([bodies[i] for i in devset],
                                    [indexes[i] for i in devset],
                                    collapse=collapse)
            houts = fut.result()
            hadler = list(pool.map(_native.adler32, houts))
        out = torch.empty((B, out_size), dtype=torch.uint8, device=self.device)
        out[devset] = dout
        out[hostset] = trace.upload(
            np.stack([np.frombuffer(o, np.uint8) for o in houts]),
            self.device)
        adler = np.empty(B, np.uint32)
        adler[devset] = dadler
        adler[hostset] = hadler
        self.last_plan = dict(tier="mixed", hostset=hostset)
        return out, adler

    def inflate_zlib_batch(self, datas: list[bytes], out_size: int):
        """Complete zlib streams → ``(B, out_size)`` uint8 on the device.

        Checks each header, indexes each body with :func:`build_index` at
        ``self.ob``, runs the batch and holds every Adler-32 against its
        stream's trailer.  Returns ``None`` when any stream does not index
        (the caller then needs a general engine).  Raises
        :class:`StreamHeaderError` for a bad header and
        :class:`DecompressionError` for a short stream or a checksum
        mismatch.
        """
        bodies, indexes = [], []
        for d in datas:
            if len(d) < 6:
                raise DecompressionError.invalid_stream_checksum(0, 0)
            cmf, flg = d[0], d[1]
            if cmf & 0x0F != 0x08:
                raise StreamHeaderError.invalid_compression_method(
                    cmf & 0x0F)
            if (cmf * 256 + flg) % 31 != 0:
                raise StreamHeaderError.invalid_check_bits()
            body = d[2:-4]
            ix = build_index(body, out_size, self.ob)
            if ix is None:
                return None
            bodies.append(body)
            indexes.append(ix)
        out, adler = self.run(bodies, indexes)
        for i, d in enumerate(datas):
            declared = int.from_bytes(d[-4:], "big")
            if int(adler[i]) != declared:
                raise DecompressionError.invalid_stream_checksum(
                    declared, int(adler[i]))
        return out
