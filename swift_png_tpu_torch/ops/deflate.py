"""DEFLATE term emission, bit packing, block serialization and the greedy
match search (plain PyTorch and host).

Counterparts of ``swift_png_tpu/ops/deflate.py``: :func:`term_pieces` (each
packed DeflatorTerm → its
≤48-bit code + extra bits as an int32 ``(lo, hi)`` pair and a bit count,
as ``pack_terms32`` computes), :func:`scatter_pack` (``pack_bits32``'s
scatter: up to three scatter-adds per term land the bit-disjoint pieces
at their stream offsets in 32-bit atoms, so add equals OR),
``max_term_bits``, ``atoms32_to_bytes``, ``_emit_tables`` and
``_write_block_header_and_tables``.  The arithmetic stays in int32 with
the JAX package's arithmetic right shifts and ``& 0x7FFFFFFF`` masks, so
every atom has the same bits.

The greedy/lazy match search (:func:`greedy_tokens`, with
:func:`_match_search`, :func:`term_frequencies` and :func:`_stream_bits`)
feeds the shared-trees encode, the segmented deflate
(``parallel/blocks.py``) and :func:`deflate_device`.  Every position's
4-byte key is sorted with its position; a position's nearest predecessors
under the same key are its neighbours in that order, their match runs come
from chunked 4-byte compares, and the parse is read off by pointer jumping
over ranks.  Keys are uint32 in the JAX package; here they sort as int64
(the sentinel ``0xFFFFFFFF`` stays above every key), and terms are int32
with the uint32 bits (the packed DeflatorTerm format K6 reads).

:func:`append_bits` replaces ``_append_bits``, which wrote one Python call
per body byte: it splices the whole body into the bit writer with one
shift of a Python integer, byte for byte the same stream.
"""

from __future__ import annotations

import numpy as np
import torch

from .._host.bits import BitWriter, reverse_bits
from .._host.lz77 import constants as C
from .._host.lz77.checksums import adler32
from .._host.lz77.deflate import _META_EXTRA, _metaterms, _write_stored_block
from .._host.lz77.huffman import canonical_codes, lengths_from_frequencies
from .._kernels import resolve_device

__all__ = ["term_pieces", "scatter_pack", "max_term_bits",
           "atoms32_to_bytes", "append_bits", "greedy_tokens",
           "term_frequencies", "emit_input", "emit_pack",
           "emit_pack_shared",
           "deflate_device"]


def _place64(lo, hi, piece, off):
    """OR a ≤16-bit ``piece`` into a 64-bit ``(lo, hi)`` int32 window at
    bit ``off`` (0…48)."""
    sh = off & 31
    in_hi = off >= 32
    shifted = piece << sh                      # low 32 bits of the shift
    spill = torch.where(sh == 0, 0, ((piece >> 1) & 0x7FFFFFFF) >> (31 - sh))
    lo = lo | torch.where(in_hi, 0, shifted)
    hi = hi | torch.where(in_hi, shifted, spill)
    return lo, hi


def term_pieces(terms: torch.Tensor, lit_entry, dist_entry):
    """The bit pattern of every term, from its two emit-table entries.

    ``terms``: int32 packed DeflatorTerms (literal ``0xF8000000 | byte``;
    match ``dd<<27 | dist_extra<<14 | run_extra<<9 | 0x100 | rd``).
    ``lit_entry(sym)`` / ``dist_entry(dd)`` return the ``bits | len<<16``
    entries of the literal/run symbol and of the distance decade (a
    gather from per-image tables in the caller).  Returns ``(lo, hi,
    nbits)`` int32; the RFC 1951 extra-bit widths come from closed forms.
    """
    t = terms.to(torch.int32)
    top = (t >> 27) & 0x1F                         # unsigned bits 27…31
    is_lit = (top == 31) & ((t & 0x100) == 0)
    litv = t & 0xFF
    rd = litv.clamp(0, 28)
    dd = top.clamp(0, 29)
    run_extra = (t >> 9) & 0x1F
    dist_extra = (t >> 14) & 0x1FFF
    zero = torch.zeros_like(t)
    lv = lit_entry(torch.where(is_lit, litv, 257 + rd))
    lo, hi = _place64(zero, zero, lv & 0xFFFF, zero)
    off = lv >> 16
    reb = torch.where(is_lit | (rd < 4) | (rd == 28), 0, (rd >> 2) - 1)
    lo, hi = _place64(lo, hi, torch.where(is_lit, 0, run_extra), off)
    off = off + reb
    dv = dist_entry(dd)
    dn = torch.where(is_lit, 0, dv >> 16)
    lo, hi = _place64(lo, hi, torch.where(is_lit, 0, dv & 0xFFFF), off)
    off = off + dn
    deb = torch.where(is_lit | (dd < 4), 0, (dd >> 1) - 1)
    lo, hi = _place64(lo, hi, torch.where(is_lit, 0, dist_extra), off)
    return lo, hi, off + deb


def scatter_pack(lo, hi, nbv, offs, spans: int, natoms: int):
    """Place ``(B, n)`` bit patterns at their within-image stream bit
    offsets ``offs`` (any element order) into ``(B, natoms)`` int32
    atoms; ``nbv`` is each pattern's bit count, 0 for a dead slot.  A
    pattern at any offset spans at most 3 atoms, 2 when it has ≤ 33 bits.
    Returns ``(atoms, totals (B,))``."""
    B, n = nbv.shape
    dev = nbv.device
    a0 = (offs >> 5).long()
    sub = offs & 31
    nsub = ((32 - sub) & 31) - 1
    carry = nsub.clamp(min=0)
    vals = [
        lo << sub,
        torch.where(sub == 0, 0, ((lo >> 1) & 0x7FFFFFFF) >> carry)
        | (hi << sub),
        torch.where(sub == 0, 0, ((hi >> 1) & 0x7FFFFFFF) >> carry),
    ]
    atoms = torch.zeros(B * natoms + 1, dtype=torch.int32, device=dev)
    base = (torch.arange(B, device=dev) * natoms)[:, None]
    for k in range(spans):
        live = (32 * k < sub + nbv) & (nbv > 0)
        tgt = torch.where(live, base + a0 + k, B * natoms)
        atoms.scatter_add_(0, tgt.reshape(-1),
                           torch.where(live, vals[k], 0).reshape(-1))
    return (atoms[:-1].reshape(B, natoms),
            nbv.sum(dim=1, dtype=torch.int64))


def max_term_bits(lit_lengths, dist_lengths, freq) -> int:
    """Exact upper bound on a stream's per-term bit count, from the final
    trees and the symbol histogram (only decades that occur count)."""
    ll = np.asarray(lit_lengths, np.int64)
    dl = np.asarray(dist_lengths, np.int64)
    f = np.asarray(freq, np.int64)
    best = int(np.max(np.where(f[:256] > 0, ll[:256], 0), initial=0))
    run_f = f[257:286]
    dist_f = f[288:318]
    if int(run_f.sum()) > 0 and int(dist_f.sum()) > 0:
        run_bits = np.where(run_f > 0,
                            ll[257:286] + np.asarray(C.RUN_EXTRA[:29]), 0)
        dist_bits_v = np.where(
            dist_f > 0, dl[:30] + np.asarray(C.DISTANCE_EXTRA[:30]), 0)
        best = max(best, int(run_bits.max()) + int(dist_bits_v.max()))
    return best


def atoms32_to_bytes(atoms: np.ndarray, total_bits: int) -> bytes:
    """Little-endian 32-bit atoms → the packed byte string."""
    u32 = np.asarray(atoms, np.int64).astype(np.uint32)
    return u32.tobytes()[: (int(total_bits) + 7) // 8]


_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.int64)


def _emit_tables(lit_lengths: np.ndarray, dist_lengths: np.ndarray):
    """LSB-first ``(lit_bits, lit_len, dist_bits, dist_len)`` emit tables
    (int32, 288 and 30 entries) from code lengths."""
    lit_lengths = np.asarray(lit_lengths, np.int64)
    dist_lengths = np.asarray(dist_lengths, np.int64)

    def rev(codes, lengths):
        r16 = (_REV8[codes & 255] << 8) | _REV8[(codes >> 8) & 255]
        return np.where(lengths > 0, r16 >> (16 - np.maximum(lengths, 1)),
                        0)

    lit_bits = rev(canonical_codes(lit_lengths).astype(np.int64),
                   lit_lengths)
    dist_bits = rev(canonical_codes(dist_lengths).astype(np.int64),
                    dist_lengths)
    pad = 288 - lit_bits.size
    if pad:
        lit_bits = np.concatenate([lit_bits, np.zeros(pad, np.int64)])
        lit_lengths = np.concatenate([lit_lengths, np.zeros(pad, np.int64)])
    dpad = 30 - dist_bits.size
    if dpad:
        dist_bits = np.concatenate([dist_bits, np.zeros(dpad, np.int64)])
        dist_lengths = np.concatenate([dist_lengths,
                                       np.zeros(dpad, np.int64)])
    return (lit_bits.astype(np.int32), lit_lengths.astype(np.int32),
            dist_bits.astype(np.int32), dist_lengths.astype(np.int32))


def _write_block_header_and_tables(out: BitWriter, lit_lengths,
                                   dist_lengths, final: bool) -> None:
    """Dynamic block header + code-length tables."""
    lit_lengths = np.asarray(lit_lengths, np.int64)
    dist_lengths = np.asarray(dist_lengths, np.int64)
    r = max(257, int(np.max(np.nonzero(lit_lengths)[0], initial=0)) + 1)
    used_d = np.nonzero(dist_lengths)[0]
    d = max(1, int(used_d.max()) + 1 if used_d.size else 1)
    sequence = [int(lit_lengths[s]) for s in range(r)] + [
        int(dist_lengths[s]) if s < dist_lengths.size else 0
        for s in range(d)]
    meta = _metaterms(sequence)
    meta_freq = np.zeros(19, np.int64)
    for sym, _ in meta:
        meta_freq[sym] += 1
    meta_lengths = lengths_from_frequencies(meta_freq, 7, force=False)
    meta_codes = canonical_codes(meta_lengths)
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
        out.write(reverse_bits(int(meta_codes[sym]), int(meta_lengths[sym])),
                  int(meta_lengths[sym]))
        eb = _META_EXTRA.get(sym, 0)
        if eb:
            out.write(extra, eb)


def append_bits(out: BitWriter, body: bytes, nbits: int) -> None:
    """Append ``nbits`` LSB-first bits of ``body`` to the bit writer in one
    write of a Python integer (the same bytes as writing them one byte at
    a time)."""
    out.write(int.from_bytes(body[: (nbits + 7) // 8], "little"), nbits)


# ---------------------------------------------------------------------------
# the greedy match search
# ---------------------------------------------------------------------------

def term_frequencies(terms: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Host-side symbol frequencies from packed terms (uint32 or int32
    with the same bits)."""
    t = np.asarray(terms)[np.asarray(valid)].astype(np.uint32)
    is_lit = (t >> 27 == 31) & ((t & 0x100) == 0)
    freq = np.zeros(320, np.int64)
    np.add.at(freq, np.where(is_lit, t & 0xFF, 257 + (t & 0xFF)), 1)
    np.add.at(freq, 288 + (t[~is_lit] >> 27), 1)
    freq[256] += 1
    return freq


def _stream_bits(terms: np.ndarray, valid: np.ndarray,
                 lit_lengths: np.ndarray, dist_lengths: np.ndarray) -> int:
    """Exact dynamic-block bit count for a term sequence (host): the token
    bits from the frequency tables, the header from the same metaterm
    serialization the writer uses."""
    freq = term_frequencies(terms, valid)
    ll = np.asarray(lit_lengths, np.int64)
    dl = np.asarray(dist_lengths, np.int64)
    bits = int(np.sum(freq[:286] * ll[:286]))
    bits += int(np.sum(freq[257:286] * np.asarray(C.RUN_EXTRA[:29])))
    dfreq = freq[288:318]
    bits += int(np.sum(dfreq[:dl.size] * dl))
    bits += int(np.sum(dfreq * np.asarray(C.DISTANCE_EXTRA[:30])))
    r = max(257, int(np.max(np.nonzero(ll)[0], initial=0)) + 1)
    used_d = np.nonzero(dl)[0]
    d = max(1, int(used_d.max()) + 1 if used_d.size else 1)
    sequence = [int(ll[s]) for s in range(r)] + [
        int(dl[s]) if s < dl.size else 0 for s in range(d)]
    meta = _metaterms(sequence)
    meta_freq = np.zeros(19, np.int64)
    for sym, _ in meta:
        meta_freq[sym] += 1
    meta_lengths = lengths_from_frequencies(meta_freq, 7, force=False)
    order_lengths = [int(meta_lengths[sym]) for sym in C.CODELENGTH_ORDER]
    hclen = 19
    while hclen > 4 and order_lengths[hclen - 1] == 0:
        hclen -= 1
    bits += 3 + 5 + 5 + 4 + 3 * hclen
    for sym, _ in meta:
        bits += int(meta_lengths[sym]) + _META_EXTRA.get(sym, 0)
    return bits


def _load32(db: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Little-endian 4-byte words of the int64 bytes ``db`` at ``idx``,
    clamped to ``[0, len(db) - 4]``."""
    i = idx.clamp(0, db.shape[0] - 4)
    return db[i] | db[i + 1] << 8 | db[i + 2] << 16 | db[i + 3] << 24


def _eq_bytes(x: torch.Tensor) -> torch.Tensor:
    """Matching low-byte count of a nonzero 4-byte XOR."""
    return (((x & 0xFF) == 0).to(torch.int32)
            + ((x & 0xFFFF) == 0).to(torch.int32)
            + ((x & 0xFFFFFF) == 0).to(torch.int32))


def _match_search(data: torch.Tensor, n: int, k: int, max_chunks: int):
    """Best ``(run, dist)`` int32 per position from the ``k`` nearest
    predecessors in (4-byte key, position) order; the run is a chunked
    4-byte compare capped at ``4 + 4·max_chunks`` and 258.  Among equal
    runs the nearer distance wins."""
    N = data.shape[0]
    dev = data.device
    db = torch.cat([data.to(torch.int64),
                    torch.zeros(4, dtype=torch.int64, device=dev)])
    key = db[:N] | db[1:N + 1] << 8 | db[2:N + 2] << 16 | db[3:N + 3] << 24
    pos = torch.arange(N, dtype=torch.int64, device=dev)
    key = torch.where(pos < n - 3, key, 0xFFFFFFFF)
    skey, order = torch.sort(key, stable=True)
    best_comb = torch.full((N,), -1, dtype=torch.int32, device=dev)
    this = order
    for back in range(1, k + 1):
        cand = torch.roll(order, back)
        same = torch.roll(skey, back) == skey
        cand_pos = torch.where(same, cand, -1)
        ok = (cand_pos >= 0) & (cand_pos < this) & (this - cand_pos < 32768)
        run = torch.full((N,), 4, dtype=torch.int32, device=dev)
        alive = ok
        for chunk in range(1, max_chunks + 1):
            a = _load32(db, this + 4 * chunk)
            b = _load32(db, torch.where(alive, cand_pos, 0) + 4 * chunk)
            x = a ^ b
            eq = (x == 0) & alive
            add = torch.where(eq, 4, _eq_bytes(x))
            run = run + torch.where(alive, add, 0)
            alive = eq
        run = torch.minimum(run.clamp(max=258), n - this).to(torch.int32)
        combined = torch.where(
            ok & (run >= 4),
            run * 65536 + (32768 - (this - cand_pos)).to(torch.int32), -1)
        # ``this`` is a permutation: each position is written once
        best_comb[this] = torch.maximum(best_comb[this], combined)
    best_run = torch.where(best_comb >= 0, best_comb >> 16, 0)
    best_dist = torch.where(best_comb >= 0, 32768 - (best_comb & 0xFFFF), 0)
    return best_run, best_dist


def _decade_tables(dev):
    """``(RUN_DECADE, RUN_BASE, DISTANCE_DECADE, DISTANCE_BASE)`` as int64
    tensors on ``dev``."""
    return tuple(torch.from_numpy(np.asarray(t, np.int64)).to(dev)
                 for t in (C.RUN_DECADE, C.RUN_BASE, C.DISTANCE_DECADE,
                           C.DISTANCE_BASE))


def _match_terms(run_v, dist_v, tabs):
    """Packed match terms (int64, the uint32 bits) of runs and distances."""
    run_decade, run_base, dist_decade, dist_base = tabs
    run_t = run_v.long().clamp(0, 258)
    dist_t = dist_v.long().clamp(0, 32768)
    rd = run_decade[run_t]
    dd = dist_decade[dist_t]
    m = 0xFFFFFFFF  # uint32 arithmetic, as the JAX package's
    return ((dd << 27) | ((((dist_t - dist_base[dd]) & m) << 14) & m)
            | ((((run_t - run_base[rd]) & m) << 9) & m) | 0x100 | rd) & m


def _as_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 with the same bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def greedy_tokens(data: torch.Tensor, n: int, *, k: int = 4, t_cap: int,
                  max_chunks: int = 31, lazy: bool = False,
                  min_run: int = 6, short_far: int = 0):
    """Greedy/lazy match search over one ``(N,)`` uint8 buffer whose first
    ``n`` bytes are live.

    Returns ``(terms (t_cap,) int32, valid (t_cap,) bool, count)``:
    packed terms (the uint32 bits as int32; matches of run ≥ 6, or of run
    ≥ ``min_run`` at distances under ``short_far``).  With ``lazy``, a
    position whose successor has a longer accepted match emits a literal
    and the successor's match (one path node, two terms).  The parse is
    read off by pointer jumping over ``t_cap`` ranks.
    """
    N = data.shape[0]
    dev = data.device
    pos = torch.arange(N, dtype=torch.int32, device=dev)
    best_run, best_dist = _match_search(data, n, k, max_chunks)
    accept = best_run >= 6
    if short_far > 0:
        accept = accept | ((best_run >= min_run) & (best_dist < short_far))
    take = accept & (pos + best_run <= n)
    if lazy:
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        run_n = torch.cat([best_run[1:], zero])
        dist_n = torch.cat([best_dist[1:], zero])
        accept_n = torch.cat([accept[1:], zero.bool()])
        pair = (take & accept_n & (run_n > best_run)
                & (pos + 1 + run_n <= n) & (pos + 1 < n))
        step = torch.where(pair, 1 + run_n, torch.where(take, best_run, 1))
    else:
        pair = torch.zeros(N, dtype=torch.bool, device=dev)
        run_n = dist_n = best_run  # unused
        step = torch.where(take, best_run, 1)
    # past-the-end targets are fixed points at their own position, so the
    # path never re-enters live data
    nxt = torch.where(pos + step >= n, pos, pos + step)
    nxt = torch.where(pos >= n, pos, nxt).clamp(max=N - 1).long()

    ranks = torch.arange(t_cap, dtype=torch.int64, device=dev)
    P = torch.zeros(t_cap, dtype=torch.int64, device=dev)
    jump = nxt
    for kk in range(max(1, (t_cap - 1).bit_length())):
        P = torch.where(((ranks >> kk) & 1) == 1, jump[P], P)
        jump = jump[jump]
    nvalid = P < n
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                     P[1:] == P[:-1]])
    nvalid = nvalid & ~dup

    tabs = _decade_tables(dev)
    lit_term = 0xF8000000 | data[P.clamp(0, N - 1)].long()
    pair_n = pair[P] & nvalid
    is_match = take[P] & nvalid & ~pair_n
    term_a = torch.where(is_match,
                         _match_terms(best_run[P], best_dist[P], tabs),
                         lit_term)
    # a lazy pair's second term is the deferred match at P + 1
    term_b = _match_terms(run_n[P], dist_n[P], tabs)
    counts = torch.where(nvalid, 1 + pair_n.long(), 0)
    offs = torch.cumsum(counts, 0) - counts
    count = int(counts.sum())
    sink = t_cap  # scatter target of dead lanes
    terms = torch.zeros(t_cap + 1, dtype=torch.int64, device=dev)
    terms[torch.where(nvalid, offs, sink)] = torch.where(nvalid, term_a, 0)
    terms[torch.where(pair_n, offs + 1, sink)] = torch.where(pair_n, term_b,
                                                             0)
    tvalid = torch.arange(t_cap, device=dev) < count
    return _as_int32(terms[:t_cap]), tvalid, count


def emit_input(terms_list: list, counts: list, trees: list):
    """K6's input for B streams, stream ``i`` packed against ``trees[i]``
    (``(lit lengths, dist lengths)``): ``(terms (B·slots,) int32, tabs
    (B, 320), live (B, slots) bool, slots)`` — each stream's first
    ``counts[i]`` terms in a row of ``slots`` (a multiple of 256), its
    tree's emit table in its row of ``tabs`` (a table built once for a
    tree that repeats)."""
    from .deflate_emit import pack_emit_table

    dev = terms_list[0].device
    B = len(terms_list)
    slots = max(256, -(-max(counts) // 256) * 256)
    rows = torch.zeros((B, slots), dtype=torch.int32, device=dev)
    for i, (t, c) in enumerate(zip(terms_list, counts)):
        rows[i, :c] = t[:c]
    live = (torch.arange(slots, device=dev)[None]
            < torch.tensor(counts, device=dev)[:, None])
    built: dict = {}
    for tree in trees:
        if id(tree) not in built:
            built[id(tree)] = torch.from_numpy(
                pack_emit_table(*_emit_tables(*tree)))
    tabs = torch.stack([built[id(t)] for t in trees]).to(dev)
    return rows.view(-1), tabs, live, slots


def emit_pack(terms_list: list, counts: list, trees: list, freqs: list):
    """Emit and pack the terms of B streams, stream ``i`` against
    ``trees[i]`` built from the histogram ``freqs[i]``: K6 in one launch
    over all of them (:func:`emit_input`), then the scatter pack.
    Returns ``[(body bytes, total bits)]``."""
    from .deflate_emit import emit_terms_batch
    from .deflate_optimal import _fetch_bodies

    rows, tabs, live, slots = emit_input(terms_list, counts, trees)
    B = live.shape[0]
    lo, hi, nb = emit_terms_batch(rows, tabs, slots)
    nbv = torch.where(live, nb.view(B, slots), 0)
    offs = torch.cumsum(nbv, dim=1, dtype=torch.int32) - nbv
    bits = max(max_term_bits(*t, f) for t, f in zip(trees, freqs))
    atoms, totals = scatter_pack(lo.view(B, slots), hi.view(B, slots), nbv,
                                 offs, 2 if bits <= 33 else 3,
                                 (3 * slots) // 2 + 8)
    return _fetch_bodies(list(atoms), totals)


def emit_pack_shared(terms_list: list, counts: list, tree, freq):
    """:func:`emit_pack` with ONE tree set, built from ``freq``, for every
    stream."""
    B = len(terms_list)
    return emit_pack(terms_list, counts, [tree] * B, [freq] * B)


def deflate_device(data: bytes, level: int = 3, device=None) -> bytes:
    """One-shot zlib deflate with the device match search and term
    emission (K6 on a CUDA device); the trees and the block header are
    built on the host.

    Levels 8–13 take the batched optimal parse on this one stream
    (:func:`~swift_png_tpu_torch.ops.deflate_optimal.
    deflate_device_optimal_batch`, device size policy).  Below, the greedy
    (levels 0–3) or lazy (4–7) search with ``k`` = 4, 8 or 16 sorted
    neighbours runs twice, with the accept rule run ≥ 6 and with run ≥ 4 at
    distances under 1,024, and the stream with fewer bits ships.
    """
    from .deflate_optimal import deflate_device_optimal_batch

    dev = resolve_device(device)
    if level >= 8:
        return deflate_device_optimal_batch([data], level=level, device=dev,
                                            size_policy="device")[0]
    lazy = level >= 4
    k = 4 if level <= 2 else (8 if level <= 5 else 16)
    n = len(data)
    out = BitWriter()
    out.write_bytes(bytes([0x78, ~((0x78 * 256) % 31) & 31]))
    if n < 3:
        _write_stored_block(out, data, True)
    else:
        N = 1 << max(12, (n - 1).bit_length())
        buf = torch.zeros(N, dtype=torch.uint8)
        buf[:n] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        buf = buf.to(dev)
        candidates = []
        for mr, sf in ((6, 0), (4, 1024)):
            terms, valid, _ = greedy_tokens(buf, n, t_cap=N, lazy=lazy, k=k,
                                            min_run=mr, short_far=sf)
            t_np, v_np = terms.cpu().numpy(), valid.cpu().numpy()
            freq = term_frequencies(t_np, v_np)
            ll = lengths_from_frequencies(freq[:286], 15, force=True)
            dl = lengths_from_frequencies(freq[288:318], 15, force=False)
            candidates.append((_stream_bits(t_np, v_np, ll, dl), terms,
                               valid, freq, ll, dl))
        _, terms, valid, freq, lit_l, dist_l = min(candidates,
                                                   key=lambda c: c[0])
        body, total = emit_pack_shared([terms], [int(valid.sum())],
                                       (lit_l, dist_l), freq)[0]
        _write_block_header_and_tables(out, lit_l, dist_l, True)
        append_bits(out, body, total)
        eob = canonical_codes(np.asarray(lit_l, np.int64))[256]
        out.write(reverse_bits(int(eob), int(lit_l[256])), int(lit_l[256]))
    out.pad_to_byte()
    return out.drain() + adler32(data).to_bytes(4, "big")
