"""DEFLATE term emission, bit packing and block serialization (plain
PyTorch and host).

Counterparts of the parts of ``swift_png_tpu/ops/deflate.py`` the level
8–13 encoder reads: :func:`term_pieces` (each packed DeflatorTerm → its
≤48-bit code + extra bits as an int32 ``(lo, hi)`` pair and a bit count,
as ``pack_terms32`` computes), :func:`scatter_pack` (``pack_bits32``'s
scatter: up to three scatter-adds per term land the bit-disjoint pieces
at their stream offsets in 32-bit atoms, so add equals OR),
``max_term_bits``, ``atoms32_to_bytes``, ``_emit_tables`` and
``_write_block_header_and_tables``.  The arithmetic stays in int32 with
the JAX package's arithmetic right shifts and ``& 0x7FFFFFFF`` masks, so
every atom has the same bits.

:func:`append_bits` replaces ``_append_bits``, which wrote one Python call
per body byte: it splices the whole body into the bit writer with one
shift of a Python integer, byte for byte the same stream.
"""

from __future__ import annotations

import numpy as np
import torch

from .._host.bits import BitWriter, reverse_bits
from .._host.lz77 import constants as C
from .._host.lz77.deflate import _META_EXTRA, _metaterms
from .._host.lz77.huffman import canonical_codes, lengths_from_frequencies

__all__ = ["term_pieces", "scatter_pack", "max_term_bits",
           "atoms32_to_bytes", "append_bits"]


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
