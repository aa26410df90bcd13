"""Canonical Huffman validation, flat decode LUTs and length-limited code
construction (the parts of ``swift_png_tpu/lz77/huffman.py`` the index
walker and the encoder read)."""

from __future__ import annotations

import numpy as np

from ..bits import reverse_bits


class HuffmanError(ValueError):
    pass


def validate(lengths: np.ndarray) -> None:
    """Check that nonzero ``lengths`` form a complete canonical code.

    Zero used symbols is accepted (empty tree, legal for DEFLATE distance
    trees); exactly one used symbol is accepted as a 1-bit stub; otherwise
    the Kraft sum must be exactly 1.
    """
    used = lengths[lengths > 0]
    if used.size <= 1:
        return
    max_len = int(used.max())
    kraft = int((1 << max_len >> used.astype(np.int64)).sum())
    if kraft != (1 << max_len):
        raise HuffmanError(
            f"code lengths are {'over' if kraft > (1 << max_len) else 'under'}"
            f"-subscribed (kraft {kraft} / {1 << max_len})")


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codewords (MSB-first integers) per RFC 1951 §3.2.2."""
    lengths = np.asarray(lengths, dtype=np.int64)
    max_len = int(lengths.max(initial=0))
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_len + 2, dtype=np.int64)
    code = 0
    for l in range(1, max_len + 1):
        code = (code + int(bl_count[l - 1])) << 1
        next_code[l] = code
    codes = np.zeros_like(lengths)
    for sym in range(lengths.size):
        l = int(lengths[sym])
        if l:
            codes[sym] = next_code[l]
            next_code[l] += 1
    return codes


def decode_table(lengths: np.ndarray, max_len: int = 15) -> np.ndarray:
    """Flat decode LUT of ``2**max_len`` entries ``(length << 16) | symbol``,
    indexed by the next ``max_len`` stream bits (LSB-first).  Single-symbol
    trees decode that symbol with a 1-bit code; unreachable entries are 0
    (length 0 ⇒ invalid)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    validate(lengths)
    table = np.zeros(1 << max_len, dtype=np.uint32)
    used = np.nonzero(lengths)[0]
    if used.size == 0:
        return table
    if used.size == 1:
        sym = int(used[0])
        eff = np.zeros_like(lengths)
        eff[sym] = 1
        codes = np.zeros_like(lengths)
    else:
        eff = lengths
        codes = canonical_codes(lengths)
    for sym in used:
        l = int(eff[sym])
        rev = reverse_bits(int(codes[sym]), l)
        table[rev::1 << l] = (l << 16) | int(sym)
    return table


def lengths_from_frequencies(frequencies: np.ndarray, limit: int,
                             force: bool = True) -> np.ndarray:
    """Optimal length-limited code lengths via package-merge.

    ``force`` ensures at least two symbols get codes when only 0–1 have
    nonzero frequency (DEFLATE requires the literal tree to encode at
    least the end-of-block symbol).  The lengths are the stream's trees,
    so this is a copy of the JAX package's function, ties and all.
    """
    freqs = np.asarray(frequencies, dtype=np.int64)
    n = freqs.size
    used = np.nonzero(freqs)[0]
    lengths = np.zeros(n, dtype=np.int64)
    if used.size == 0:
        if force and n >= 2:
            lengths[0] = lengths[1] = 1
        return lengths
    if used.size == 1:
        lengths[used[0]] = 1
        if force:
            other = 0 if used[0] != 0 else 1
            if n >= 2:
                lengths[other] = 1
        return lengths
    if used.size > (1 << limit):
        raise HuffmanError("too many symbols for the length limit")

    # lengths[sym] = number of times sym appears across the first
    # (2·n_used - 2) items of the merged package hierarchy
    items = sorted((int(freqs[s]), int(s)) for s in used)
    level = [(w, (s,)) for w, s in items]
    for _ in range(limit - 1):
        paired = []
        for i in range(0, len(level) - 1, 2):
            w = level[i][0] + level[i + 1][0]
            syms = level[i][1] + level[i + 1][1]
            paired.append((w, syms))
        level = sorted(paired + [(w, (s,)) for w, s in items])
    take = 2 * used.size - 2
    counts = np.zeros(n, dtype=np.int64)
    for w, syms in level[:take]:
        for s in syms:
            counts[s] += 1
    lengths[used] = counts[used]
    return lengths
