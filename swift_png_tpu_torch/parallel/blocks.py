"""Segment-parallel deflate: one stream compressed as independent blocks.

Counterpart of ``swift_png_tpu/parallel/blocks.py``.  The input splits
into segments of ``L`` bytes; each segment compresses on its own (the
window resets at its start, so no match crosses a boundary), so the
segments' match searches are independent and shard over a device mesh.
Each segment becomes one dynamic DEFLATE block with its own trees; K6
emits the terms of every segment in one launch, each against its
segment's table, and the host joins the bit-aligned bodies in order.  The
stream's Adler-32 comes from the segments' checksums with the associative
combine (``adler32_combine``), not from one pass over the whole input.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from .._host.bits import BitWriter, reverse_bits
from .._host.lz77.checksums import adler32_combine
from .._host.lz77.deflate import _write_stored_block
from .._host.lz77.huffman import canonical_codes, lengths_from_frequencies
from .._kernels import resolve_device
from ..ops.deflate import (_write_block_header_and_tables, append_bits,
                           emit_pack, greedy_tokens, term_frequencies)
from .distributed import axis_block, gather_blocks, mesh_device

__all__ = ["segment_tokens", "segment_trees", "deflate_segmented"]


def segment_tokens(seg_data: torch.Tensor, seg_len, *, t_cap: int,
                   lazy: bool):
    """The greedy (``lazy``: lazy) match search over independent segments.

    ``seg_data``: ``(S, L)`` uint8, one zero-padded segment a row;
    ``seg_len``: the ``S`` live lengths.  Returns ``(terms (S, t_cap)
    int32, valid (S, t_cap) bool, counts (S,) int64)``, each segment's
    :func:`~swift_png_tpu_torch.ops.deflate.greedy_tokens` (the JAX
    version maps it over the segments; here the segments run one after
    another on the tensor's device).
    """
    lens = [int(n) for n in seg_len]
    out = [greedy_tokens(seg_data[s], lens[s], t_cap=t_cap, lazy=lazy)
           for s in range(len(lens))]
    dev = seg_data.device
    if not out:
        return (torch.zeros((0, t_cap), dtype=torch.int32, device=dev),
                torch.zeros((0, t_cap), dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    return (torch.stack([t for t, _, _ in out]),
            torch.stack([v for _, v, _ in out]),
            torch.tensor([c for _, _, c in out], dtype=torch.int64,
                         device=dev))


def segment_trees(terms: np.ndarray, counts: list[int]):
    """Each segment's trees from its own histogram: ``(trees [(lit
    lengths, dist lengths)], histograms)`` of the first ``counts[s]``
    terms of each row of ``terms``."""
    trees, freqs = [], []
    for row, count in zip(terms, counts):
        freq = term_frequencies(row[:count], np.ones(count, bool))
        trees.append((lengths_from_frequencies(freq[:286], 15, force=True),
                      lengths_from_frequencies(freq[288:318], 15,
                                               force=False)))
        freqs.append(freq)
    return trees, freqs


def deflate_segmented(data: bytes, level: int = 6, segments: int = 8,
                      mesh=None, device=None) -> bytes:
    """One-shot zlib deflate of ``data`` as independent dynamic blocks,
    the same bytes as the JAX version.

    Under 3 bytes, or under ``16 · segments``, one stored block.  Else
    the segment length ``L`` is the power of two at least ``ceil(n /
    segments)`` and no less than 4,096, so ``ceil(n / L)`` segments (up
    to ``segments``); the search is lazy at ``level >= 4``.  Each segment
    gets trees from its own histogram, one dynamic block and its
    end-of-block code; the last block is final.

    ``mesh``: a ``DeviceMesh``; each process then searches its contiguous
    block of segments along the mesh's first dimension, the terms come
    back to every process with ``all_gather_into_tensor``, and every
    process returns the same stream, equal to ``mesh=None``'s.  The device
    is the mesh's, or ``device`` (``cuda`` unless the caller names
    another).
    """
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    n = len(data)
    out = BitWriter()
    out.write_bytes(bytes([0x78, ~((0x78 * 256) % 31) & 31]))
    if n < 3 or n < segments * 16:
        _write_stored_block(out, data, True)
        out.pad_to_byte()
        return out.drain() + zlib.adler32(data).to_bytes(4, "big")

    lazy = level >= 4
    L = 1 << max(12, (-(-n // segments) - 1).bit_length())
    nseg = -(-n // L)
    seg_len = [min(L, n - s * L) for s in range(nseg)]
    seg = torch.zeros(nseg * L, dtype=torch.uint8)
    seg[:n] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    seg = seg.view(nseg, L)
    if mesh is None:
        terms, _, counts = segment_tokens(seg.to(dev), seg_len, t_cap=L,
                                          lazy=lazy)
    else:
        axis = mesh.mesh_dim_names[0]
        lo, hi, block = axis_block(mesh, axis, nseg)
        terms, _, counts = segment_tokens(seg[lo:hi].to(dev), seg_len[lo:hi],
                                          t_cap=L, lazy=lazy)
        terms = gather_blocks(mesh, axis, terms, nseg, block)
        counts = gather_blocks(mesh, axis, counts, nseg, block)

    # per-segment trees on the host, then K6 once for every segment
    counts_h = counts.cpu().tolist()
    trees, freqs = segment_trees(terms.cpu().numpy(), counts_h)
    bodies = emit_pack(list(terms), counts_h, trees, freqs)
    for s, ((lit_l, dist_l), (body, total)) in enumerate(zip(trees, bodies)):
        _write_block_header_and_tables(out, lit_l, dist_l, s == nseg - 1)
        append_bits(out, body, total)
        eob = canonical_codes(np.asarray(lit_l, np.int64))[256]
        out.write(reverse_bits(int(eob), int(lit_l[256])), int(lit_l[256]))
    out.pad_to_byte()

    # the stream's checksum: the segments' Adler-32s, combined in order
    adler = 1
    for s in range(nseg):
        piece = data[s * L: s * L + seg_len[s]]
        adler = adler32_combine(adler, zlib.adler32(piece), len(piece))
    return out.drain() + adler.to_bytes(4, "big")
