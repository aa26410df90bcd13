"""Term emission (K6): packed DeflatorTerm → ``(lo, hi, nbits)``.

Counterpart of ``swift_png_tpu/ops/deflate_emit.py`` (``_emit_kernel``,
``emit_terms_batch``, ``pack_emit_table``).  Each term becomes its
Huffman code, run extra bits, distance code and distance extra bits as
one ≤48-bit piece, read from its image's 320-row emit table (``bits |
len<<16``: literal/run symbols in rows 0…287, distance decades in rows
288…317) and the RFC 1951 closed forms.  Dead slots (term 0) get the
values the formulas give them; the packer masks them by bit count.

:func:`emit_terms_batch` launches the CUDA kernel (``csrc/emit.cu``) for a
CUDA tensor and runs :func:`emit_terms_reference` for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from .deflate import term_pieces

__all__ = ["ROWS", "pack_emit_table", "emit_terms_batch",
           "emit_terms_reference"]

ROWS = 320  # 288 lit/run + 30 distance rows, padded to a multiple of 8
BLOCK = 256  # terms per block of the CUDA kernel


def pack_emit_table(lit_bits, lit_len, dist_bits, dist_len) -> np.ndarray:
    """(320,) int32 combined emit table for one image."""
    t = np.zeros(ROWS, np.int32)
    t[:288] = np.asarray(lit_bits) | (np.asarray(lit_len) << 16)
    t[288:288 + 30] = (np.asarray(dist_bits)[:30]
                       | (np.asarray(dist_len)[:30] << 16))
    return t


def _check(terms, tabs, per_image):
    if (terms.dim() != 1 or tabs.dim() != 2 or tabs.shape[1] != ROWS
            or terms.shape[0] != tabs.shape[0] * per_image):
        raise ValueError(f"emit_terms_batch: want terms (B·{per_image},) and "
                         f"tabs (B, {ROWS}), got {tuple(terms.shape)}, "
                         f"{tuple(tabs.shape)}")


def emit_terms_batch(terms: torch.Tensor, tabs: torch.Tensor,
                     per_image: int):
    """Batched term emission.

    ``terms``: ``(B·per_image,)`` int32, image ``i``'s terms at
    ``[i·per_image, (i+1)·per_image)``; ``tabs``: ``(B, 320)`` int32
    per-image emit tables (:func:`pack_emit_table`).  Returns ``(lo, hi,
    nbits)``, each like ``terms``.
    """
    _check(terms, tabs, per_image)
    if terms.device.type == "cpu":
        return emit_terms_reference(terms, tabs, per_image)
    return emit_terms_cuda(terms, tabs, per_image)


def emit_terms_cuda(terms: torch.Tensor, tabs: torch.Tensor,
                    per_image: int):
    """Launch K6 (``csrc/emit.cu``)."""
    _check(terms, tabs, per_image)
    if per_image % BLOCK:
        raise ValueError(f"per_image must be a multiple of {BLOCK}")
    _kernels.require(terms, "terms", torch.int32, 1)
    _kernels.require(tabs, "tabs", torch.int32, 2)
    lo, hi, nb = (torch.empty_like(terms) for _ in range(3))
    _kernels.KERNELS["emit"].launch(
        terms.data_ptr(), tabs.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        nb.data_ptr(), terms.shape[0], per_image,
        _kernels.stream_of(terms))
    return lo, hi, nb


def emit_terms_reference(terms: torch.Tensor, tabs: torch.Tensor,
                         per_image: int):
    """Plain PyTorch K6: two gathers from the flattened per-image tables."""
    _check(terms, tabs, per_image)
    flat = tabs.reshape(-1)
    row = (torch.arange(terms.shape[0], device=terms.device)
           // per_image) * ROWS
    return term_pieces(terms, lambda s: flat[row + s],
                       lambda d: flat[row + 288 + d])
