"""Colour targets: unpacking image storage to pixel arrays and packing
them back (copies of ``swift_png_tpu/models``): ``RGBA``, ``V`` (value) and
``VA`` (value–alpha) at 8 or 16 bits, and the exact integer
``premultiply`` and ``straighten`` (``PNG.swift:54-117``).

Targets give numpy arrays of shape (y, x, channels); the batched decoder
does the same on the device in :mod:`swift_png_tpu_torch.ops.convolve`.
"""

from __future__ import annotations

import numpy as np

from .color import ColorTarget, deconvolve_samples, samples_from_storage
from .rgba import RGBA
from .v import V
from .va import VA

__all__ = ["RGBA", "V", "VA", "ColorTarget", "premultiply", "straighten",
           "samples_from_storage", "deconvolve_samples"]


def premultiply(color: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Exact integer premultiplication: ``(color·alpha + max//2) // max``
    in uint64."""
    tmax = np.iinfo(color.dtype).max
    product = color.astype(np.uint64) * alpha.astype(np.uint64) + (tmax >> 1)
    return (product // tmax).astype(color.dtype)


def straighten(premultiplied: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Exact integer straightening: ``(max·color + alpha//2) // alpha`` in
    uint64; the input where ``alpha`` is zero."""
    tmax = np.iinfo(premultiplied.dtype).max
    a = alpha.astype(np.uint64)
    product = np.uint64(tmax) * premultiplied.astype(np.uint64) + (a >> 1)
    out = (product // np.maximum(a, 1)).astype(premultiplied.dtype)
    return np.where(alpha == 0, premultiplied, out)
