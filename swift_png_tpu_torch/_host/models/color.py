"""The colour-target protocol and the sample arithmetic the targets share
(a copy of ``swift_png_tpu/models/color.py``): big-endian 16-bit atoms,
depth rescale by the exact quantum multiply or a shift, and the way back
to storage bytes."""

from __future__ import annotations

import numpy as np


def quantum(source_depth: int, dest_bits: int) -> int:
    """(2^dest − 1) / (2^source − 1), exact for PNG depths."""
    return ((1 << dest_bits) - 1) // ((1 << source_depth) - 1)


def samples_from_storage(storage: np.ndarray, kind: str,
                         channels: int) -> np.ndarray:
    """Raw samples from image storage, shape (pixels, channels): the bytes,
    or big-endian uint16 for the 16-bit kinds."""
    if kind.endswith("16"):
        atoms = storage.reshape(-1, 2)
        samples = (atoms[:, 0].astype(np.uint16) << 8) | atoms[:, 1]
        return samples.reshape(-1, channels)
    return storage.reshape(-1, channels)


def rescale(samples: np.ndarray, source_depth: int,
            dest_bits: int) -> np.ndarray:
    """Samples at ``source_depth`` → ``dest_bits`` (8 → uint8, 16 →
    uint16): up by the quantum, down by a shift."""
    dtype = np.uint8 if dest_bits == 8 else np.uint16
    if dest_bits == source_depth:
        return samples.astype(dtype)
    if dest_bits > source_depth:
        q = quantum(source_depth, dest_bits)
        return (samples.astype(np.uint32) * q).astype(dtype)
    return (samples >> (source_depth - dest_bits)).astype(dtype)


def descale(values: np.ndarray, source_bits: int,
            dest_depth: int) -> np.ndarray:
    """The rescale of packing: values at ``source_bits`` → uint16 samples
    at ``dest_depth``."""
    if dest_depth == source_bits:
        return values.astype(np.uint16)
    if dest_depth < source_bits:
        return (values >> (source_bits - dest_depth)).astype(np.uint16)
    q = quantum(source_bits, dest_depth)
    return (values.astype(np.uint32) * q).astype(np.uint16)


def samples_to_storage(samples: np.ndarray, kind: str) -> np.ndarray:
    """Samples (pixels, channels) → flat storage bytes (big-endian pairs
    for the 16-bit kinds)."""
    if kind.endswith("16"):
        flat = samples.reshape(-1)
        out = np.empty(flat.size * 2, np.uint8)
        out[0::2] = (flat >> 8).astype(np.uint8)
        out[1::2] = (flat & 0xFF).astype(np.uint8)
        return out
    return samples.astype(np.uint8).reshape(-1)


def deconvolve_samples(values: np.ndarray, kind: str,
                       depth: int) -> np.ndarray:
    """Values (pixels, channels) at the target's precision (uint8 or
    uint16) → storage bytes."""
    bits = 8 if values.dtype == np.uint8 else 16
    return samples_to_storage(descale(values, bits, depth), kind)


class ColorTarget:
    """The shape of a colour target (``PNG.Color``): ``unpack(storage,
    format, size)`` and ``pack(pixels, format)``.  Custom targets subclass
    this."""

    def unpack(self, storage, format, size):  # pragma: no cover
        raise NotImplementedError

    def pack(self, pixels, format):  # pragma: no cover
        raise NotImplementedError
