"""The RGBA colour target (a copy of ``swift_png_tpu/models/rgba.py``):
unpack by format with chroma keys, pack, and the premultiplication at a
narrower bit width that iOS (CgBI) files carry (``PNG.RGBA.swift``)."""

from __future__ import annotations

import numpy as np

from .color import (
    ColorTarget,
    deconvolve_samples,
    rescale,
    samples_from_storage,
)


class _RGBATarget(ColorTarget):
    def __init__(self, bits: int):
        self.bits = bits
        self.dtype = np.uint8 if bits == 8 else np.uint16

    # -- unpack -------------------------------------------------------------

    def unpack(self, storage: np.ndarray, format, size,
               deindexer=None) -> np.ndarray:
        """storage → (y, x, 4) array in target precision.

        ``deindexer`` is the vectorized counterpart of the reference's
        ``unpack(as:deindexer:)`` closure (``PNG.Color.swift:13-155``): a
        callable ``palette → (n, 4) uint8 aggregate table``; the default
        uses the palette entries directly (``PNG.Color.swift:159-228``).
        """
        x, y = size
        kind = format.kind
        depth = format.pixel.depth
        tmax = (1 << self.bits) - 1
        out = np.empty((y * x, 4), self.dtype)

        if format.is_indexed:
            if deindexer is not None:
                palette = np.asarray(deindexer(format.palette),
                                     np.uint16).reshape(-1, 4)
            else:
                palette = np.array(format.palette, np.uint16)  # (n, 4)
            idx = storage.reshape(-1).astype(np.int64)
            gathered = palette[idx]  # deindexer (PNG.Color.swift:159-228)
            out[:] = rescale(gathered, 8, self.bits)
            return out.reshape(y, x, 4)

        channels = format.pixel.channels
        raw = samples_from_storage(storage, kind, channels)
        scaled = rescale(raw, depth, self.bits)
        key = format.key

        if channels == 1:  # grayscale
            out[:, 0] = out[:, 1] = out[:, 2] = scaled[:, 0]
            if key is None:
                out[:, 3] = tmax
            else:
                out[:, 3] = np.where(raw[:, 0] == key, 0, tmax)
        elif channels == 2:  # grayscale-alpha
            out[:, 0] = out[:, 1] = out[:, 2] = scaled[:, 0]
            out[:, 3] = scaled[:, 1]
        elif channels == 3:
            if format.is_bgr:
                out[:, 0] = scaled[:, 2]
                out[:, 1] = scaled[:, 1]
                out[:, 2] = scaled[:, 0]
            else:
                out[:, :3] = scaled
            if key is None:
                out[:, 3] = tmax
            else:
                k = np.array(key, raw.dtype)
                out[:, 3] = np.where((raw == k).all(axis=1), 0, tmax)
        else:  # rgba
            if format.is_bgr:
                out[:, 0] = scaled[:, 2]
                out[:, 1] = scaled[:, 1]
                out[:, 2] = scaled[:, 0]
                out[:, 3] = scaled[:, 3]
            else:
                out[:] = scaled
        return out.reshape(y, x, 4)

    # -- pack ---------------------------------------------------------------

    def pack(self, pixels: np.ndarray, format, indexer=None) -> np.ndarray:
        """(pixels, 4) array in target precision → storage bytes
        (``PNG.RGBA.pack``, ``PNG.RGBA.swift:409-478``).

        ``indexer`` mirrors ``pack(_:as:indexer:)``: a callable
        ``palette → (aggregates (m, 4) uint8 → (m,) indices)``; the
        default is the exact-match palette lookup."""
        pixels = pixels.reshape(-1, 4).astype(self.dtype)
        kind = format.kind
        depth = format.pixel.depth
        if format.is_indexed:
            small = ((pixels >> (self.bits - 8)).astype(np.uint16)
                     if self.bits == 16 else pixels)
            if indexer is not None:
                fn = indexer(format.palette)
                return np.asarray(fn(small.astype(np.uint8)), np.uint8)
            # default indexer: exact-match palette lookup
            lut = {tuple(int(v) for v in entry): i
                   for i, entry in enumerate(format.palette)}
            idx = np.array(
                [lut.get(tuple(int(v) for v in px), 0) for px in small],
                np.uint8,
            )
            return idx
        channels = format.pixel.channels
        if channels == 1:
            values = pixels[:, :1]
        elif channels == 2:
            values = pixels[:, [0, 3]]
        elif channels == 3:
            values = pixels[:, [2, 1, 0]] if format.is_bgr else pixels[:, :3]
        else:
            values = pixels[:, [2, 1, 0, 3]] if format.is_bgr else pixels
        return deconvolve_samples(values, kind, depth)

    # -- premultiplication (CgBI emulation, PNG.RGBA.swift:146-207) ---------

    def premultiplied(self, pixels: np.ndarray,
                      as_bits: int | None = None) -> np.ndarray:
        """Premultiply color channels by alpha, optionally at a narrower bit
        width (``premultiplied(as: UInt8.self)`` emulates CgBI precision)."""
        from . import premultiply

        as_bits = as_bits or self.bits
        rgb = pixels[..., :3]
        alpha = pixels[..., 3:]
        if as_bits == self.bits:
            out = pixels.copy()
            out[..., :3] = premultiply(rgb, np.broadcast_to(alpha, rgb.shape))
            return out
        # reduce to as_bits precision, premultiply there, upscale back —
        # including the alpha channel (``PNG.RGBA.swift:152-159``)
        shift = self.bits - as_bits
        q = ((1 << self.bits) - 1) // ((1 << as_bits) - 1)
        small_rgb = (rgb >> shift).astype(np.uint8)
        small_a = (alpha >> shift).astype(np.uint8)
        pm = premultiply(small_rgb, np.broadcast_to(small_a, small_rgb.shape))
        out = pixels.copy()
        out[..., :3] = pm.astype(self.dtype) * q
        out[..., 3:] = small_a.astype(self.dtype) * q
        return out

    def straightened(self, pixels: np.ndarray) -> np.ndarray:
        from . import straighten

        out = pixels.copy()
        rgb = pixels[..., :3]
        alpha = np.broadcast_to(pixels[..., 3:], rgb.shape)
        out[..., :3] = straighten(rgb, alpha)
        return out


class RGBA:
    """Namespace mirroring ``PNG.RGBA<T>``: ``RGBA.of8`` / ``RGBA.of16``."""

    of8 = _RGBATarget(8)
    of16 = _RGBATarget(16)
