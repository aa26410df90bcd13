"""The VA (value–alpha) colour target (a copy of
``swift_png_tpu/models/va.py``): the colour and palette kinds give their r
channel as the value (``PNG.VA.swift``)."""

from __future__ import annotations

import numpy as np

from .color import (ColorTarget, deconvolve_samples, rescale,
                    samples_from_storage)


class _VATarget(ColorTarget):
    def __init__(self, bits: int):
        self.bits = bits
        self.dtype = np.uint8 if bits == 8 else np.uint16

    def unpack(self, storage: np.ndarray, format, size,
               deindexer=None) -> np.ndarray:
        x, y = size
        kind = format.kind
        depth = format.pixel.depth
        tmax = (1 << self.bits) - 1
        out = np.empty((y * x, 2), self.dtype)

        if format.is_indexed:
            idx = storage.reshape(-1).astype(np.int64)
            if deindexer is not None:
                table = np.asarray(deindexer(format.palette),
                                   np.uint16).reshape(-1, 2)
                gathered = table[idx]
            else:
                palette = np.array(format.palette, np.uint16)
                gathered = palette[idx][:, [0, 3]]  # (v = r, alpha)
            out[:] = rescale(gathered, 8, self.bits)
            return out.reshape(y, x, 2)

        channels = format.pixel.channels
        raw = samples_from_storage(storage, kind, channels)
        scaled = rescale(raw, depth, self.bits)
        key = format.key
        if channels == 1:
            out[:, 0] = scaled[:, 0]
            if key is None:
                out[:, 1] = tmax
            else:
                out[:, 1] = np.where(raw[:, 0] == key, 0, tmax)
        elif channels == 2:
            out[:] = scaled
        elif channels == 3:
            out[:, 0] = scaled[:, 2] if format.is_bgr else scaled[:, 0]
            if key is None:
                out[:, 1] = tmax
            else:
                k = np.array(key, raw.dtype)
                out[:, 1] = np.where((raw == k).all(axis=1), 0, tmax)
        else:
            out[:, 0] = scaled[:, 2] if format.is_bgr else scaled[:, 0]
            out[:, 1] = scaled[:, 3]
        return out.reshape(y, x, 2)

    def pack(self, pixels: np.ndarray, format, indexer=None) -> np.ndarray:
        """VA pixels → storage; color formats replicate v into rgb
        (``PNG.VA.pack``)."""
        pixels = pixels.reshape(-1, 2).astype(self.dtype)
        kind = format.kind
        depth = format.pixel.depth
        channels = format.pixel.channels
        if format.is_indexed and indexer is not None:
            small = (pixels >> (self.bits - 8)) if self.bits == 16 else pixels
            fn = indexer(format.palette)
            return np.asarray(fn(small.astype(np.uint8)), np.uint8)
        if format.is_indexed:
            lut = {}
            for i, (r, g, b, a) in enumerate(format.palette):
                lut.setdefault((r, a), i)
            small = (pixels >> (self.bits - 8)) if self.bits == 16 else pixels
            return np.array(
                [lut.get((int(v), int(a)), 0) for v, a in small], np.uint8)
        if channels == 1:
            values = pixels[:, :1]
        elif channels == 2:
            values = pixels
        elif channels == 3:
            values = np.repeat(pixels[:, :1], 3, axis=1)
        else:
            values = np.concatenate(
                [np.repeat(pixels[:, :1], 3, axis=1), pixels[:, 1:]], axis=1)
        return deconvolve_samples(values, kind, depth)


class VA:
    """Namespace mirroring ``PNG.VA<T>``: use ``VA.of8`` / ``VA.of16``."""

    of8 = _VATarget(8)
    of16 = _VATarget(16)
