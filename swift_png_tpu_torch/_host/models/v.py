"""The scalar (gray value) colour target (a copy of
``swift_png_tpu/models/v.py``): unpack takes the value channel (r for the
colour kinds) and drops alpha; pack repeats the value in every colour
channel with an opaque alpha."""

from __future__ import annotations

import numpy as np

from .color import (ColorTarget, deconvolve_samples, rescale,
                    samples_from_storage)


class _VTarget(ColorTarget):
    def __init__(self, bits: int):
        self.bits = bits
        self.dtype = np.uint8 if bits == 8 else np.uint16

    def unpack(self, storage: np.ndarray, format, size,
               deindexer=None) -> np.ndarray:
        x, y = size
        depth = format.pixel.depth
        if format.is_indexed:
            idx = storage.reshape(-1).astype(np.int64)
            if deindexer is not None:
                table = np.asarray(deindexer(format.palette),
                                   np.uint16).reshape(-1)
                v = table[idx]
            else:
                palette = np.array(format.palette, np.uint16)
                v = palette[idx][:, 0]  # deindexer: value = r
            return rescale(v, 8, self.bits).reshape(y, x)
        channels = format.pixel.channels
        raw = samples_from_storage(storage, format.kind, channels)
        scaled = rescale(raw, depth, self.bits)
        if channels >= 3 and format.is_bgr:
            v = scaled[:, 2]
        else:
            v = scaled[:, 0]
        return v.reshape(y, x)

    def pack(self, pixels: np.ndarray, format, indexer=None) -> np.ndarray:
        pixels = pixels.reshape(-1).astype(self.dtype)
        channels = format.pixel.channels
        depth = format.pixel.depth
        if format.is_indexed and indexer is not None:
            small = (pixels >> (self.bits - 8)) if self.bits == 16 else pixels
            fn = indexer(format.palette)
            return np.asarray(fn(small.astype(np.uint8)), np.uint8)
        if format.is_indexed:
            # default indexer semantics: exact (v, v, v, opaque) entry or 0
            # (``PNG.Image.swift:1142``); matches RGBA.pack's exact lookup
            lut = {}
            for i, entry in enumerate(format.palette):
                lut.setdefault(tuple(int(x) for x in entry), i)
            small = (pixels >> (self.bits - 8)) if self.bits == 16 else pixels
            return np.array(
                [lut.get((int(v), int(v), int(v), 255), 0) for v in small],
                np.uint8)
        tmax = (1 << self.bits) - 1
        if channels == 1:
            values = pixels[:, None]
        elif channels == 2:
            values = np.stack([pixels, np.full_like(pixels, tmax)], axis=1)
        elif channels == 3:
            values = np.repeat(pixels[:, None], 3, axis=1)
        else:
            values = np.concatenate(
                [np.repeat(pixels[:, None], 3, axis=1),
                 np.full_like(pixels, tmax)[:, None]], axis=1)
        return deconvolve_samples(values, format.kind, depth)


class V:
    """Namespace mirroring the scalar targets: ``V.of8`` / ``V.of16``."""

    of8 = _VTarget(8)
    of16 = _VTarget(16)
