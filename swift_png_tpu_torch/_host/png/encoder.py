"""The single-image scanline encoder: collect → filter select → deflate →
IDAT chunks (a copy of ``swift_png_tpu/png/encoder.py``).

``Encoder.pull`` gives one IDAT chunk's bytes a call and keeps a resumable
(row, pass) cursor (``PNG.Encoder.swift:33-129``).  ``filter_select``
computes all five filtered candidates of a row and keeps the one with the
least sum of absolute signed bytes, ties to the lowest filter type
(``:132-234``), the rule the batched encoder's filter select follows on the
device.
"""

from __future__ import annotations

import numpy as np

from ..lz77.deflate import make_deflator
from .decoder import ADAM7, adam7_subimage, paeth
from .format import IOS


def filter_candidates(cur: np.ndarray, prev: np.ndarray,
                      delay: int) -> np.ndarray:
    """The five filtered versions of one scanline (without filter bytes),
    shape (5, n) uint8."""
    n = cur.size
    out = np.empty((5, n), np.uint8)
    out[0] = cur
    # sub: x - a
    out[1, :delay] = cur[:delay]
    out[1, delay:] = cur[delay:] - cur[:-delay]
    # up: x - b
    out[2] = cur - prev
    # average: x - (a + b) >> 1
    a = np.zeros(n, np.int16)
    a[delay:] = cur[:-delay]
    b = prev.astype(np.int16)
    out[3] = cur - ((a + b) >> 1).astype(np.uint8)
    # paeth: x - paeth(a, b, c)
    c = np.zeros(n, np.uint8)
    c[delay:] = prev[:-delay]
    a8 = np.zeros(n, np.uint8)
    a8[delay:] = cur[:-delay]
    out[4] = cur - paeth(a8, prev, c)
    return out


def filter_select(cur: np.ndarray, prev: np.ndarray,
                  delay: int) -> np.ndarray:
    """The scanline with its filter byte, filtered by the candidate of
    least sum of ``|int8|`` (``PNG.Encoder.swift:230-234``)."""
    candidates = filter_candidates(cur, prev, delay)
    scores = np.abs(candidates.astype(np.int8).astype(np.int32)).sum(axis=1)
    best = int(np.argmin(scores))
    line = np.empty(cur.size + 1, np.uint8)
    line[0] = best
    line[1:] = candidates[best]
    return line


class Encoder:
    """Per-image encode state (``PNG.Encoder``).  ``engine`` is
    ``make_deflator``'s: ``auto``, ``native`` or ``python``."""

    def __init__(self, standard: str, interlaced: bool, level: int,
                 hint: int, engine: str = "auto"):
        self.row: tuple[int, np.ndarray] | None = None
        self.pass_: int | None | str = 0 if interlaced else "image"
        self.deflator = make_deflator(
            "ios" if standard == IOS else "zlib", level=level,
            hint=max(1, min(hint, 0x7FFFFFFF)), engine=engine)

    def _rows(self, count: int, pitch: int, delay: int, delegate, base,
              stride) -> bytes | None:
        """Collect, filter and push the next of ``count`` rows; a chunk
        when the deflater has one ready before the next row, else
        ``None``."""
        if self.row is not None:
            start, last = self.row
        else:
            start, last = 0, np.zeros(pitch, np.uint8)
        self.row = None
        for y in range(start, count):
            data = self.deflator.pop()
            if data is not None:
                self.row = (y, last)
                return data
            cur = np.zeros(pitch, np.uint8)
            delegate(cur, (base[0], base[1] + y * stride[1]), stride[0])
            self.deflator.push(filter_select(cur, last, delay).tobytes())
            last = cur
        return None

    def pull(self, size: tuple[int, int], pixel, delegate) -> bytes | None:
        """The next IDAT chunk's bytes, or ``None`` when done.

        ``delegate(scanline, base, stride_x)`` fills one scanline's raw
        bytes (the image's ``collect``)."""
        delay = (pixel.volume + 7) >> 3
        if self.pass_ == "image":
            pitch = (size[0] * pixel.volume + 7) >> 3
            ready = self._rows(size[1], pitch, delay, delegate, (0, 0),
                               (1, 1))
            if ready is not None:
                return ready
            self.deflator.push(b"", last=True)
            self.pass_ = None
        elif isinstance(self.pass_, int):
            for z in range(self.pass_, 7):
                base, stride = ADAM7[z]
                sub_x, sub_y = adam7_subimage(size, z)
                if sub_x <= 0 or sub_y <= 0:
                    continue
                pitch = (sub_x * pixel.volume + 7) >> 3
                ready = self._rows(sub_y, pitch, delay, delegate, base,
                                   stride)
                if ready is not None:
                    self.pass_ = z
                    return ready
            self.deflator.push(b"", last=True)
            self.pass_ = None

        out = self.deflator.pull()
        return out or None
