"""The single-image scanline decoder: inflate → defilter → delegate (a
copy of ``swift_png_tpu/png/decoder.py``).

``Decoder`` keeps a resumable (row, pass) cursor, so IDAT data may arrive
in pieces of any size (``PNG.Decoder.swift``).  ``defilter`` reverses one
scanline's filter on the host: None and Up as whole-row numpy operations,
Sub as a per-lane prefix sum, Average and Paeth as loops (their
within-row dependency is what the batched decoder's K3 runs as a
wavefront).
"""

from __future__ import annotations

import numpy as np

from ..lz77.inflate import Inflator
from .errors import DecodingError
from .format import IOS

#: Adam7 ((base x, base y), (stride x, stride y)), pass by pass
ADAM7 = (
    ((0, 0), (8, 8)),
    ((4, 0), (8, 8)),
    ((0, 4), (4, 8)),
    ((2, 0), (4, 4)),
    ((0, 2), (2, 4)),
    ((1, 0), (2, 2)),
    ((0, 1), (1, 2)),
)


def adam7_subimage(size: tuple[int, int], z: int) -> tuple[int, int]:
    """(width, height) of Adam7 pass ``z`` of an image of ``size``."""
    (bx, by), (sx, sy) = ADAM7[z]
    return ((size[0] + sx - bx - 1) // sx, (size[1] + sy - by - 1) // sy)


def paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor over whole arrays (``PNG.swift:123-147``)."""
    a16 = a.astype(np.int16)
    b16 = b.astype(np.int16)
    c16 = c.astype(np.int16)
    p = a16 + b16 - c16
    pa = np.abs(p - a16)
    pb = np.abs(p - b16)
    pc = np.abs(p - c16)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def defilter(line: np.ndarray, last: np.ndarray, delay: int) -> np.ndarray:
    """Reverse one scanline's filter in place; ``line[0]`` is the filter
    byte and ``last`` the previous defiltered line.  Filter types above 4
    leave the line as it is, as the reference does."""
    ftype = int(line[0])
    cur = line[1:]
    prev = last[1:]
    n = cur.size
    if ftype == 0 or n == 0:
        return line
    if ftype == 1:  # sub: a prefix sum per lane, modulo 256
        pad = (-n) % delay
        lanes = np.concatenate([cur, np.zeros(pad, np.uint8)]).reshape(
            -1, delay).astype(np.int64)
        summed = np.cumsum(lanes, axis=0) & 0xFF
        cur[:] = summed.astype(np.uint8).reshape(-1)[:n]
    elif ftype == 2:  # up
        cur += prev  # uint8 wraparound
    elif ftype == 3:  # average
        c = cur.astype(np.int32)
        p = prev.astype(np.int32)
        out = np.empty(n, np.int32)
        out[:delay] = (c[:delay] + (p[:delay] >> 1)) & 0xFF
        for i in range(delay, n):
            out[i] = (c[i] + ((out[i - delay] + p[i]) >> 1)) & 0xFF
        cur[:] = out.astype(np.uint8)
    elif ftype == 4:  # paeth
        c = cur.astype(np.int32)
        p = prev.astype(np.int32)
        out = np.empty(n, np.int32)
        # the first pixel has a = c = 0, so the predictor is b
        out[:delay] = (c[:delay] + p[:delay]) & 0xFF
        for i in range(delay, n):
            a = out[i - delay]
            b = p[i]
            cc = p[i - delay]
            pa = abs(b - cc)
            pb = abs(a - cc)
            pc = abs(a + b - 2 * cc)
            if pa <= pb and pa <= pc:
                pred = a
            elif pb <= pc:
                pred = b
            else:
                pred = cc
            out[i] = (c[i] + pred) & 0xFF
        cur[:] = out.astype(np.uint8)
    return line


class Decoder:
    """Per-image decode state (``PNG.Decoder``)."""

    def __init__(self, standard: str, interlaced: bool):
        self.row: tuple[int, np.ndarray] | None = None
        self.pass_: int | None = 0 if interlaced else None
        self.continue_ = True
        self.inflator = Inflator("ios" if standard == IOS else "zlib")

    def _rows(self, count: int, pitch: int, delay: int, delegate,
              base, stride) -> bool:
        """Defilter the next of ``count`` rows of ``pitch`` bytes, calling
        ``delegate`` for each; whether the inflator ran dry first."""
        if self.row is not None:
            start, last = self.row
        else:
            start, last = 0, np.zeros(pitch + 1, np.uint8)
        self.row = None
        for y in range(start, count):
            raw = self.inflator.pull(pitch + 1)
            if raw is None:
                self.row = (y, last)
                return True
            scanline = np.frombuffer(raw, np.uint8).copy()
            defilter(scanline, last, delay)
            delegate(scanline[1:], (base[0], base[1] + y * stride[1]),
                     stride)
            last = scanline
        return False

    def push(self, data: bytes, size: tuple[int, int], pixel,
             delegate) -> bool:
        """Feed one IDAT chunk's bytes; calls ``delegate(scanline, base,
        stride)`` for each row completed.  Returns whether more compressed
        data is expected."""
        if not self.continue_:
            raise DecodingError.extraneous_compressed_data()
        self.inflator.push(data)
        if self.inflator.terminal:
            self.continue_ = False

        delay = (pixel.volume + 7) >> 3
        if self.pass_ is not None:
            for z in range(self.pass_, 7):
                base, stride = ADAM7[z]
                sub_x, sub_y = adam7_subimage(size, z)
                if sub_x <= 0 or sub_y <= 0:
                    continue
                pitch = (sub_x * pixel.volume + 7) >> 3
                if self._rows(sub_y, pitch, delay, delegate, base,
                              stride):
                    self.pass_ = z
                    return self.continue_
        else:
            pitch = (size[0] * pixel.volume + 7) >> 3
            if self._rows(size[1], pitch, delay, delegate, (0, 0),
                          (1, 1)):
                return self.continue_

        self.pass_ = 7
        if self.inflator.pull():
            raise DecodingError.extraneous_image_data()
        return self.continue_
