"""DEFLATE encoder host parts: the level table, the ``Depths`` cost model,
the code-length RLE and stored blocks (copies of ``search_parameters``,
``_default_depths``/``Depths``, ``_metaterms``, ``_META_EXTRA`` and
``_write_stored_block`` from ``swift_png_tpu/lz77/deflate.py``)."""

from __future__ import annotations

import numpy as np

from . import constants as C
from ..bits import BitWriter

GREEDY, LAZY, FULL = 0, 1, 2


def search_parameters(level: int) -> tuple[int, int, int, int]:
    """Return (strategy, attempts, goal, iterations) for a compression
    level."""
    table = {
        0: (GREEDY, 1, 6, 0),
        1: (GREEDY, 2, 8, 0),
        2: (GREEDY, 4, 10, 0),
        3: (GREEDY, 40, 24, 0),
        4: (LAZY, 20, 32, 0),
        5: (LAZY, 40, 54, 0),
        6: (LAZY, 64, 80, 0),
        7: (LAZY, 100, 160, 0),
        8: (FULL, 14, 20, 1),
        9: (FULL, 20, 32, 2),
        10: (FULL, 30, 50, 3),
        11: (FULL, 60, 80, 4),
        12: (FULL, 100, 133, 5),
    }
    if level <= 0:
        return table[0]
    if level >= 13:
        return (FULL, 1 << 30, 258, 6)
    return table[level]


def _default_depths() -> np.ndarray:
    d = np.zeros(542, dtype=np.uint32)
    d[:256] = 33  # literal: 8.25 bits
    runs = np.arange(3, 259)
    d[256:512] = 30 + (C.RUN_EXTRA[C.RUN_DECADE[runs]] << 2)  # 7.5 bits base
    d[512:542] = 19 + (C.DISTANCE_EXTRA << 2)  # 4.75 bits base
    return d


class Depths:
    """Adaptive cost table of the optimal parse, in quarter bits.

    Layout: [0,256) literal costs, [256,512) run costs for lengths 3…258,
    [512,542) distance-decade costs.
    """

    def __init__(self) -> None:
        self.storage = _default_depths()
        self.generic = True

    def update(self, lit_lengths: np.ndarray,
               dist_lengths: np.ndarray) -> None:
        s = self.storage
        for sym in range(min(286, lit_lengths.size)):
            l = int(lit_lengths[sym])
            if l == 0:
                continue
            if sym < 256:
                s[sym] = l << 2
            elif sym > 256:
                decade = sym - 257
                extra = int(C.RUN_EXTRA[decade])
                base = int(C.RUN_BASE[decade])
                lo = 253 + base
                s[lo: min(lo + (1 << extra), 512)] = (l + extra) << 2
        for sym in range(min(30, dist_lengths.size)):
            l = int(dist_lengths[sym])
            if l:
                s[512 + sym] = (l + int(C.DISTANCE_EXTRA[sym])) << 2
        self.generic = False


def _metaterms(lengths: list[int]) -> list[tuple[int, int]]:
    """Code-length RLE → (symbol, extra-bits value) metaterms."""
    terms: list[tuple[int, int]] = []
    i = 0
    n = len(lengths)
    while i < n:
        value = lengths[i]
        j = i
        while j < n and lengths[j] == value:
            j += 1
        reps = j - i
        if value == 0:
            while reps > 138:
                terms.append((18, 138 - 11))
                reps -= 138
            if reps > 10:
                terms.append((18, reps - 11))
            elif reps > 2:
                terms.append((17, reps - 3))
            else:
                terms.extend([(0, 0)] * reps)
        else:
            terms.append((value, 0))
            reps -= 1
            while reps > 6:
                terms.append((16, 6 - 3))
                reps -= 6
            if reps > 2:
                terms.append((16, reps - 3))
            else:
                terms.extend([(value, 0)] * reps)
        i = j
    return terms


_META_EXTRA = {16: 2, 17: 3, 18: 7}


def _write_stored_block(out: BitWriter, data: bytes, final: bool) -> None:
    out.write(1 if final else 0, 1)
    out.write(0, 2)
    out.pad_to_byte()
    out.write(len(data), 16)
    out.write(~len(data) & 0xFFFF, 16)
    out.write_bytes(data)
