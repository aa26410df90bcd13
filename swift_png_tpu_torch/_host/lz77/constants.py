"""RFC 1951 constant tables the inflate engines, the index walker and the
encoder read (copy of ``swift_png_tpu/lz77/constants.py``)."""

from __future__ import annotations

import numpy as np

# run-length decades: symbol 257 + i → (extra bits, base length)
RUN_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
     5, 5, 5, 5, 0],
    dtype=np.int32,
)
RUN_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
     67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32,
)

# distance decades: symbol i → (extra bits, base distance)
DISTANCE_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
     11, 11, 12, 12, 13, 13],
    dtype=np.int32,
)
DISTANCE_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513,
     769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577],
    dtype=np.int32,
)

# order in which code-length code lengths are transmitted (RFC 1951 §3.2.7)
CODELENGTH_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2,
                    14, 1, 15)

MAX_RUN = 258
MAX_DISTANCE = 32768

# fixed Huffman code lengths (RFC 1951 §3.2.6)
FIXED_LITERAL_LENGTHS = np.array([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8,
                                 dtype=np.int64)
FIXED_DISTANCE_LENGTHS = np.array([5] * 32, dtype=np.int64)


def _run_decades() -> np.ndarray:
    """Inverse map run length (3…258) → decade index 0…28."""
    table = np.zeros(MAX_RUN + 1, dtype=np.int32)
    for decade in range(29):
        base = int(RUN_BASE[decade])
        span = 1 << int(RUN_EXTRA[decade])
        table[base: min(base + span, MAX_RUN + 1)] = decade
    table[MAX_RUN] = 28
    return table


def _distance_decades() -> np.ndarray:
    """Inverse map distance (1…32768) → decade index 0…29."""
    table = np.zeros(MAX_DISTANCE + 1, dtype=np.int32)
    for decade in range(30):
        base = int(DISTANCE_BASE[decade])
        span = 1 << int(DISTANCE_EXTRA[decade])
        table[base: min(base + span, MAX_DISTANCE + 1)] = decade
    return table


RUN_DECADE = _run_decades()
DISTANCE_DECADE = _distance_decades()
