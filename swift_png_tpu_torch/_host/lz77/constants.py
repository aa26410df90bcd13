"""RFC 1951 constant tables the index walker reads (copy of
``swift_png_tpu/lz77/constants.py``)."""

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
