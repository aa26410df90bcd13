"""Adler-32 and CRC-32 on the host, with their combine operators (copies
of ``adler32``, ``adler32_combine``, ``crc32`` and ``crc32_combine`` from
``swift_png_tpu/lz77/checksums.py``): the host ``Inflator`` folds both
over its output, the fused inflate's gzip form checks the CRC-32, and the
scale-out layer assembles a stream's checksum from its shards' (Adler-32
is affine in the data, CRC-32 linear over GF(2))."""

from __future__ import annotations

import numpy as np

ADLER_MOD = 65521
CRC32_POLY = 0xEDB88320  # reflected polynomial


def adler32(data: bytes | bytearray | memoryview | np.ndarray,
            state: int = 1) -> int:
    """Adler-32 of ``data``, continuing from ``state`` (fresh = 1).

    Vectorized: s1' = s1 + Σd_i; s2' = s2 + n·s1 + Σ (n-i)·d_i, in chunks
    that keep the weighted sums inside int64.
    """
    if isinstance(data, np.ndarray):
        arr = data.astype(np.int64, copy=False).ravel()
    else:
        arr = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.int64)
    s1 = state & 0xFFFF
    s2 = (state >> 16) & 0xFFFF
    CHUNK = 1 << 26
    for off in range(0, arr.size, CHUNK):
        chunk = arr[off: off + CHUNK]
        n = chunk.size
        total = int(chunk.sum())
        weighted = int((chunk * np.arange(n, 0, -1, dtype=np.int64)).sum())
        s2 = (s2 + n * s1 + weighted) % ADLER_MOD
        s1 = (s1 + total) % ADLER_MOD
    return (s2 << 16) | s1


def adler32_combine(a: int, b: int, len_b: int) -> int:
    """Adler-32 of ``A||B`` from ``adler32(A)``, ``adler32(B)`` and
    ``len(B)``."""
    a1, a2 = a & 0xFFFF, (a >> 16) & 0xFFFF
    b1, b2 = b & 0xFFFF, (b >> 16) & 0xFFFF
    rem = len_b % ADLER_MOD
    s1 = (a1 + b1 - 1) % ADLER_MOD
    s2 = (a2 + b2 + rem * a1 - rem) % ADLER_MOD
    return (s2 << 16) | s1


def _build_crc_tables(slices: int = 8) -> np.ndarray:
    tables = np.zeros((slices, 256), dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (CRC32_POLY if crc & 1 else 0)
        tables[0, i] = crc
    for s in range(1, slices):
        prev = tables[s - 1]
        tables[s] = tables[0][prev & 0xFF] ^ (prev >> 8)
    return tables


_CRC_TABLES = _build_crc_tables()
_CRC_TABLE = _CRC_TABLES[0]


def crc32(data: bytes | bytearray | memoryview | np.ndarray,
          state: int = 0) -> int:
    """CRC-32 (IEEE, reflected) of ``data``, continuing from ``state``:
    slicing-by-8, one host step per 8-byte group."""
    buf = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    crc = state ^ 0xFFFFFFFF
    n8 = len(buf) // 8
    t = _CRC_TABLES
    view = np.frombuffer(buf[: 8 * n8], dtype="<u8")
    t7, t6, t5, t4 = t[7], t[6], t[5], t[4]
    t3, t2, t1, t0 = t[3], t[2], t[1], t[0]
    for word in view:
        w = int(word) ^ crc
        crc = int(t7[w & 0xFF] ^ t6[(w >> 8) & 0xFF] ^ t5[(w >> 16) & 0xFF]
                  ^ t4[(w >> 24) & 0xFF] ^ t3[(w >> 32) & 0xFF]
                  ^ t2[(w >> 40) & 0xFF] ^ t1[(w >> 48) & 0xFF]
                  ^ t0[(w >> 56) & 0xFF])
    for byte in buf[8 * n8:]:
        crc = int(_CRC_TABLE[(crc ^ byte) & 0xFF]) ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _gf2_matrix_times(mat: list[int], vec: int) -> int:
    total = 0
    i = 0
    while vec:
        if vec & 1:
            total ^= mat[i]
        vec >>= 1
        i += 1
    return total


def _gf2_matrix_square(mat: list[int]) -> list[int]:
    return [_gf2_matrix_times(mat, mat[i]) for i in range(32)]


def crc32_combine(a: int, b: int, len_b: int) -> int:
    """CRC-32 of ``A||B`` from ``crc32(A)``, ``crc32(B)`` and ``len(B)``:
    the shift by x^(8·len_b) applied to ``a`` by repeated squaring of the
    one-zero-bit operator over GF(2)."""
    if len_b == 0:
        return a
    crc = a
    op = [CRC32_POLY] + [1 << (i - 1) for i in range(1, 32)]
    n = len_b * 8
    while n:
        if n & 1:
            crc = _gf2_matrix_times(op, crc)
        n >>= 1
        if n:
            op = _gf2_matrix_square(op)
    return crc ^ b
