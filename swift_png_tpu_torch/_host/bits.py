"""Bit reversal (copy of ``swift_png_tpu/utils/bits.py::reverse_bits``)."""

from __future__ import annotations


def reverse_bits(value: int, width: int) -> int:
    """Reverse the low ``width`` bits of ``value``."""
    result = 0
    for _ in range(width):
        result = (result << 1) | (value & 1)
        value >>= 1
    return result
