"""The pre-IDAT part of a PNG the batched encoder writes (the IHDR-only
case of ``write_pre_idat`` in ``swift_png_tpu/png/image.py``: no CgBI, no
palette, no ancillary chunks)."""

from __future__ import annotations

from . import chunk as chunks
from .chunk import ByteDestination
from .format import Pixel
from .parsing import Header


def write_pre_idat(stream: ByteDestination, size: tuple[int, int],
                   pixel: Pixel, interlaced: bool = False) -> None:
    """Signature + IHDR."""
    stream.signature()
    stream.format(chunks.IHDR, Header(size, pixel, interlaced).serialized)
