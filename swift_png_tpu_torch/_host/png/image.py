"""The pre-IDAT part of a PNG (a copy of ``write_pre_idat`` from
``swift_png_tpu/png/image.py``), written by the batched encoder."""

from __future__ import annotations

from . import chunk as chunks
from . import parsing
from .chunk import ByteDestination
from .format import COMMON, IOS, Layout
from .metadata import Metadata


def write_pre_idat(stream: ByteDestination, size, layout: Layout,
                   metadata: Metadata) -> str:
    """Signature + every pre-IDAT chunk in the reference's exact emission
    order (``PNG.Image.compress``, ``PNG.Image.swift:589-656``): CgBI for
    bgr8/bgra8, IHDR, cHRM, gAMA, sRGB, iCCP, sBIT, PLTE, bKGD, tRNS, hIST,
    pHYs, tIME, every text as iTXt, sPLT and the application chunks.
    Returns the stream standard (``COMMON``/``IOS``)."""
    stream.signature()
    fmt = layout.format
    if fmt.kind == "bgr8":
        cgbi, standard = bytes([48, 0, 32, 6]), IOS
    elif fmt.kind == "bgra8":
        cgbi, standard = bytes([48, 0, 32, 2]), IOS
    else:
        cgbi, standard = None, COMMON
    header = parsing.Header(size, fmt.pixel, layout.interlaced)
    if cgbi is not None:
        stream.format(chunks.CgBI, cgbi)
    stream.format(chunks.IHDR, header.serialized)
    md = metadata
    if md.chromaticity is not None:
        stream.format(chunks.cHRM, md.chromaticity.serialized)
    if md.gamma is not None:
        stream.format(chunks.gAMA, md.gamma.serialized)
    if md.color_rendering is not None:
        stream.format(chunks.sRGB, md.color_rendering.serialized)
    if md.color_profile is not None:
        stream.format(chunks.iCCP, md.color_profile.serialized)
    if md.significant_bits is not None:
        stream.format(chunks.sBIT, md.significant_bits.serialized)
    if layout.palette is not None:
        stream.format(chunks.PLTE, layout.palette.serialized)
    if layout.background is not None:
        stream.format(chunks.bKGD, layout.background.serialized)
    if layout.transparency is not None:
        stream.format(chunks.tRNS, layout.transparency.serialized)
    if md.histogram is not None:
        stream.format(chunks.hIST, md.histogram.serialized)
    if md.physical_dimensions is not None:
        stream.format(chunks.pHYs, md.physical_dimensions.serialized)
    if md.time is not None:
        stream.format(chunks.tIME, md.time.serialized)
    for text in md.text:
        stream.format(chunks.iTXt, text.serialized)
    for spal in md.suggested_palettes:
        stream.format(chunks.sPLT, spal.serialized)
    for (type_, data) in md.application:
        stream.format(type_, data)
    return standard
