"""Streaming decode of one image (a copy of ``Context`` from
``swift_png_tpu/png/context.py``; ``PNG.Context``,
``PNG.Context.swift:9-146``).

The context owns the image being decoded and its ``Decoder``:
``push_data`` takes IDAT bytes in pieces of any size (with ``overdraw``,
each decoded pixel also fills its Adam7 block, for progressive display);
``push_ancillary`` takes the chunks after the IDAT run and checks at IEND
that the image data was complete.
"""

from __future__ import annotations

from . import chunk as chunks
from . import parsing
from .decoder import Decoder
from .errors import DecodingError
from .image import Image
from .metadata import Metadata


class Context:
    def __init__(self, standard, header, palette, background, transparency,
                 metadata: Metadata):
        self.image = Image._create(
            standard, header, palette, background, transparency, metadata)
        if self.image is not None:
            self.decoder = Decoder(standard, self.image.layout.interlaced)

    def push_data(self, data: bytes, overdraw: bool = False) -> None:
        """(``PNG.Context.push(data:overdraw:)``)"""
        image = self.image

        if overdraw:
            def delegate(scanline, base, stride):
                image.assign(scanline, base, stride[0])
                sx = 0 if base[0] == 0 else 1
                sy = 0 if base[1] & 0b111 == 0 else 1
                image.overdraw(base, (stride[0] >> sx, stride[1] >> sy))
        else:
            def delegate(scanline, base, stride):
                image.assign(scanline, base, stride[0])

        self.decoder.push(data, image.size, image.layout.format.pixel,
                          delegate)

    def push_ancillary(self, type: str, data: bytes) -> None:
        """(``PNG.Context.push(ancillary:)``): tIME once, text, application
        chunks; any other chunk is unexpected after IDAT."""
        md = self.image.metadata
        if type == chunks.tIME:
            if md.time is not None:
                raise DecodingError.duplicate(type)
            md.time = parsing.TimeModified.parse(data)
        elif type == chunks.iTXt:
            md.text.append(parsing.Text.parse(data, unicode=True))
        elif type in (chunks.tEXt, chunks.zTXt):
            md.text.append(parsing.Text.parse(data, unicode=False))
        elif type in (chunks.CgBI, chunks.IHDR, chunks.PLTE, chunks.bKGD,
                      chunks.tRNS, chunks.hIST, chunks.cHRM, chunks.gAMA,
                      chunks.sRGB, chunks.iCCP, chunks.sBIT, chunks.pHYs,
                      chunks.sPLT, chunks.IDAT):
            raise DecodingError.unexpected(type, chunks.IDAT)
        elif type == chunks.IEND:
            if self.decoder.continue_:
                raise DecodingError.incomplete_compressed_datastream()
        else:
            md.application.append((type, bytes(data)))
