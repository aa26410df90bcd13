"""Streaming/online decoding with progressive overdraw
(``Snippets/PNG/OnlineDecoding.swift`` analog): lex chunks yourself, feed
partial IDAT data, and render intermediate states."""

import sys

from swift_png_tpu_torch.png import chunk as chunks
from swift_png_tpu_torch.png import parsing
from swift_png_tpu_torch.png.chunk import ByteSource
from swift_png_tpu_torch.png.context import Context
from swift_png_tpu_torch.png.format import COMMON
from swift_png_tpu_torch.png.metadata import Metadata


def main(path: str) -> None:
    src = ByteSource(open(path, "rb").read())
    src.signature()
    header = palette = None
    metadata = Metadata()
    state = {"background": None, "transparency": None}
    ctx = None
    while True:
        type_, payload = src.chunk()
        if type_ == chunks.IHDR:
            header = parsing.Header.parse(payload, COMMON)
        elif type_ == chunks.PLTE:
            palette = parsing.Palette.parse(payload, header.pixel)
        elif type_ == chunks.IDAT:
            if ctx is None:
                ctx = Context(COMMON, header, palette, state["background"],
                              state["transparency"], metadata)
            # trickle in small pieces; overdraw brush-fills missing passes
            for i in range(0, len(payload), 512):
                ctx.push_data(payload[i:i + 512], overdraw=True)
                print("progressive snapshot:",
                      ctx.image.unpack_rgba8().mean(axis=(0, 1)))
        elif type_ == chunks.IEND:
            ctx.push_ancillary(type_, payload)
            break
        elif ctx is not None:
            ctx.push_ancillary(type_, payload)
        else:
            metadata.push_ancillary(type_, payload, header.pixel, palette,
                                    state)
    print("final:", ctx.image.unpack_rgba8().shape)


if __name__ == "__main__":
    main(sys.argv[1])
