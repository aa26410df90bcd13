"""iPhone-optimized PNGs (``Snippets/PNG/iPhoneOptimized.swift``
analog): decode a CgBI file (bgr byte order, missing zlib framing,
premultiplied alpha), straighten it, and re-encode both as standard PNG
and back as iPhone-optimized.
"""

import sys

from swift_png_tpu_torch import png
from swift_png_tpu_torch.png.format import Format, Layout


def main(path: str, out_prefix: str = "/tmp/spt_ios") -> None:
    image = png.Image.decompress_path(path)
    kind = image.layout.format.kind
    print(f"{path}: {kind} {image.size}")

    # unpack straightens the premultiplied CgBI samples
    # (`premultiplied(as:)` emulation lives in models/rgba.py)
    rgba = image.unpack_rgba8()

    std = png.Image.pack(rgba, Layout(Format("rgba8", ()), False))
    std.compress_path(f"{out_prefix}-standard.png", level=9)

    ios = png.Image.pack(rgba, Layout(Format("bgra8", ()), False))
    ios.compress_path(f"{out_prefix}-cgbi.png", level=13)
    back = png.Image.decompress_path(f"{out_prefix}-cgbi.png")
    print("re-read iphone-optimized:", back.layout.format.kind)


if __name__ == "__main__":
    main(*sys.argv[1:])
