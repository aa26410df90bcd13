"""Basic encoding (``Snippets/PNG/BasicEncoding.swift`` analog):
pack pixel arrays into images and write PNGs at several formats/levels.
"""

import sys

import numpy as np

from swift_png_tpu_torch import png
from swift_png_tpu_torch.png.format import Format, Layout


def main(out_prefix: str = "/tmp/spt_basic") -> None:
    H, W = 120, 160
    y, x = np.mgrid[0:H, 0:W]
    rgba = np.stack([
        (x * 255 // W), (y * 255 // H),
        ((x + y) * 255 // (W + H)), np.full_like(x, 255),
    ], axis=-1).astype(np.uint8)

    # rgb8 at a fast and a max-ratio level
    img = png.Image.pack(rgba, Layout(Format("rgb8", ()), False))
    for level in (4, 13):
        path = f"{out_prefix}-rgb8-l{level}.png"
        img.compress_path(path, level=level)
        print(path, "bytes:", len(open(path, "rb").read()))

    # 16-bit grayscale from a float field
    v16 = ((np.sin(x / 11.0) * np.cos(y / 7.0) * 0.5 + 0.5)
           * 65535).astype(np.uint16)
    g16 = np.stack([v16, v16, v16, np.full_like(v16, 65535)], axis=-1)
    img16 = png.Image.pack(g16, Layout(Format("v16", ()), False))
    img16.compress_path(f"{out_prefix}-v16.png", level=9)

    # interlaced (Adam7) variant of the same image
    imgi = png.Image.pack(rgba, Layout(Format("rgba8", ()), True))
    imgi.compress_path(f"{out_prefix}-rgba8-interlaced.png", level=6)

    # everything round-trips bit-exact
    for suffix in ("-rgb8-l4.png", "-v16.png", "-rgba8-interlaced.png"):
        back = png.Image.decompress_path(out_prefix + suffix)
        print(suffix, back.layout.format.kind, back.size)


if __name__ == "__main__":
    main(*sys.argv[1:])
