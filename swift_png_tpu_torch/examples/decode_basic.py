"""Basic decoding (``Snippets/PNG/DecodeBasic.swift`` analog):
decode a PNG, inspect it, and extract pixels in several representations."""

import sys

from swift_png_tpu_torch import png
from swift_png_tpu_torch.inspection import describe_image
from swift_png_tpu_torch.models import RGBA, V, VA


def main(path: str) -> None:
    image = png.Image.decompress_path(path)
    print(describe_image(image))

    rgba8 = image.unpack_rgba8()          # (H, W, 4) uint8
    rgba16 = image.unpack(RGBA.of16)      # (H, W, 4) uint16
    va = image.unpack(VA.of8)             # (H, W, 2) value-alpha
    gray = image.unpack(V.of8)            # (H, W) luminance-ish value
    print("shapes:", rgba8.shape, rgba16.shape, va.shape, gray.shape)


if __name__ == "__main__":
    main(sys.argv[1])
