"""Standalone LZ77 product (``Snippets/LZ77/*.swift`` analog): a tiny
gzip-compatible compressor/decompressor over the native engine, with the
Python tier as fallback."""

import sys

from swift_png_tpu_torch import native
from swift_png_tpu_torch.lz77 import gzip as g


def main(mode: str, src: str, dst: str, level: int = 9) -> None:
    data = open(src, "rb").read()
    if mode == "c":
        blob = (native.deflate(data, level, "gzip") if native.available()
                else g.archive(data, level=level))
    else:
        blob = g.extract(data)
    open(dst, "wb").write(blob)
    print(f"{src} ({len(data)} B) -> {dst} ({len(blob)} B)")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3],
         int(sys.argv[4]) if len(sys.argv) > 4 else 9)
