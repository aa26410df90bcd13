"""Palette indexing (``Snippets/PNG/Indexing.swift`` analog): build an
indexed8 image with a custom gradient palette via an indexer, and read
the raw indices back with a deindexer.
"""

import sys

import numpy as np

from swift_png_tpu_torch import png
from swift_png_tpu_torch.models import V
from swift_png_tpu_torch.png.format import Format, Layout


def main(path: str, out: str = "/tmp/spt_indexed.png") -> None:
    # grayscale source → 256-entry two-color lerp palette
    image = png.Image.decompress_path(path)
    v = image.unpack(V.of8)
    a = np.array([69.0, 55.0, 66.0])
    b = np.array([255.0, 251.0, 237.0])
    t = np.linspace(0.0, 1.0, 256)[:, None]
    pal = tuple((int(r), int(g), int(bl), 255)
                for r, g, bl in (a * (1 - t) + b * t + 0.5).astype(int))

    # pack with a custom indexer: the gray sample IS the palette index
    # (indexer mirrors ``pack(_:as:indexer:)`` — palette → aggregates →
    # indices)
    fmt = Format("indexed8", pal)
    idx_img = png.Image.pack(
        np.stack([v, v, v, np.full_like(v, 255)], axis=-1),
        Layout(fmt, False),
        indexer=lambda palette: (lambda aggregates: aggregates[:, 0]))
    idx_img.compress_path(out, level=9)

    # deindexer route: read the raw indices back out
    back = png.Image.decompress_path(out)
    indices = back.unpack(V.of8,
                          deindexer=lambda palette: np.arange(
                              len(palette), dtype=np.uint8))
    assert np.array_equal(indices, v)
    print(f"wrote {out}; indices round-trip OK ({indices.shape})")


if __name__ == "__main__":
    main(*sys.argv[1:])
