"""Image metadata (``Snippets/PNG/ImageMetadata.swift`` analog):
read, inspect, edit, and re-emit ancillary chunks.
"""

import sys

from swift_png_tpu_torch import png
from swift_png_tpu_torch.inspection import describe_metadata
from swift_png_tpu_torch.png import parsing


def main(path: str, out: str = "/tmp/spt_metadata.png") -> None:
    image = png.Image.decompress_path(path)
    print(describe_metadata(image.metadata))

    # edit: stamp a modification time and a comment, set pixel density
    md = image.metadata
    md.time = parsing.TimeModified(2026, 8, 20, 12, 0, 0)
    md.physical_dimensions = parsing.PhysicalDimensions((2835, 2835),
                                                        "meter")
    md.text.append(parsing.Text(False, ("Comment", ""), "",
                                "edited by swift_png_tpu"))
    image.compress_path(out, level=9)

    back = png.Image.decompress_path(out)
    assert back.metadata.time is not None
    assert any(t.content == "edited by swift_png_tpu"
               for t in back.metadata.text)
    print("re-read:", describe_metadata(back.metadata))


if __name__ == "__main__":
    main(*sys.argv[1:])
