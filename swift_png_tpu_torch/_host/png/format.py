"""The two standards and the 15 standard pixel formats (copies of
``COMMON``, ``IOS``, ``Pixel`` and ``recognize_pixel`` from
``swift_png_tpu/png/format.py``)."""

from __future__ import annotations

from dataclasses import dataclass

# standards: an iOS (CgBI) file carries the CgBI chunk before IHDR
COMMON = "common"
IOS = "ios"


@dataclass(frozen=True)
class Pixel:
    """One of the 15 standard pixel formats."""

    name: str
    depth: int
    channels: int
    color_type: int

    @property
    def volume(self) -> int:
        """Bits per pixel."""
        return self.depth * self.channels

    @property
    def code(self) -> tuple[int, int]:
        """(depth, color-type) IHDR code."""
        return (self.depth, self.color_type)

    @property
    def is_indexed(self) -> bool:
        return self.color_type == 3


_PIXELS = {
    p.code: p
    for p in (Pixel("v1", 1, 1, 0), Pixel("v2", 2, 1, 0),
              Pixel("v4", 4, 1, 0), Pixel("v8", 8, 1, 0),
              Pixel("v16", 16, 1, 0), Pixel("rgb8", 8, 3, 2),
              Pixel("rgb16", 16, 3, 2), Pixel("indexed1", 1, 1, 3),
              Pixel("indexed2", 2, 1, 3), Pixel("indexed4", 4, 1, 3),
              Pixel("indexed8", 8, 1, 3), Pixel("va8", 8, 2, 4),
              Pixel("va16", 16, 2, 4), Pixel("rgba8", 8, 4, 6),
              Pixel("rgba16", 16, 4, 6))
}


def recognize_pixel(code: tuple[int, int]) -> Pixel | None:
    """IHDR (depth, color) code → pixel format."""
    return _PIXELS.get(code)
