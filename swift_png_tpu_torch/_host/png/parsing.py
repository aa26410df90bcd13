"""IHDR, PLTE and tRNS chunk models (copies of ``Header``, ``Palette`` and
``Transparency`` from ``swift_png_tpu/png/parsing.py``)."""

from __future__ import annotations

from dataclasses import dataclass

from .errors import ParsingError
from .format import COMMON, IOS, Pixel, recognize_pixel


def _u16(data: bytes, at: int) -> int:
    return int.from_bytes(data[at: at + 2], "big")


def _u32(data: bytes, at: int) -> int:
    return int.from_bytes(data[at: at + 4], "big")


@dataclass(frozen=True)
class Header:
    """IHDR."""

    size: tuple[int, int]
    pixel: Pixel
    interlaced: bool

    @classmethod
    def parse(cls, data: bytes, standard: str = COMMON) -> "Header":
        """IHDR under ``standard``: an iOS (CgBI) header allows only rgb8
        and rgba8."""
        if len(data) != 13:
            raise ParsingError.invalidHeaderChunkLength(length=len(data))
        pixel = recognize_pixel((data[8], data[9]))
        if pixel is None:
            raise ParsingError.invalidHeaderPixelFormatCode(
                code=(data[8], data[9]))
        if standard == IOS and pixel.name not in ("rgb8", "rgba8"):
            raise ParsingError.invalidHeaderPixelFormat(
                pixel=pixel.name, standard=standard)
        if data[10] != 0:
            raise ParsingError.invalidHeaderCompressionMethodCode(
                code=data[10])
        if data[11] != 0:
            raise ParsingError.invalidHeaderFilterCode(code=data[11])
        if data[12] not in (0, 1):
            raise ParsingError.invalidHeaderInterlacingCode(code=data[12])
        size = (_u32(data, 0), _u32(data, 4))
        if (size[0] <= 0 or size[1] <= 0 or size[0] >= 1 << 31
                or size[1] >= 1 << 31):
            raise ParsingError.invalidHeaderSize(size=size)
        return cls(size, pixel, data[12] == 1)

    @property
    def serialized(self) -> bytes:
        d, c = self.pixel.code
        return (self.size[0].to_bytes(4, "big")
                + self.size[1].to_bytes(4, "big")
                + bytes([d, c, 0, 0, 1 if self.interlaced else 0]))


@dataclass(frozen=True)
class Palette:
    """PLTE."""

    entries: list  # [(r, g, b)]

    @classmethod
    def parse(cls, data: bytes, pixel: Pixel) -> "Palette":
        # palette is meaningless for grayscale(-alpha) formats
        if pixel.color_type in (0, 4):
            raise ParsingError.unexpectedPalette(pixel=pixel.name)
        if len(data) % 3:
            raise ParsingError.invalidPaletteChunkLength(length=len(data))
        count = len(data) // 3
        max_count = 1 << min(pixel.depth, 8)
        if not 1 <= count <= max_count:
            raise ParsingError.invalidPaletteCount(count=count, max=max_count)
        return cls([tuple(data[3 * i: 3 * i + 3]) for i in range(count)])


@dataclass(frozen=True)
class Transparency:
    """tRNS: ``case`` ∈ {"v", "rgb", "palette"}; ``value`` is a sample, an
    RGB triple, or a list of alphas."""

    case: str
    value: object

    @classmethod
    def parse(cls, data: bytes, pixel: Pixel,
              palette: "Palette | None") -> "Transparency":
        ctype = pixel.color_type
        max_sample = (1 << pixel.depth) - 1
        if ctype == 0:
            if len(data) != 2:
                raise ParsingError.invalidTransparencyChunkLength(
                    length=len(data), expected=2)
            v = _u16(data, 0)
            if v > max_sample:
                raise ParsingError.invalidTransparencySample(
                    sample=v, max=max_sample)
            return cls("v", v)
        if ctype == 2:
            if len(data) != 6:
                raise ParsingError.invalidTransparencyChunkLength(
                    length=len(data), expected=6)
            rgb = (_u16(data, 0), _u16(data, 2), _u16(data, 4))
            if max(rgb) > max_sample:
                raise ParsingError.invalidTransparencySample(
                    sample=max(rgb), max=max_sample)
            return cls("rgb", rgb)
        if ctype == 3:
            limit = len(palette.entries) if palette else 0
            if len(data) > limit:
                raise ParsingError.invalidTransparencyCount(
                    count=len(data), max=limit)
            return cls("palette", list(data))
        raise ParsingError.unexpectedTransparency(pixel=pixel.name)
