"""Chunk models: parse and serialize every chunk the reference models
(copies of ``Header`` (IHDR), ``Palette`` (PLTE), ``Transparency``
(tRNS), ``Background`` (bKGD), ``Histogram`` (hIST), ``Gamma`` (gAMA),
``Chromaticity`` (cHRM), ``ColorRendering`` (sRGB), ``ColorProfile``
(iCCP), ``SignificantBits`` (sBIT), ``PhysicalDimensions`` (pHYs),
``TimeModified`` (tIME), ``SuggestedPalette`` (sPLT) and ``Text``
(tEXt/zTXt/iTXt) from ``swift_png_tpu/png/parsing.py``).

The compressed ``iCCP`` profile and ``iTXt``/``zTXt`` text inflate with
the host ``Inflator`` and deflate with the host ``Deflator`` at level 13.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..lz77.deflate import Deflator
from ..lz77.inflate import Inflator
from .errors import ParsingError
from .format import COMMON, IOS, Pixel, recognize_pixel


def _u16(data: bytes, at: int) -> int:
    return int.from_bytes(data[at : at + 2], "big")


def _u32(data: bytes, at: int) -> int:
    return int.from_bytes(data[at : at + 4], "big")


@dataclass(frozen=True)
class Header:
    """IHDR (``Parsing/PNG.Header.swift:73-146``)."""

    size: tuple[int, int]
    pixel: Pixel
    interlaced: bool

    @classmethod
    def parse(cls, data: bytes, standard: str = COMMON) -> "Header":
        if len(data) != 13:
            raise ParsingError.invalidHeaderChunkLength(length=len(data))
        pixel = recognize_pixel((data[8], data[9]))
        if pixel is None:
            raise ParsingError.invalidHeaderPixelFormatCode(
                code=(data[8], data[9]))
        # iphone-optimized PNG can only be rgb8 or rgba8
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
        return (
            self.size[0].to_bytes(4, "big")
            + self.size[1].to_bytes(4, "big")
            + bytes([d, c, 0, 0, 1 if self.interlaced else 0])
        )


@dataclass(frozen=True)
class Palette:
    """PLTE (``Parsing/PNG.Palette.swift:54-90``)."""

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
        entries = [tuple(data[3 * i : 3 * i + 3]) for i in range(count)]
        return cls(entries)

    @property
    def serialized(self) -> bytes:
        return b"".join(bytes(e) for e in self.entries)


@dataclass(frozen=True)
class Transparency:
    """tRNS (``Parsing/PNG.Transparency.swift:126-180``).

    ``case`` ∈ {"v", "rgb", "palette"}; ``value`` is a sample, an RGB triple,
    or a list of alphas.
    """

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

    @property
    def serialized(self) -> bytes:
        if self.case == "v":
            return self.value.to_bytes(2, "big")
        if self.case == "rgb":
            r, g, b = self.value
            return (r.to_bytes(2, "big") + g.to_bytes(2, "big")
                    + b.to_bytes(2, "big"))
        return bytes(self.value)


@dataclass(frozen=True)
class Background:
    """bKGD (``Parsing/PNG.Background.swift:119-175``)."""

    case: str  # "v" | "rgb" | "palette"
    value: object

    @classmethod
    def parse(cls, data: bytes, pixel: Pixel,
              palette: "Palette | None") -> "Background":
        ctype = pixel.color_type
        max_sample = (1 << pixel.depth) - 1
        if ctype in (0, 4):
            if len(data) != 2:
                raise ParsingError.invalidBackgroundChunkLength(
                    length=len(data), expected=2)
            v = _u16(data, 0)
            if v > max_sample:
                raise ParsingError.invalidBackgroundSample(
                    sample=v, max=max_sample)
            return cls("v", v)
        if ctype in (2, 6):
            if len(data) != 6:
                raise ParsingError.invalidBackgroundChunkLength(
                    length=len(data), expected=6)
            rgb = (_u16(data, 0), _u16(data, 2), _u16(data, 4))
            if max(rgb) > max_sample:
                raise ParsingError.invalidBackgroundSample(
                    sample=max(rgb), max=max_sample)
            return cls("rgb", rgb)
        # indexed
        if len(data) != 1:
            raise ParsingError.invalidBackgroundChunkLength(
                length=len(data), expected=1)
        index = data[0]
        limit = len(palette.entries) if palette else 0
        if index >= limit:
            raise ParsingError.invalidBackgroundIndex(
                index=index, max=limit - 1)
        return cls("palette", index)

    @property
    def serialized(self) -> bytes:
        if self.case == "v":
            return self.value.to_bytes(2, "big")
        if self.case == "rgb":
            r, g, b = self.value
            return (r.to_bytes(2, "big") + g.to_bytes(2, "big")
                    + b.to_bytes(2, "big"))
        return bytes([self.value])


@dataclass(frozen=True)
class Histogram:
    """hIST (``Parsing/PNG.Histogram.swift``)."""

    frequencies: list

    @classmethod
    def parse(cls, data: bytes, palette: Palette) -> "Histogram":
        if len(data) != 2 * len(palette.entries):
            raise ParsingError.invalidHistogramChunkLength(
                length=len(data), expected=2 * len(palette.entries))
        return cls([_u16(data, 2 * i) for i in range(len(data) // 2)])

    @property
    def serialized(self) -> bytes:
        return b"".join(v.to_bytes(2, "big") for v in self.frequencies)


@dataclass(frozen=True)
class Gamma:
    """gAMA — value in hundred-thousandths (``Percentmille``)."""

    value: int  # gamma × 100_000

    @classmethod
    def parse(cls, data: bytes) -> "Gamma":
        if len(data) != 4:
            raise ParsingError.invalidGammaChunkLength(length=len(data))
        return cls(_u32(data, 0))

    @property
    def serialized(self) -> bytes:
        return self.value.to_bytes(4, "big")


@dataclass(frozen=True)
class Chromaticity:
    """cHRM — 8 fixed-point fields, each × 100_000."""

    w: tuple[int, int]
    r: tuple[int, int]
    g: tuple[int, int]
    b: tuple[int, int]

    @classmethod
    def parse(cls, data: bytes) -> "Chromaticity":
        if len(data) != 32:
            raise ParsingError.invalidChromaticityChunkLength(length=len(data))
        v = [_u32(data, 4 * i) for i in range(8)]
        return cls((v[0], v[1]), (v[2], v[3]), (v[4], v[5]), (v[6], v[7]))

    @property
    def serialized(self) -> bytes:
        vals = [*self.w, *self.r, *self.g, *self.b]
        return b"".join(v.to_bytes(4, "big") for v in vals)


@dataclass(frozen=True)
class ColorRendering:
    """sRGB rendering intent."""

    intent: int  # 0 perceptual, 1 relative, 2 saturation, 3 absolute

    @classmethod
    def parse(cls, data: bytes) -> "ColorRendering":
        if len(data) != 1:
            raise ParsingError.invalidColorRenderingChunkLength(
                length=len(data))
        if data[0] > 3:
            raise ParsingError.invalidColorRenderingCode(code=data[0])
        return cls(data[0])

    @property
    def serialized(self) -> bytes:
        return bytes([self.intent])


def _parse_keyword(data: bytes, start: int = 0,
                   limit: int = 80) -> tuple[str, int]:
    """Latin-1 keyword up to a NUL; returns (keyword, index past NUL)."""
    idx = data.find(b"\x00", start, start + limit + 1)
    if idx < 0:
        raise ParsingError.invalidTextEnglishKeyword(
            reason="unterminated keyword")
    keyword = data[start:idx].decode("latin-1")
    if not keyword or len(keyword) > 79:
        raise ParsingError.invalidTextEnglishKeyword(keyword=keyword)
    if keyword != keyword.strip() or "  " in keyword:
        raise ParsingError.invalidTextEnglishKeyword(keyword=keyword)
    if any(not (32 <= ord(c) <= 126 or 161 <= ord(c) <= 255) for c in keyword):
        raise ParsingError.invalidTextEnglishKeyword(keyword=keyword)
    return keyword, idx + 1


@dataclass(frozen=True)
class ColorProfile:
    """iCCP — profile name + zlib-compressed ICC profile.

    The profile inflates with the host ``Inflator`` and re-deflates at
    level 13 when serialized, as the reference does
    (``Parsing/PNG.ColorProfile.swift:77,97``).
    """

    name: str
    profile: bytes

    @classmethod
    def parse(cls, data: bytes) -> "ColorProfile":
        try:
            name, k = _parse_keyword(data)
        except ParsingError:
            raise ParsingError.invalidColorProfileName() from None
        if len(data) < k + 1:
            raise ParsingError.invalidColorProfileChunkLength(
                length=len(data), min=k + 1)
        if data[k] != 0:
            raise ParsingError.invalidColorProfileCompressionMethodCode(
                code=data[k])
        inflator = Inflator("zlib")
        try:
            inflator.push(data[k + 1 :])
        except Exception:
            err = ParsingError.incompleteColorProfileCompressedDatastream()
            raise err from None
        if not inflator.terminal:
            raise ParsingError.incompleteColorProfileCompressedDatastream()
        return cls(name, inflator.pull())

    @property
    def serialized(self) -> bytes:
        deflator = Deflator("zlib", 13)
        deflator.push(self.profile, last=True)
        return self.name.encode("latin-1") + b"\x00\x00" + deflator.pull()


@dataclass(frozen=True)
class SignificantBits:
    """sBIT — per-channel precision
    (``Parsing/PNG.SignificantBits.swift``)."""

    case: str  # "v" | "va" | "rgb" | "rgba"
    value: tuple

    _EXPECTED = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}

    @classmethod
    def parse(cls, data: bytes, pixel: Pixel) -> "SignificantBits":
        ctype = pixel.color_type
        expected = cls._EXPECTED[ctype]
        if len(data) != expected:
            raise ParsingError.invalidSignificantBitsChunkLength(
                length=len(data), expected=expected)
        max_depth = 8 if ctype == 3 else pixel.depth
        for v in data:
            if not 1 <= v <= max_depth:
                raise ParsingError.invalidSignificantBitsPrecision(
                    precision=v, max=max_depth)
        case = {0: "v", 2: "rgb", 3: "rgb", 4: "va", 6: "rgba"}[ctype]
        return cls(case, tuple(data))

    @property
    def serialized(self) -> bytes:
        return bytes(self.value)


@dataclass(frozen=True)
class PhysicalDimensions:
    """pHYs — pixel density."""

    density: tuple[int, int]
    unit: str  # "meter" | "none"

    @classmethod
    def parse(cls, data: bytes) -> "PhysicalDimensions":
        if len(data) != 9:
            raise ParsingError.invalidPhysicalDimensionsChunkLength(
                length=len(data))
        if data[8] > 1:
            raise ParsingError.invalidPhysicalDimensionsDensityUnitCode(
                code=data[8])
        return cls((_u32(data, 0), _u32(data, 4)),
                   "meter" if data[8] else "none")

    @property
    def serialized(self) -> bytes:
        return (
            self.density[0].to_bytes(4, "big")
            + self.density[1].to_bytes(4, "big")
            + bytes([1 if self.unit == "meter" else 0])
        )


@dataclass(frozen=True)
class TimeModified:
    """tIME (``Parsing/PNG.TimeModified.swift``)."""

    year: int
    month: int
    day: int
    hour: int
    minute: int
    second: int

    @classmethod
    def parse(cls, data: bytes) -> "TimeModified":
        if len(data) != 7:
            raise ParsingError.invalidTimeModifiedChunkLength(length=len(data))
        year, month, day = _u16(data, 0), data[2], data[3]
        hour, minute, second = data[4], data[5], data[6]
        if not (1 <= month <= 12 and 1 <= day <= 31 and hour < 24
                and minute < 60 and second < 61):
            raise ParsingError.invalidTimeModifiedTime(
                year=year, month=month, day=day, hour=hour, minute=minute,
                second=second)
        return cls(year, month, day, hour, minute, second)

    @property
    def serialized(self) -> bytes:
        return self.year.to_bytes(2, "big") + bytes(
            [self.month, self.day, self.hour, self.minute, self.second])


@dataclass(frozen=True)
class SuggestedPalette:
    """sPLT — 8- or 16-bit suggested palette entries with frequencies."""

    name: str
    depth: int
    entries: list  # [((r, g, b, a), frequency)]

    @classmethod
    def parse(cls, data: bytes) -> "SuggestedPalette":
        try:
            name, k = _parse_keyword(data)
        except ParsingError:
            raise ParsingError.invalidSuggestedPaletteName() from None
        if len(data) < k + 1:
            raise ParsingError.invalidSuggestedPaletteChunkLength(
                length=len(data), min=k + 1)
        depth = data[k]
        body = data[k + 1 :]
        if depth == 8:
            if len(body) % 6:
                raise ParsingError.invalidSuggestedPaletteDataLength(
                    length=len(body), stride=6)
            entries = [
                ((body[i], body[i + 1], body[i + 2], body[i + 3]),
                 _u16(body, i + 4))
                for i in range(0, len(body), 6)
            ]
        elif depth == 16:
            if len(body) % 10:
                raise ParsingError.invalidSuggestedPaletteDataLength(
                    length=len(body), stride=10)
            entries = [
                (
                    (_u16(body, i), _u16(body, i + 2), _u16(body, i + 4),
                     _u16(body, i + 6)),
                    _u16(body, i + 8),
                )
                for i in range(0, len(body), 10)
            ]
        else:
            raise ParsingError.invalidSuggestedPaletteDepthCode(code=depth)
        if any(entries[i][1] < entries[i + 1][1]
               for i in range(len(entries) - 1)):
            raise ParsingError.invalidSuggestedPaletteFrequency()
        return cls(name, depth, entries)

    @property
    def serialized(self) -> bytes:
        out = bytearray(self.name.encode("latin-1") + b"\x00"
                        + bytes([self.depth]))
        for (r, g, b, a), f in self.entries:
            if self.depth == 8:
                out += bytes([r, g, b, a]) + f.to_bytes(2, "big")
            else:
                for v in (r, g, b, a):
                    out += v.to_bytes(2, "big")
                out += f.to_bytes(2, "big")
        return bytes(out)


@dataclass(frozen=True)
class Text:
    """tEXt / zTXt / iTXt (``Parsing/PNG.Text.swift``).

    ``keyword`` = (english, localized); zlib text compression handled via the
    LZ77 engine at level 13 exactly like the reference (``PNG.Text.swift:160,
    183,336``).
    """

    compressed: bool
    keyword: tuple[str, str]
    language: str
    content: str

    @classmethod
    def parse(cls, data: bytes, unicode: bool = True) -> "Text":
        if unicode:
            # iTXt
            keyword, k = _parse_keyword(data)
            if len(data) < k + 2:
                raise ParsingError.invalidTextChunkLength(
                    length=len(data), min=k + 2)
            flag, method = data[k], data[k + 1]
            if flag not in (0, 1):
                raise ParsingError.invalidTextCompressionCode(code=flag)
            if flag == 1 and method != 0:
                raise ParsingError.invalidTextCompressionMethodCode(
                    code=method)
            # language tag
            lt = data.find(b"\x00", k + 2)
            if lt < 0:
                raise ParsingError.invalidTextLanguageTag(
                    reason="unterminated")
            language = data[k + 2 : lt].decode("ascii", "strict")
            if language and not all(
                part and len(part) <= 8 and part.isalnum() and part.isascii()
                for part in language.split("-")
            ):
                raise ParsingError.invalidTextLanguageTag(tag=language)
            lk = data.find(b"\x00", lt + 1)
            if lk < 0:
                raise ParsingError.invalidTextLocalizedKeyword()
            localized = data[lt + 1 : lk].decode("utf-8", "strict")
            body = data[lk + 1 :]
            if flag:
                content = cls._inflate(body).decode("utf-8", "replace")
            else:
                content = body.decode("utf-8", "replace")
            if localized == keyword:
                localized = ""
            return cls(bool(flag), (keyword, localized), language, content)
        # tEXt / zTXt: if the byte after the keyword NUL is also NUL, the
        # chunk is compressed (zTXt shape); otherwise it is raw latin-1
        # (``PNG.Text.swift:176-199``)
        keyword, k = _parse_keyword(data)
        if k < len(data) and data[k] == 0:
            content = cls._inflate(data[k + 1 :]).decode("latin-1")
            return cls(True, (keyword, ""), "en", content)
        return cls(False, (keyword, ""), "en", data[k:].decode("latin-1"))

    @staticmethod
    def _inflate(body: bytes) -> bytes:
        inflator = Inflator("zlib")
        try:
            inflator.push(body)
        except Exception:
            raise ParsingError.incompleteTextCompressedDatastream() from None
        if not inflator.terminal:
            raise ParsingError.incompleteTextCompressedDatastream()
        return inflator.pull()

    @property
    def serialized(self) -> bytes:
        """iTXt-shaped serialization (the reference always re-emits text as
        iTXt, ``PNG.Image.swift:641-643``)."""
        out = bytearray(self.keyword[0].encode("latin-1") + b"\x00")
        out += bytes([1 if self.compressed else 0, 0])
        out += self.language.encode("ascii") + b"\x00"
        out += self.keyword[1].encode("utf-8") + b"\x00"
        if self.compressed:
            deflator = Deflator("zlib", 13)
            deflator.push(self.content.encode("utf-8"), last=True)
            out += deflator.pull()
        else:
            out += self.content.encode("utf-8")
        return bytes(out)
