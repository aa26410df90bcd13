"""The two standards, the 15 standard pixel formats, the 17 colour
formats and the image layout (copies of ``COMMON``, ``IOS``, ``Pixel``
with its 15 constants ``V1`` … ``RGBA16``, ``recognize_pixel``,
``Format``, ``Layout`` and ``recognize`` from
``swift_png_tpu/png/format.py``).  ``Layout`` rebuilds the PLTE, tRNS and
bKGD chunk models an encoder writes from its format; ``recognize`` builds
the format a decoder reads from those chunk models."""

from __future__ import annotations

from dataclasses import dataclass, field

from .errors import ParsingError

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


V1 = Pixel("v1", 1, 1, 0)
V2 = Pixel("v2", 2, 1, 0)
V4 = Pixel("v4", 4, 1, 0)
V8 = Pixel("v8", 8, 1, 0)
V16 = Pixel("v16", 16, 1, 0)
RGB8 = Pixel("rgb8", 8, 3, 2)
RGB16 = Pixel("rgb16", 16, 3, 2)
INDEXED1 = Pixel("indexed1", 1, 1, 3)
INDEXED2 = Pixel("indexed2", 2, 1, 3)
INDEXED4 = Pixel("indexed4", 4, 1, 3)
INDEXED8 = Pixel("indexed8", 8, 1, 3)
VA8 = Pixel("va8", 8, 2, 4)
VA16 = Pixel("va16", 16, 2, 4)
RGBA8 = Pixel("rgba8", 8, 4, 6)
RGBA16 = Pixel("rgba16", 16, 4, 6)

_PIXELS = {
    p.code: p
    for p in (V1, V2, V4, V8, V16, RGB8, RGB16, INDEXED1, INDEXED2, INDEXED4,
              INDEXED8, VA8, VA16, RGBA8, RGBA16)
}


def recognize_pixel(code: tuple[int, int]) -> Pixel | None:
    """IHDR (depth, color) code → pixel format."""
    return _PIXELS.get(code)


@dataclass(frozen=True)
class Format:
    """A color format: one of the reference's 17 ``PNG.Format`` cases.

    ``kind`` is the case name (``v8``, ``rgb8``, ``bgr8``, ``indexed4``,
    ``rgba16``, ``bgra8``, …); payloads:

    * ``palette`` — RGB triplets for non-indexed kinds, RGBA quadruplets for
      indexed kinds (transparency folded in, ``PNG.Format.swift:452-470``);
    * ``fill`` — background (sample scalar, RGB triple, or palette index);
    * ``key`` — chroma key (sample scalar or RGB triple).
    """

    kind: str
    palette: tuple = field(default=())
    fill: object = None
    key: object = None

    @property
    def pixel(self) -> Pixel:
        name = {"bgr8": "rgb8", "bgra8": "rgba8"}.get(self.kind, self.kind)
        for p in _PIXELS.values():
            if p.name == name:
                return p
        raise AssertionError(self.kind)

    @property
    def is_bgr(self) -> bool:
        return self.kind in ("bgr8", "bgra8")

    @property
    def is_indexed(self) -> bool:
        return self.kind.startswith("indexed")

    def validate(self) -> "Format":
        """Palette-count / sample-range checks
        (``PNG.Format.swift:274-351``)."""
        depth = self.pixel.depth
        max_sample = (1 << depth) - 1
        max_count = 1 << min(depth, 8)
        if self.is_indexed:
            if not self.palette:
                raise ParsingError.invalidPaletteCount(count=0, max=max_count)
        if self.palette and len(self.palette) > max_count:
            raise ParsingError.invalidPaletteCount(
                count=len(self.palette), max=max_count)
        scalar_kinds = ("v1", "v2", "v4", "v8", "v16")
        triple_kinds = ("rgb8", "rgb16", "bgr8")
        quad_kinds = ("rgba8", "rgba16", "bgra8")
        if self.kind in scalar_kinds and self.fill is not None:
            if self.fill > max_sample:
                raise ParsingError.invalidBackgroundSample(
                    sample=self.fill, max=max_sample)
        if self.kind in triple_kinds + quad_kinds and self.fill is not None:
            for sample in self.fill[:3]:
                if sample > max_sample:
                    raise ParsingError.invalidBackgroundSample(
                        sample=sample, max=max_sample)
        if self.is_indexed and self.fill is not None:
            if self.fill > len(self.palette) - 1:
                raise ParsingError.invalidBackgroundIndex(
                    index=self.fill, max=len(self.palette) - 1)
        # NB: the reference only range-checks the chroma key when a fill is
        # also present (a pattern-match quirk, ``PNG.Format.swift:334-338``);
        # checking it unconditionally is strictly safer and PNG-spec-exact
        if self.kind in scalar_kinds and self.key is not None:
            if self.key > max_sample:
                raise ParsingError.invalidTransparencySample(
                    sample=self.key, max=max_sample)
        if self.kind in triple_kinds and self.key is not None:
            for sample in self.key[:3]:
                if sample > max_sample:
                    raise ParsingError.invalidTransparencySample(
                        sample=sample, max=max_sample)
        return self


@dataclass(frozen=True)
class Layout:
    """Color format + interlacing flag (``PNG.Layout.swift:28-33``)."""

    format: Format
    interlaced: bool = False

    def __post_init__(self):
        self.format.validate()

    # encode-side reconstruction of chunk models from the format
    # (``PNG.Layout.swift:60-194``)
    @property
    def palette(self):
        from .parsing import Palette

        f = self.format
        if f.is_indexed:
            entries = [(r, g, b) for (r, g, b, _) in f.palette]
            return Palette(entries)
        if f.palette:
            if f.is_bgr:
                return Palette([(r, g, b) for (b, g, r) in f.palette])
            return Palette(list(f.palette))
        return None

    @property
    def transparency(self):
        from .parsing import Transparency

        f = self.format
        if f.key is not None:
            if f.pixel.color_type == 0:
                return Transparency("v", f.key)
            key = f.key
            if f.is_bgr:
                key = (key[2], key[1], key[0])
            return Transparency("rgb", key)
        if f.is_indexed:
            alphas = [a for (_, _, _, a) in f.palette]
            # trim trailing opaque entries
            while alphas and alphas[-1] == 255:
                alphas.pop()
            if alphas:
                return Transparency("palette", alphas)
        return None

    @property
    def background(self):
        from .parsing import Background

        f = self.format
        if f.fill is None:
            return None
        if f.pixel.color_type in (0, 4):
            return Background("v", f.fill)
        if f.is_indexed:
            return Background("palette", f.fill)
        fill = f.fill
        if f.is_bgr:
            fill = (fill[2], fill[1], fill[0])
        return Background("rgb", fill)


def recognize(standard: str, pixel: Pixel, palette, background,
              transparency):
    """Combine the PLTE, bKGD and tRNS chunk models (or ``None``) into a
    colour format (``PNG.Format.recognize``, ``PNG.Format.swift:356-550``).
    Returns ``None`` when an indexed image is missing its palette."""
    ctype = pixel.color_type
    if ctype == 0:  # grayscale
        fill = background.value if background else None
        key = transparency.value if transparency else None
        return Format(pixel.name, (), fill, key)
    if ctype == 2:  # rgb
        entries = tuple(palette.entries) if palette else ()
        fill = background.value if background else None
        key = transparency.value if transparency else None
        if standard == IOS and pixel.name == "rgb8":
            entries = tuple((b, g, r) for (r, g, b) in entries)
            fill = fill and (fill[2], fill[1], fill[0])
            key = key and (key[2], key[1], key[0])
            return Format("bgr8", entries, fill, key)
        return Format(pixel.name, entries, fill, key)
    if ctype == 3:  # indexed
        if palette is None:
            return None
        fill = background.value if background else None
        alpha = list(transparency.value) if transparency else []
        if len(alpha) > len(palette.entries):
            raise ParsingError.invalidTransparencyCount(
                count=len(alpha), max=len(palette.entries))
        rgba = tuple(
            (r, g, b, alpha[i] if i < len(alpha) else 255)
            for i, (r, g, b) in enumerate(palette.entries))
        return Format(pixel.name, rgba, fill, None)
    if ctype == 4:  # grayscale-alpha
        if palette is not None:
            raise ParsingError.unexpectedPalette(pixel=pixel.name)
        if transparency is not None:
            raise ParsingError.unexpectedTransparency(pixel=pixel.name)
        fill = background.value if background else None
        return Format(pixel.name, (), fill, None)
    # ctype == 6: rgba
    if transparency is not None:
        raise ParsingError.unexpectedTransparency(pixel=pixel.name)
    entries = tuple(palette.entries) if palette else ()
    fill = background.value if background else None
    if standard == IOS and pixel.name == "rgba8":
        entries = tuple((b, g, r) for (r, g, b) in entries)
        fill = fill and (fill[2], fill[1], fill[0])
        return Format("bgra8", entries, fill, None)
    return Format(pixel.name, entries, fill, None)
