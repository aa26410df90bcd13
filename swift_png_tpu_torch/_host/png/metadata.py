"""The ancillary chunks an image carries, with the decoder's ordering and
multiplicity checks (a copy of ``Metadata`` from
``swift_png_tpu/png/metadata.py``; the encoder writes them in
:func:`~swift_png_tpu_torch._host.png.image.write_pre_idat`)."""

from __future__ import annotations

from dataclasses import dataclass, field

from . import chunk as chunks
from . import parsing
from .errors import DecodingError


@dataclass
class Metadata:
    time: parsing.TimeModified | None = None
    chromaticity: parsing.Chromaticity | None = None
    color_profile: parsing.ColorProfile | None = None
    color_rendering: parsing.ColorRendering | None = None
    gamma: parsing.Gamma | None = None
    histogram: parsing.Histogram | None = None
    physical_dimensions: parsing.PhysicalDimensions | None = None
    significant_bits: parsing.SignificantBits | None = None
    suggested_palettes: list = field(default_factory=list)
    text: list = field(default_factory=list)
    application: list = field(default_factory=list)  # [(type, data)]

    def _unique(self, type: str, attr: str, value) -> None:
        if getattr(self, attr) is not None:
            raise DecodingError.duplicate(type)
        setattr(self, attr, value)

    def push_ancillary(self, type: str, data: bytes, pixel, palette,
                       state: dict) -> None:
        """Parse and check one ancillary chunk before the IDAT section.

        ``state`` carries ``background`` and ``transparency``, set here in
        place (``PNG.Metadata.swift:151-246``).  cHRM, gAMA, sRGB, iCCP and
        sBIT must come before PLTE; bKGD and tRNS may come once; hIST needs
        PLTE.
        """
        if type in (chunks.cHRM, chunks.gAMA, chunks.sRGB, chunks.iCCP,
                    chunks.sBIT):
            if palette is not None:
                raise DecodingError.unexpected(type, chunks.PLTE)
        if type in (chunks.CgBI, chunks.IHDR, chunks.PLTE, chunks.IDAT,
                    chunks.IEND):
            raise ValueError(f"{type} is not an ancillary chunk")

        if type == chunks.bKGD:
            if state.get("background") is not None:
                raise DecodingError.duplicate(type)
            state["background"] = parsing.Background.parse(data, pixel,
                                                           palette)
        elif type == chunks.tRNS:
            if state.get("transparency") is not None:
                raise DecodingError.duplicate(type)
            state["transparency"] = parsing.Transparency.parse(data, pixel,
                                                               palette)
        elif type == chunks.hIST:
            if palette is None:
                raise DecodingError.required(chunks.PLTE, chunks.hIST)
            self._unique(type, "histogram",
                         parsing.Histogram.parse(data, palette))
        elif type == chunks.cHRM:
            self._unique(type, "chromaticity",
                         parsing.Chromaticity.parse(data))
        elif type == chunks.gAMA:
            self._unique(type, "gamma", parsing.Gamma.parse(data))
        elif type == chunks.sRGB:
            self._unique(type, "color_rendering",
                         parsing.ColorRendering.parse(data))
        elif type == chunks.iCCP:
            self._unique(type, "color_profile",
                         parsing.ColorProfile.parse(data))
        elif type == chunks.sBIT:
            self._unique(type, "significant_bits",
                         parsing.SignificantBits.parse(data, pixel))
        elif type == chunks.pHYs:
            self._unique(type, "physical_dimensions",
                         parsing.PhysicalDimensions.parse(data))
        elif type == chunks.tIME:
            self._unique(type, "time", parsing.TimeModified.parse(data))
        elif type == chunks.sPLT:
            self.suggested_palettes.append(
                parsing.SuggestedPalette.parse(data))
        elif type == chunks.iTXt:
            self.text.append(parsing.Text.parse(data, unicode=True))
        elif type in (chunks.tEXt, chunks.zTXt):
            self.text.append(parsing.Text.parse(data, unicode=False))
        else:
            self.application.append((type, bytes(data)))
