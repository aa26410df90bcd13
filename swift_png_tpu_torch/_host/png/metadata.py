"""The ancillary chunks an image carries (a copy of the ``Metadata``
dataclass from ``swift_png_tpu/png/metadata.py``; the encoder writes them
in :func:`~swift_png_tpu_torch._host.png.image.write_pre_idat`)."""

from __future__ import annotations

from dataclasses import dataclass, field

from . import parsing


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
