"""Readable dumps of an image's metadata (a copy of
``swift_png_tpu/inspection.py``; the ``PNGInspection`` dumps of the
reference): one line per chunk model, ``Name { field: value, ... }``."""

from __future__ import annotations

from ._host.png.metadata import Metadata


def describe_metadata(metadata: Metadata) -> str:
    """Multi-line dump of a :class:`Metadata`."""
    lines = []
    singles = [
        ("time modified", metadata.time),
        ("chromaticity", metadata.chromaticity),
        ("color profile", metadata.color_profile),
        ("color rendering", metadata.color_rendering),
        ("gamma", metadata.gamma),
        ("histogram", metadata.histogram),
        ("physical dimensions", metadata.physical_dimensions),
        ("significant bits", metadata.significant_bits),
    ]
    for label, value in singles:
        if value is not None:
            lines.append(f"{label}: {_describe(value)}")
    for pal in metadata.suggested_palettes:
        lines.append(f"suggested palette: {_describe(pal)}")
    for text in metadata.text:
        lines.append(f"text: {_describe(text)}")
    for type_, data in metadata.application:
        lines.append(f"application data ('{type_}'): {len(data)} bytes")
    return "\n".join(lines) if lines else "(no metadata)"


def describe_image(image) -> str:
    """One line of size and format, then the metadata dump."""
    fmt = image.layout.format
    head = (f"PNG image {image.size[0]}×{image.size[1]} "
            f"({fmt.kind}{', interlaced' if image.layout.interlaced else ''})")
    return head + "\n" + describe_metadata(image.metadata)


def _describe(model) -> str:
    # the class name is part of the dump
    cls = type(model).__name__
    fields = {}
    for name in getattr(model, "__dataclass_fields__", {}):
        value = getattr(model, name)
        if isinstance(value, (bytes, bytearray)):
            value = f"<{len(value)} bytes>"
        elif isinstance(value, list) and len(value) > 8:
            value = f"[{len(value)} entries]"
        fields[name] = value
    if not fields:
        return repr(model)
    inner = ", ".join(f"{k}: {v!r}" for k, v in fields.items())
    return f"{cls} {{ {inner} }}"
