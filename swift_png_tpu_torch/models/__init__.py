"""Colour targets (the names and module paths of ``swift_png_tpu.models``,
served by :mod:`swift_png_tpu_torch._host.models`)."""

from .._host import publish
from .._host.models import (RGBA, VA, ColorTarget, V, color,
                            deconvolve_samples, premultiply, rgba,
                            samples_from_storage, straighten, v, va)

publish(__name__, color, rgba, v, va)

__all__ = ["RGBA", "V", "VA", "ColorTarget", "premultiply", "straighten",
           "samples_from_storage", "deconvolve_samples"]
