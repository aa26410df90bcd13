"""Colour targets (the names of ``swift_png_tpu.models``, served by
:mod:`swift_png_tpu_torch._host.models`)."""

from .._host.models import (RGBA, VA, ColorTarget, V, deconvolve_samples,
                            premultiply, samples_from_storage, straighten)

__all__ = ["RGBA", "V", "VA", "ColorTarget", "premultiply", "straighten",
           "samples_from_storage", "deconvolve_samples"]
