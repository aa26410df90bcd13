"""Bit-level utilities (the module path of ``swift_png_tpu.utils.bits``:
``reverse_bits`` and ``BitWriter``, served by
:mod:`swift_png_tpu_torch._host.bits`)."""

from .._host import bits, publish

publish(__name__, bits)
