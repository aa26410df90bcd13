"""The sequential DEFLATE, zlib and gzip codec on the host (the names of
``swift_png_tpu.lz77``, served by :mod:`swift_png_tpu_torch._host.lz77`)."""

from .._host.lz77 import (checksums, constants, errors, gzip,  # noqa: F401
                          huffman)
from .._host.lz77.deflate import Deflator, RawDeflator
from .._host.lz77.errors import (DecompressionError, GzipStreamHeaderError,
                                 LZ77Error, StreamHeaderError)
from .._host.lz77.inflate import GzipInflator, Inflator

__all__ = ["DecompressionError", "GzipStreamHeaderError", "LZ77Error",
           "StreamHeaderError", "Deflator", "RawDeflator", "GzipInflator",
           "Inflator"]
