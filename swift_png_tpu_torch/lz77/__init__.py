"""The sequential DEFLATE, zlib and gzip codec on the host (the names and
module paths of ``swift_png_tpu.lz77``, served by
:mod:`swift_png_tpu_torch._host.lz77`)."""

from .._host import publish
from .._host.lz77 import (checksums, constants, deflate, errors, gzip,
                          huffman, index, inflate)
from .._host.lz77.deflate import Deflator, RawDeflator
from .._host.lz77.errors import (DecompressionError, GzipStreamHeaderError,
                                 LZ77Error, StreamHeaderError)
from .._host.lz77.inflate import GzipInflator, Inflator

publish(__name__, checksums, constants, deflate, errors, gzip, huffman,
        index, inflate)

__all__ = ["DecompressionError", "GzipStreamHeaderError", "LZ77Error",
           "StreamHeaderError", "Deflator", "RawDeflator", "GzipInflator",
           "Inflator"]
