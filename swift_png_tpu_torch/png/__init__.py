"""The single-image PNG API: container framing, chunk models, streaming
decode and encode (the names and module paths of ``swift_png_tpu.png``,
served by the port's host layer in :mod:`swift_png_tpu_torch._host.png`:
``swift_png_tpu_torch.png.format`` is ``swift_png_tpu_torch._host.png.
format``, and so on)."""

from .._host import publish
from .._host.png import (chunk, context, decoder, encoder, errors, format,
                         image, metadata, parsing, system)
from .._host.png.chunk import SIGNATURE, ByteDestination, ByteSource
from .._host.png.context import Context
from .._host.png.decoder import ADAM7, Decoder, adam7_subimage, defilter
from .._host.png.encoder import Encoder, filter_select
from .._host.png.errors import (DecodingError, FormattingError,
                                LexingError, ParsingError, PNGError)
from .._host.png.format import (COMMON, IOS, Format, Layout, Pixel,
                                recognize, recognize_pixel)
from .._host.png.image import Image
from .._host.png.metadata import Metadata
from .._host.png.system import FileDestination, FileSource

publish(__name__, chunk, context, decoder, encoder, errors, format, image,
        metadata, parsing, system)

__all__ = ["SIGNATURE", "ByteDestination", "ByteSource", "Context", "ADAM7",
           "Decoder", "adam7_subimage", "defilter", "Encoder",
           "filter_select", "DecodingError", "FormattingError",
           "LexingError", "ParsingError", "PNGError", "COMMON", "IOS",
           "Format", "Layout", "Pixel", "recognize", "recognize_pixel",
           "Image", "Metadata", "FileDestination", "FileSource"]
