"""The single-image ``Image`` and the pre-IDAT writer (copies of ``Image``
and ``write_pre_idat`` from ``swift_png_tpu/png/image.py``).

* ``storage``: 8- or 16-bit samples, row-major, deinterlaced; the sub-byte
  kinds keep one (unscaled) sample a byte, the 16-bit kinds big-endian byte
  pairs (``PNG.Image.swift:17-48``);
* ``assign``/``collect``: the strided scatter and gather of one scanline,
  sub-byte repacking included, as numpy index arithmetic;
* ``decompress``/``compress``: the chunk loops of ``PNG.Image.swift:298-401,
  576-668``, in the reference's chunk order;
* ``unpack``/``pack``: the colour targets of
  :mod:`swift_png_tpu_torch._host.models`.

The batched encoder writes its pre-IDAT chunks with :func:`write_pre_idat`,
so both encoders write the same containers.
"""

from __future__ import annotations

import numpy as np

from ..lz77.index import build_index
from ..models import RGBA
from . import chunk as chunks
from . import parsing
from .chunk import ByteDestination, ByteSource
from .decoder import ADAM7, adam7_subimage  # noqa: F401
from .encoder import Encoder
from .errors import DecodingError
from .format import COMMON, IOS, Layout, recognize
from .metadata import Metadata

_STRIDE_BYTES = {
    "v8": 1, "indexed8": 1,
    "va8": 2, "v16": 2,
    "rgb8": 3, "bgr8": 3,
    "rgba8": 4, "bgra8": 4, "va16": 4,
    "rgb16": 6,
    "rgba16": 8,
}
_SUB_BYTE = ("v1", "indexed1", "v2", "indexed2", "v4", "indexed4")


class Image:
    """A rectangular image (``PNG.Image``, ``PNG.Image.swift:17``)."""

    def __init__(self, size, layout: Layout, metadata: Metadata,
                 storage: np.ndarray):
        self.size = tuple(size)
        self.layout = layout
        self.metadata = metadata
        self.storage = storage  # np.uint8, flat

    # -- construction -----------------------------------------------------

    @classmethod
    def _create(cls, standard, header, palette, background, transparency,
                metadata):
        fmt = recognize(standard, header.pixel, palette, background,
                        transparency)
        if fmt is None:
            return None
        layout = Layout(fmt, header.interlaced)
        count = header.size[0] * header.size[1]
        nbytes = count * ((fmt.pixel.volume + 7) >> 3)
        return cls(header.size, layout, metadata, np.zeros(nbytes, np.uint8))

    def bind_storage(self, layout: Layout) -> "Image":
        """The same storage under another layout of the same kind and
        palette size (``PNG.Image.bindStorage``)."""
        old, new = self.layout.format, layout.format
        if old.kind != new.kind:
            raise ValueError(
                f"new pixel format ({new.kind}) must match old ({old.kind})")
        if old.is_indexed and len(old.palette) != len(new.palette):
            raise ValueError("palette counts must match")
        return Image(self.size, layout, self.metadata, self.storage)

    # -- strided scanline scatter/gather -----------------------------------

    def _sample_stride(self) -> int:
        kind = self.layout.format.kind
        return 1 if kind in _SUB_BYTE else _STRIDE_BYTES[kind]

    def assign(self, scanline: np.ndarray, base, stride) -> None:
        """Scatter one defiltered scanline into storage
        (``PNG.Image.swift:186-285``)."""
        x0, y0 = base
        sx = stride[0] if isinstance(stride, tuple) else stride
        X = self.size[0]
        xs = np.arange(x0, X, sx)
        w = xs.size
        kind = self.layout.format.kind
        depth = self.layout.format.pixel.depth
        if kind in _SUB_BYTE:
            i = np.arange(w)
            per = 8 // depth
            bytes_ = scanline[i // per]
            shift = (per - 1 - (i % per)) * depth
            samples = (bytes_ >> shift) & ((1 << depth) - 1)
            self.storage[y0 * X + xs] = samples
        else:
            m = _STRIDE_BYTES[kind]
            dest = (m * (y0 * X + xs))[:, None] + np.arange(m)[None, :]
            src = scanline[: w * m].reshape(w, m)
            self.storage[dest.reshape(-1)] = src.reshape(-1)

    def collect(self, scanline: np.ndarray, base, stride_x: int) -> None:
        """Gather one scanline's raw bytes from storage
        (``PNG.Image.swift:431-544``)."""
        x0, y0 = base
        X = self.size[0]
        xs = np.arange(x0, X, stride_x)
        w = xs.size
        kind = self.layout.format.kind
        depth = self.layout.format.pixel.depth
        if kind in _SUB_BYTE:
            per = 8 // depth
            i = np.arange(w)
            shift = (per - 1 - (i % per)) * depth
            samples = (self.storage[y0 * X + xs] & ((1 << depth) - 1)) << shift
            scanline[:] = 0
            np.bitwise_or.at(scanline, i // per, samples)
        else:
            m = _STRIDE_BYTES[kind]
            src = (m * (y0 * X + xs))[:, None] + np.arange(m)[None, :]
            scanline[: w * m] = self.storage[src.reshape(-1)]

    def overdraw(self, base, brush) -> None:
        """Fill a decoded pixel's ``brush`` block, for progressive display
        (``PNG.Image.overdraw``, ``PNG.Image.swift:134-183``)."""
        if brush[0] * brush[1] <= 1:
            return
        m = self._sample_stride()
        X, Y = self.size
        view = (self.storage.reshape(Y, X, m) if m > 1
                else self.storage.reshape(Y, X))
        for y in range(base[1], min(base[1] + brush[1], Y)):
            for x in range(base[0], X, brush[0]):
                view[y, x: min(x + brush[0], X)] = view[base[1], x]

    # -- decompression ------------------------------------------------------

    @classmethod
    def decompress(cls, stream: ByteSource) -> "Image":
        """Decode a PNG from a bytestream (``PNG.Image.swift:298-401``)."""
        from .context import Context

        stream.signature()
        type_, data = stream.chunk()
        standard = COMMON
        if type_ == chunks.CgBI:
            standard = IOS
            type_, data = stream.chunk()
        if type_ != chunks.IHDR:
            raise DecodingError.required(chunks.IHDR, type_)
        header = parsing.Header.parse(data, standard)

        type_, data = stream.chunk()
        palette = None
        metadata = Metadata()
        state = {"background": None, "transparency": None}
        while True:
            if type_ == chunks.IHDR:
                raise DecodingError.duplicate(chunks.IHDR)
            elif type_ == chunks.PLTE:
                if palette is not None:
                    raise DecodingError.duplicate(chunks.PLTE)
                if state["background"] is not None:
                    raise DecodingError.unexpected(chunks.PLTE, chunks.bKGD)
                if state["transparency"] is not None:
                    raise DecodingError.unexpected(chunks.PLTE, chunks.tRNS)
                palette = parsing.Palette.parse(data, header.pixel)
            elif type_ == chunks.IDAT:
                context = Context(
                    standard, header, palette,
                    state["background"], state["transparency"], metadata)
                if context.image is None:
                    raise DecodingError.required(chunks.PLTE, chunks.IDAT)
                break
            elif type_ == chunks.IEND:
                raise DecodingError.required(chunks.IDAT, chunks.IEND)
            else:
                metadata.push_ancillary(type_, data, header.pixel, palette,
                                        state)
            type_, data = stream.chunk()

        while type_ == chunks.IDAT:
            context.push_data(data)
            type_, data = stream.chunk()

        while True:
            context.push_ancillary(type_, data)
            if type_ == chunks.IEND:
                return context.image
            type_, data = stream.chunk()

    @classmethod
    def decompress_bytes(cls, data: bytes) -> "Image":
        return cls.decompress(ByteSource(data))

    @classmethod
    def decompress_path(cls, path: str) -> "Image":
        with open(path, "rb") as f:
            return cls.decompress_bytes(f.read())

    # -- compression ---------------------------------------------------------

    def encode_chunks(self):
        """(header, palette, background, transparency, cgbi, standard) of
        this image (``PNG.Image.encode``, ``PNG.Image.swift:407-428``)."""
        return _encode_chunks(self.size, self.layout)

    def compress(self, stream: ByteDestination, level: int = 9,
                 hint: int = 1 << 15, engine: str = "auto",
                 index: bool = False, index_ob: int = 256) -> None:
        """Encode to a bytestream in the reference's chunk order
        (``PNG.Image.swift:576-668``).

        ``engine``: ``auto`` (the native deflater when the library is
        available), ``native`` or ``python``.  ``index=True`` also writes
        the private ancillary ``spIx`` chunk after the IDAT run: the
        checkpoint index that the batched decoder's lockstep inflate starts
        from (other decoders skip it)."""
        standard = write_pre_idat(stream, self.size, self.layout,
                                  self.metadata)
        encoder = Encoder(standard, self.layout.interlaced, level, hint,
                          engine)
        idats = [] if index else None
        while True:
            data = encoder.pull(self.size, self.layout.format.pixel,
                                self.collect)
            if data is None:
                break
            if idats is not None:
                idats.append(data)
            stream.format(chunks.IDAT, data)
        if idats is not None and standard == COMMON:
            full = b"".join(idats)
            ix = build_index(full[2:-4], self._decompressed_size(), index_ob)
            if ix is not None:
                stream.format(chunks.spIx, ix.serialize())
        stream.format(chunks.IEND)

    def _decompressed_size(self) -> int:
        """Total filtered-scanline byte count (the zlib payload size)."""
        x, y = self.size
        volume = self.layout.format.pixel.volume
        if not self.layout.interlaced:
            return y * (1 + ((x * volume + 7) >> 3))
        total = 0
        for z in range(7):
            sx, sy = adam7_subimage((x, y), z)
            if sx and sy:
                total += sy * (1 + ((sx * volume + 7) >> 3))
        return total

    def compress_bytes(self, level: int = 9, hint: int = 1 << 15,
                       engine: str = "auto", index: bool = False,
                       index_ob: int = 256) -> bytes:
        dest = ByteDestination()
        self.compress(dest, level, hint, engine, index=index,
                      index_ob=index_ob)
        return dest.getvalue()

    def compress_path(self, path: str, level: int = 9, hint: int = 1 << 15,
                      engine: str = "auto", index: bool = False,
                      index_ob: int = 256) -> None:
        with open(path, "wb") as f:
            f.write(self.compress_bytes(level, hint, engine, index=index,
                                        index_ob=index_ob))

    # -- pixel access ---------------------------------------------------------

    def unpack(self, target, deindexer=None):
        """Unpack to a colour target of
        :mod:`swift_png_tpu_torch._host.models` (``PNG.Image.unpack(as:)``).
        ``deindexer`` maps an indexed format's palette to the table the
        target reads (``unpack(as:deindexer:)``)."""
        if deindexer is not None:
            return target.unpack(self.storage, self.layout.format,
                                 self.size, deindexer=deindexer)
        return target.unpack(self.storage, self.layout.format, self.size)

    def unpack_rgba16(self) -> np.ndarray:
        return self.unpack(RGBA.of16)

    def unpack_rgba8(self) -> np.ndarray:
        return self.unpack(RGBA.of8)

    @classmethod
    def pack(cls, pixels: np.ndarray, layout: Layout,
             metadata: Metadata | None = None, target=None,
             indexer=None) -> "Image":
        """Pack a pixel array into an image (``PNG.Image.init(packing:)``,
        ``PNG.Image.swift:1080-1145``); ``indexer`` maps an indexed
        format's palette to the function from pixels to indices."""
        target = target or (RGBA.of16 if pixels.dtype == np.uint16
                            else RGBA.of8)
        y, x = pixels.shape[:2]
        if indexer is not None:
            storage = target.pack(pixels.reshape(y * x, -1), layout.format,
                                  indexer=indexer)
        else:
            storage = target.pack(pixels.reshape(y * x, -1), layout.format)
        return cls((x, y), layout, metadata or Metadata(), storage)


def _encode_chunks(size, layout: Layout):
    fmt = layout.format
    if fmt.kind == "bgr8":
        cgbi, standard = bytes([48, 0, 32, 6]), IOS
    elif fmt.kind == "bgra8":
        cgbi, standard = bytes([48, 0, 32, 2]), IOS
    else:
        cgbi, standard = None, COMMON
    header = parsing.Header(size, fmt.pixel, layout.interlaced)
    return (header, layout.palette, layout.background, layout.transparency,
            cgbi, standard)


def write_pre_idat(stream: ByteDestination, size, layout: Layout,
                   metadata: Metadata) -> str:
    """Signature + every pre-IDAT chunk in the reference's exact emission
    order (``PNG.Image.compress``, ``PNG.Image.swift:589-656``): CgBI for
    bgr8/bgra8, IHDR, cHRM, gAMA, sRGB, iCCP, sBIT, PLTE, bKGD, tRNS, hIST,
    pHYs, tIME, every text as iTXt, sPLT and the application chunks.
    Returns the stream standard (``COMMON``/``IOS``)."""
    header, palette, background, transparency, cgbi, standard = (
        _encode_chunks(size, layout))
    stream.signature()
    if cgbi is not None:
        stream.format(chunks.CgBI, cgbi)
    stream.format(chunks.IHDR, header.serialized)
    md = metadata
    if md.chromaticity is not None:
        stream.format(chunks.cHRM, md.chromaticity.serialized)
    if md.gamma is not None:
        stream.format(chunks.gAMA, md.gamma.serialized)
    if md.color_rendering is not None:
        stream.format(chunks.sRGB, md.color_rendering.serialized)
    if md.color_profile is not None:
        stream.format(chunks.iCCP, md.color_profile.serialized)
    if md.significant_bits is not None:
        stream.format(chunks.sBIT, md.significant_bits.serialized)
    if palette is not None:
        stream.format(chunks.PLTE, palette.serialized)
    if background is not None:
        stream.format(chunks.bKGD, background.serialized)
    if transparency is not None:
        stream.format(chunks.tRNS, transparency.serialized)
    if md.histogram is not None:
        stream.format(chunks.hIST, md.histogram.serialized)
    if md.physical_dimensions is not None:
        stream.format(chunks.pHYs, md.physical_dimensions.serialized)
    if md.time is not None:
        stream.format(chunks.tIME, md.time.serialized)
    for text in md.text:
        stream.format(chunks.iTXt, text.serialized)
    for spal in md.suggested_palettes:
        stream.format(chunks.sPLT, spal.serialized)
    for (type_, data) in md.application:
        stream.format(type_, data)
    return standard
