"""PNG errors: the lexing cases, every chunk model's parsing cases, the
decoder's chunk-order and image-data cases and the formatting case (copies
of ``swift_png_tpu/png/errors.py``, with the same ``case`` names)."""

from __future__ import annotations


class PNGError(Exception):
    namespace = "png"

    def __init__(self, case: str, message: str, **details):
        self.case = case
        self.details = details
        super().__init__(f"{self.namespace}.{case}: {message}"
                         + (f" {details}" if details else ""))


class LexingError(PNGError):
    namespace = "png.lexing error"

    @classmethod
    def truncated_signature(cls):
        return cls("truncatedSignature", "truncated png file signature")

    @classmethod
    def invalid_signature(cls, got: bytes):
        return cls("invalidSignature", "invalid png file signature",
                   bytes=list(got))

    @classmethod
    def truncated_chunk_header(cls):
        return cls("truncatedChunkHeader", "truncated chunk header")

    @classmethod
    def truncated_chunk_body(cls, expected: int):
        return cls("truncatedChunkBody", "truncated chunk body",
                   expected=expected)

    @classmethod
    def invalid_chunk_type_code(cls, code: int):
        return cls("invalidChunkTypeCode", "invalid chunk type code",
                   code=code)

    @classmethod
    def invalid_chunk_checksum(cls, declared: int, computed: int):
        return cls("invalidChunkChecksum", "invalid chunk checksum",
                   declared=declared, computed=computed)


class ParsingError(PNGError):
    namespace = "png.parsing error"


def _parsing_case(name: str, message: str):
    def ctor(cls, **details):
        return cls(name, message, **details)

    ctor.__name__ = name
    return classmethod(ctor)


for _name, _msg in [
    ("invalidHeaderChunkLength", "invalid IHDR chunk length"),
    ("invalidHeaderPixelFormatCode", "invalid IHDR pixel format code"),
    ("invalidHeaderPixelFormat", "invalid IHDR pixel format for standard"),
    ("invalidHeaderCompressionMethodCode", "invalid IHDR compression method"),
    ("invalidHeaderFilterCode", "invalid IHDR filter code"),
    ("invalidHeaderInterlacingCode", "invalid IHDR interlacing code"),
    ("invalidHeaderSize", "invalid IHDR size"),
    ("unexpectedPalette", "unexpected PLTE for pixel format"),
    ("invalidPaletteChunkLength", "PLTE length not divisible by 3"),
    ("invalidPaletteCount", "invalid palette entry count"),
    ("unexpectedTransparency", "unexpected tRNS for pixel format"),
    ("invalidTransparencyChunkLength", "invalid tRNS chunk length"),
    ("invalidTransparencySample", "tRNS sample exceeds depth range"),
    ("invalidTransparencyCount", "tRNS entry count exceeds palette"),
    ("invalidBackgroundChunkLength", "invalid bKGD chunk length"),
    ("invalidBackgroundSample", "bKGD sample exceeds depth range"),
    ("invalidBackgroundIndex", "bKGD index exceeds palette"),
    ("invalidHistogramChunkLength", "invalid hIST chunk length"),
    ("invalidGammaChunkLength", "invalid gAMA chunk length"),
    ("invalidChromaticityChunkLength", "invalid cHRM chunk length"),
    ("invalidColorRenderingChunkLength", "invalid sRGB chunk length"),
    ("invalidColorRenderingCode", "invalid sRGB rendering intent"),
    ("invalidColorProfileChunkLength", "invalid iCCP chunk length"),
    ("invalidColorProfileName", "invalid iCCP profile name"),
    ("invalidColorProfileCompressionMethodCode",
     "invalid iCCP compression method"),
    ("incompleteColorProfileCompressedDatastream",
     "incomplete iCCP datastream"),
    ("invalidSignificantBitsChunkLength", "invalid sBIT chunk length"),
    ("invalidSignificantBitsPrecision", "sBIT precision exceeds depth"),
    ("invalidPhysicalDimensionsChunkLength", "invalid pHYs chunk length"),
    ("invalidPhysicalDimensionsDensityUnitCode", "invalid pHYs unit code"),
    ("invalidTimeModifiedChunkLength", "invalid tIME chunk length"),
    ("invalidTimeModifiedTime", "invalid tIME fields"),
    ("invalidSuggestedPaletteChunkLength", "invalid sPLT chunk length"),
    ("invalidSuggestedPaletteName", "invalid sPLT name"),
    ("invalidSuggestedPaletteDataLength", "invalid sPLT data length"),
    ("invalidSuggestedPaletteDepthCode", "invalid sPLT depth code"),
    ("invalidSuggestedPaletteFrequency", "sPLT frequencies not descending"),
    ("invalidTextChunkLength", "invalid text chunk length"),
    ("invalidTextEnglishKeyword", "invalid text keyword"),
    ("invalidTextLocalizedKeyword", "invalid text localized keyword"),
    ("invalidTextLanguageTag", "invalid text language tag"),
    ("invalidTextCompressionMethodCode", "invalid text compression method"),
    ("invalidTextCompressionCode", "invalid text compression flag"),
    ("incompleteTextCompressedDatastream", "incomplete text datastream"),
]:
    setattr(ParsingError, _name, _parsing_case(_name, _msg))


class DecodingError(PNGError):
    """Chunk-order and image-data errors of the single-image decoder."""

    namespace = "png.decoding error"

    @classmethod
    def required(cls, chunk: str, before: str):
        return cls("required",
                   f"required chunk {chunk} missing before {before}",
                   chunk=chunk, before=before)

    @classmethod
    def duplicate(cls, chunk: str):
        return cls("duplicate", f"duplicate chunk {chunk}", chunk=chunk)

    @classmethod
    def unexpected(cls, chunk: str, after: str):
        return cls("unexpected", f"unexpected chunk {chunk} after {after}",
                   chunk=chunk, after=after)

    @classmethod
    def extraneous_compressed_data(cls):
        return cls("extraneousImageDataCompressedData",
                   "extraneous compressed image data")

    @classmethod
    def extraneous_image_data(cls):
        return cls("extraneousImageData", "extraneous image data")

    @classmethod
    def incomplete_compressed_datastream(cls):
        return cls("incompleteImageDataCompressedDatastream",
                   "incomplete compressed image datastream")


class FormattingError(PNGError):
    namespace = "png.formatting error"

    @classmethod
    def invalid_destination(cls):
        return cls("invalidDestination", "failed to write to destination")
