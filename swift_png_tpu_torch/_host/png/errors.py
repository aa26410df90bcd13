"""PNG lexing and parsing errors (the cases the port's decode can raise,
copied from ``swift_png_tpu/png/errors.py``)."""

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
]:
    setattr(ParsingError, _name, _parsing_case(_name, _msg))
