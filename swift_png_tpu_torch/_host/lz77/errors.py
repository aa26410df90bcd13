"""DEFLATE decode errors (the cases indexed decode raises, copied from
``swift_png_tpu/lz77/errors.py``)."""

from __future__ import annotations


class LZ77Error(Exception):
    """Base class: carries a ``case`` name and structured ``details``."""

    namespace = "lz77"

    def __init__(self, case: str, message: str, **details):
        self.case = case
        self.details = details
        super().__init__(f"{self.namespace}.{case}: {message}"
                         + (f" {details}" if details else ""))


class DecompressionError(LZ77Error):
    namespace = "lz77.decompression error"

    @classmethod
    def invalid_block_type_code(cls, code: int):
        return cls("invalidBlockTypeCode", "invalid block type code",
                   code=code)

    @classmethod
    def invalid_block_element_count_parity(cls, l: int, m: int):
        return cls("invalidBlockElementCountParity",
                   "invalid stored-block length parity", l=l, m=m)

    @classmethod
    def invalid_huffman_table(cls):
        return cls("invalidHuffmanTable", "invalid huffman table")

    @classmethod
    def invalid_string_reference(cls):
        return cls("invalidStringReference", "invalid string reference")
