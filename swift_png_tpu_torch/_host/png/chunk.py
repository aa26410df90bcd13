"""PNG container lexing and writing: signature, chunk framing, CRC-32
(``ByteSource`` and ``ByteDestination`` of ``swift_png_tpu/png/chunk.py``;
the CRC is stdlib ``zlib.crc32``, served as ``crc32`` as the JAX module
serves its own)."""

from __future__ import annotations

from zlib import crc32

from .errors import LexingError

SIGNATURE = bytes([137, 80, 78, 71, 13, 10, 26, 10])

# the 19 named chunk types
CgBI = "CgBI"
IHDR = "IHDR"
PLTE = "PLTE"
IDAT = "IDAT"
IEND = "IEND"
cHRM = "cHRM"
gAMA = "gAMA"
iCCP = "iCCP"
sBIT = "sBIT"
sRGB = "sRGB"
bKGD = "bKGD"
hIST = "hIST"
tRNS = "tRNS"
pHYs = "pHYs"
sPLT = "sPLT"
tIME = "tIME"
iTXt = "iTXt"
tEXt = "tEXt"
zTXt = "zTXt"
# private ancillary chunk carrying the checkpoint decode index
spIx = "spIx"


def validate_type(name: bytes) -> str:
    """Validate a 4-byte chunk type code (letters only; the CgBI
    pseudo-chunk is allowed despite its nonstandard flag bits)."""
    if name == b"CgBI":
        return CgBI
    if len(name) != 4 or not all(
            (65 <= b <= 90) or (97 <= b <= 122) for b in name):
        raise LexingError.invalid_chunk_type_code(int.from_bytes(name, "big"))
    # reserved bit (bit 5 of the third byte) must be uppercase
    if name[2] & 0x20:
        raise LexingError.invalid_chunk_type_code(int.from_bytes(name, "big"))
    return name.decode("ascii")


class ByteSource:
    """An in-memory PNG bytestream."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0

    def read(self, count: int) -> bytes | None:
        if self.pos + count > len(self.data):
            return None
        out = self.data[self.pos: self.pos + count]
        self.pos += count
        return out

    def signature(self) -> None:
        raw = self.read(8)
        if raw is None:
            raise LexingError.truncated_signature()
        if raw != SIGNATURE:
            raise LexingError.invalid_signature(raw)

    def chunk(self) -> tuple[str, bytes]:
        header = self.read(8)
        if header is None:
            raise LexingError.truncated_chunk_header()
        length = int.from_bytes(header[:4], "big")
        name = validate_type(header[4:8])
        body = self.read(length + 4)
        if body is None:
            raise LexingError.truncated_chunk_body(length + 4)
        data, declared = body[:length], int.from_bytes(body[length:], "big")
        computed = crc32(header[4:8] + data)
        if computed != declared:
            raise LexingError.invalid_chunk_checksum(declared, computed)
        return name, data


class ByteDestination:
    """An in-memory PNG bytestream being written."""

    def __init__(self) -> None:
        self.chunks: list[bytes] = []

    def write(self, data: bytes) -> None:
        self.chunks.append(bytes(data))

    def signature(self) -> None:
        self.write(SIGNATURE)

    def format(self, type: str, data: bytes = b"") -> None:
        """One chunk: length, type, data and the CRC-32 of type + data."""
        name = type.encode("ascii")
        self.write(len(data).to_bytes(4, "big"))
        self.write(name)
        self.write(data)
        self.write(crc32(name + data).to_bytes(4, "big"))

    def getvalue(self) -> bytes:
        return b"".join(self.chunks)
