"""Streaming zlib/gzip (``Snippets/LZ77/StreamingZlib.swift`` /
``StreamingGzip.swift`` analogs): push/pull byte-at-a-time through the
resumable inflator/deflator state machines.
"""

import sys
import zlib

from swift_png_tpu_torch.lz77 import Deflator, Inflator
from swift_png_tpu_torch.lz77.gzip import GzipInflator, archive


def main(path: str) -> None:
    data = open(path, "rb").read()[:65536]

    # streaming compress: tiny pushes, pull whenever output is ready
    deflator = Deflator("zlib", level=9)
    out = bytearray()
    for ofs in range(0, len(data), 1024):
        deflator.push(data[ofs:ofs + 1024],
                      last=ofs + 1024 >= len(data))
        out += deflator.pull()
    stream = bytes(out)
    assert zlib.decompress(stream) == data
    print(f"streamed deflate: {len(data)} -> {len(stream)} bytes")

    # streaming decompress: 1-byte pushes — the inflator reports
    # progress as None until enough input arrives, exactly like the
    # reference's starvation contract
    inflator = Inflator("zlib")
    for i in range(len(stream)):
        inflator.push(stream[i:i + 1])
    assert bytes(inflator.pull()) == data
    print("byte-at-a-time inflate OK")

    # gzip container: one-shot archive, streaming extract
    gz = archive(data, level=6)
    ginf = GzipInflator()
    for ofs in range(0, len(gz), 777):
        ginf.push(gz[ofs:ofs + 777])
    assert bytes(ginf.pull()) == data
    print(f"gzip round trip OK ({len(gz)} bytes)")


if __name__ == "__main__":
    main(*sys.argv[1:])
