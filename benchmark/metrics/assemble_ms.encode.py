"""assemble_ms.encode: host ms a batch assembling the deflate's zlib
streams (``deflate.assemble``, the port's span over ``_zlib_stream`` of
each stream: header, trees, body, end of block, Adler-32)."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, "deflate.assemble")
