"""filter_fetch_ms.encode: host ms a batch in the encode's filter stage
(``encode.filter``, the port's span over ``filter_batch``, the fetch of the
filtered rows and their copy into one byte string per image)."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, "encode.filter")
