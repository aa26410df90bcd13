"""stage_upload_ms.decode_indexed: host ms a batch uploading the checkpoint
inflate's staged arrays (``checkpoint.upload``, the port's span over every
host-to-device copy of them and the cut of the units' spans)."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, "checkpoint.upload")
