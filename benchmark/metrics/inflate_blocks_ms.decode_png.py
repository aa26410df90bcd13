"""inflate_blocks_ms.decode_png: host ms a batch in the general inflate's
block loop (``inflate_fused.blocks``, the port's span over the per-block
header parse, table decode, token decode and scatter, and the fetch of each
block's token count), summed over the batch's streams."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, "inflate_fused.blocks")
