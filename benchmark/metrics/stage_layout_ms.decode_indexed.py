"""stage_layout_ms.decode_indexed: host ms a batch building the checkpoint
inflate's unit-major layout in numpy (``checkpoint.layout``, the port's
span over the unit slicing, ``prepare_block_tables`` and ``tile_budget``)."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, "checkpoint.layout")
