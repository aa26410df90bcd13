"""inflate_assemble_ms.decode_png: host ms a batch in the general inflate's
global assembly (``inflate_fused.assemble``, the port's span over the
ranks, the pointer doubling with its comparison each round, the gather,
the Adler-32 and the last fetch), summed over the batch's streams."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, "inflate_fused.assemble")
