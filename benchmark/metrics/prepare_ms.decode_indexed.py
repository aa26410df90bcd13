"""prepare_ms.decode_indexed: host ms a batch in the staging of the
checkpoint inflate, ``CheckpointInflator.prepare`` (a child of ``run``):
unit spans, tables and budgets laid out and uploaded."""

SPANS = {"checkpoint_prepare": [
    "swift_png_tpu_torch.ops.inflate_checkpoint:CheckpointInflator.prepare"]}


def read(run):
    return run.span_ms_per_batch("checkpoint_prepare")
