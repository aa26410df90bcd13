"""inflate_ms.decode_indexed: host ms a batch in the checkpoint inflate,
``CheckpointInflator.run`` (staging, K1, routing probe, tail, checksums)."""

SPANS = {"checkpoint_run": [
    "swift_png_tpu_torch.ops.inflate_checkpoint:CheckpointInflator.run"]}


def read(run):
    return run.span_ms_per_batch("checkpoint_run")
