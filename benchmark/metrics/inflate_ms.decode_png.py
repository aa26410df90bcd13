"""inflate_ms.decode_png: host ms a batch in the general inflate,
``InflateFused.inflate`` (once per file), summed over the batch."""

SPANS = {"inflate_fused": [
    "swift_png_tpu_torch.ops.inflate_fused:InflateFused.inflate"]}


def read(run):
    return run.span_ms_per_batch("inflate_fused")
