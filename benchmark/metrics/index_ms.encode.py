"""index_ms.encode: host ms a batch building the ``spIx`` checkpoint index,
``build_index`` as ``parallel.batch`` calls it (once per file), summed."""

SPANS = {"build_index": ["swift_png_tpu_torch.parallel.batch:build_index"]}


def read(run):
    return run.span_ms_per_batch("build_index")
