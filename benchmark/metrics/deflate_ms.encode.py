"""deflate_ms.encode: host ms a batch in the level 8-13 deflate,
``deflate_device_optimal_batch`` as ``parallel.batch`` calls it (menus, K4,
K5, trees, K6, packing, the strict size estimate, stream assembly)."""

SPANS = {"deflate_optimal": [
    "swift_png_tpu_torch.parallel.batch:deflate_device_optimal_batch"]}


def read(run):
    return run.span_ms_per_batch("deflate_optimal")
