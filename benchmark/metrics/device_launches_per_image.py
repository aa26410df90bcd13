"""device_launches_per_image (``.decode``, ``.decode_png``): device kernels
launched per image decoded, in the profiled stretch.  Of whole batches:
every launch over the images.  Of a batch too long to trace whole (the
traffic's ``profile`` names a span that runs once per image): the launches
made inside the span's profiled calls over those calls, plus the rest of
the batch (its tail, run once for all images) over the batch."""


def read(run):
    t = run.trace
    if t is None or not t["images"]:
        return None
    total = sum(n for n, _ in t["kernels"].values())
    span = run.traffic["profile"].get("span")
    if span is None:
        return total / t["images"]
    if t["launches_by_span"] is None:
        return None
    inside = t["launches_by_span"].get(span, 0)
    return inside / t["images"] + (total - inside) / run.batch
