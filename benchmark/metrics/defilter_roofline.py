"""defilter_roofline: K3 (``defilter_kernel``, ``csrc/defilter.cu``)
against its bytes roofline, in %.  The work of a launch is the batch's
filtered rows read once (B * H * (1 + 4W)) and its raw rows written once
(B * H * 4W)."""

from harness.stats import roofline_pct

KERNEL = "defilter_kernel"


def work_bytes(run) -> int:
    cfg = run.config
    rows = run.batch * cfg["height"]
    return rows * (1 + 4 * cfg["width"]) + rows * 4 * cfg["width"]


def read(run):
    hit = run.kernel(KERNEL)
    if hit is None:
        return None
    return roofline_pct(work_bytes(run), *hit)
