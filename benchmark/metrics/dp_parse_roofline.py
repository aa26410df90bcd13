"""dp_parse_roofline: K5 (``dp_kernel``, ``csrc/dp_parse.cu``) against its
bytes roofline, in %.  The work of a launch is one min-cost parse of the
batch's filtered bytes: each byte read once (B * H * (1 + 4W)) and one
32-bit term written per byte."""

from harness.stats import roofline_pct

KERNEL = "dp_kernel"


def work_bytes(run) -> int:
    cfg = run.config
    n = run.batch * cfg["height"] * (1 + 4 * cfg["width"])
    return n + 4 * n


def read(run):
    hit = run.kernel(KERNEL)
    if hit is None:
        return None
    return roofline_pct(work_bytes(run), *hit)
