"""stamp_roofline: K1 (``decode_stamp_kernel``, ``csrc/inflate_stamp.cu``)
against its bytes roofline, in %.  The work of a launch is the indexed
inflate of the batch: every compressed stream byte read once and every
decompressed byte (B * H * (1 + 4W)) written once."""

from harness.stats import roofline_pct

KERNEL = "decode_stamp_kernel"


def work_bytes(run) -> int:
    cfg = run.config
    out = run.batch * cfg["height"] * (1 + 4 * cfg["width"])
    return sum(run.inputs["stream_bytes"]) + out


def read(run):
    hit = run.kernel(KERNEL)
    if hit is None:
        return None
    return roofline_pct(work_bytes(run), *hit)
