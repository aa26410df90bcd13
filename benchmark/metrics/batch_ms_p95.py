"""batch_ms_p95: the 95th percentile (nearest rank) of the host clock of
each call, ending when its device work has ended, over the calls
of the window."""

from harness.stats import percentile


def read(run):
    return percentile([s * 1e3 for s in run.batch_s], 95)
