"""decode_MBps: decoded RGBA8 bytes (B*H*W*4, 10**6 to a MB) of every
call completed in the window, over the window's whole time."""

from harness.stats import rate


def read(run):
    return rate(run.raw_bytes * run.completed, run.window_s) / 1e6
