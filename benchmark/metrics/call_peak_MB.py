"""call_peak_MB: the most device memory (10**6 bytes to a MB) that one call
of the window held at once above what was held when it began: its staged
inputs, its working buffers and its output.  Read from the CUDA caching
allocator's counters of this process; nothing without a card."""


def read(run):
    if run.call_peak_bytes is None:
        return None
    return run.call_peak_bytes / 1e6
