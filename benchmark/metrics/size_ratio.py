"""size_ratio: bytes of the PNG files the window's calls returned, over
their raw RGBA8 bytes."""


def read(run):
    if not run.completed:
        return None
    return run.out_bytes / (run.raw_bytes * run.completed)
