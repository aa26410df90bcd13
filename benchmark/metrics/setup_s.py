"""setup_s: seconds from the start of the process to the start of the
window: imports, inputs, the kernels' build or load, the native library,
the warm call."""


def read(run):
    return run.setup_s
