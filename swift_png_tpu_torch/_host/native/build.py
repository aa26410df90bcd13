"""Build the port's native host library:
``python -m swift_png_tpu_torch.native.build``.

The library lands in the package's git-ignored ``_build/`` directory, beside
the CUDA kernels' libraries.  The loader builds it at first use when it is
missing.
"""

from __future__ import annotations

import os
import subprocess
import sys

from . import _BUILD_DIR as BUILD_DIR, _LIB_PATH as LIB

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ["src/spt_native.cpp", "src/spt_deflate.cpp"]


def build(verbose: bool = True) -> str:
    """Compile the sources with ``g++`` into :data:`LIB`; raise
    ``RuntimeError`` with the compiler's output when it fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a temp name and atomically rename: writing the .so in
    # place truncates the inode other live processes have mmap'd (their
    # code pages turn to garbage → SIGSEGV); rename leaves old mappings
    # on the old inode
    tmp = LIB + f".tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-o", tmp] + [os.path.join(HERE, s) for s in SOURCES]
    if verbose:
        print(" ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB


if __name__ == "__main__":
    build()
    print(f"built {LIB}")
    sys.exit(0)
