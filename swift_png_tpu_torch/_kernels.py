"""Build, load and launch the port's CUDA kernels.

Each source in ``csrc/`` holds one kernel and a plain C launch function.
The first launch compiles every source with ``nvcc`` for ``sm_90a``, one
compiler process per source, all started together, into ``_build/`` beside
this file (one shared library per source, named by a hash of the source and
the flags, so an edited source builds anew), and loads the libraries with
``ctypes``.  Nothing is built or loaded when a module is imported.

A launch function returns the CUDA error code of its launch.  A wrapper
raises on anything but 0 and counts the launch on its :class:`Kernel`, so a
run can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class Kernel:
    """One CUDA source: its C launch symbol, signature and launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_seconds: float | None = None
        self.ptxas = ""            # nvcc -Xptxas -v report of the build
        self._lib = None
        self._fn = None

    def launch(self, *args) -> None:
        """Launch on the caller's stream; raise if CUDA refused it."""
        if self._fn is None:
            build()
        rc = self._fn(*args)
        if rc != 0:
            msg = self._lib.spt_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed ({rc}): "
                               f"{msg}")
        self.launches += 1

    def resident_warps(self) -> int | None:
        """Warps of the kernel one SM holds at its launch shape (CUDA's
        occupancy calculator), where its source reports it."""
        if self._fn is None:
            build()
        fn = getattr(self._lib, "spt_resident_warps", None)
        if fn is None:
            return None
        warps = ctypes.c_int(0)
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        rc = fn(ctypes.byref(warps))
        if rc != 0:
            raise RuntimeError(f"{self.name}: occupancy query failed ({rc})")
        return warps.value


KERNELS = {
    "decode_stamp": Kernel("decode_stamp", "inflate_stamp.cu",
                           "spt_decode_stamp", [_P] * 10 + [_I] * 5 + [_P]),
    "defilter": Kernel("defilter", "defilter.cu", "spt_defilter",
                       [_P, _P, _I, _I, _I, _I, _P]),
    "seqcopy": Kernel("seqcopy", "seqcopy.cu", "spt_seqcopy",
                      [_P] * 4 + [_I] * 3 + [_P, _P]),
    "cand": Kernel("cand", "cand.cu", "spt_cand", [_P] * 5 + [_I] * 3 + [_P]),
    "dp_parse": Kernel("dp_parse", "dp_parse.cu", "spt_dp_parse",
                       [_P] * 11 + [_I] * 2 + [_P]),
    "emit": Kernel("emit", "emit.cu", "spt_emit",
                   [_P] * 5 + [_L, _I, _P]),
    "inflate_stream": Kernel("inflate_stream", "inflate_stream.cu",
                             "spt_inflate_stream",
                             [_P, _L, _L, _I, _P] + [_L] * 8 + [_P, _P]),
}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (CUDA_HOME or PATH)")
    return found


def build() -> dict[str, Kernel]:
    """Compile what is not built yet, load every kernel, return them."""
    with _LOCK:
        pending = [k for k in KERNELS.values() if k._fn is None]
        if not pending:
            return KERNELS
        BUILD_DIR.mkdir(exist_ok=True)
        jobs = []
        try:
            for k in pending:
                src = CSRC / k.source
                tag = hashlib.sha256(
                    src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                ).hexdigest()[:16]
                lib = BUILD_DIR / f"{src.stem}-{tag}.so"
                proc = tmp = None
                if not lib.exists():
                    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                    proc = subprocess.Popen(
                        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True)
                jobs.append((k, lib, proc, tmp, time.perf_counter()))
            for k, lib, proc, tmp, t0 in jobs:
                if proc is not None:
                    out, err = proc.communicate()
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed on {k.source}:\n{out}{err}")
                    os.replace(tmp, lib)
                    k.build_seconds = time.perf_counter() - t0
                    k.ptxas = err
                k._lib = ctypes.CDLL(str(lib))
                k._lib.spt_error_string.argtypes = [_I]
                k._lib.spt_error_string.restype = ctypes.c_char_p
                fn = getattr(k._lib, k.symbol)
                fn.argtypes = k.argtypes
                fn.restype = ctypes.c_int
                k._fn = fn
        finally:
            for _, _, proc, _, _ in jobs:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return KERNELS


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no device named and no GPU present this raises: a
    missing card is never hidden by a quiet run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run "
                               "the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            ndim: int) -> None:
    """Validate a tensor handed to a kernel (the kernel trusts its input)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
