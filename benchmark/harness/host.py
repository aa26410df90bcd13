"""Readings of the host beside each run: the CPU time this process used in
the window, and how long a fixed piece of host work takes right after it.
Every cell is paced by the host, so a drift of the host's speed shows in
the rates; these readings show it beside them.  They are printed and
correct no metric."""

from __future__ import annotations

import os
import resource
import time
import zlib

import numpy as np


def cpu_seconds() -> float:
    """User and system CPU seconds of this process so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


_BLOB = np.random.default_rng(0).integers(0, 16, 1 << 20,
                                          dtype=np.uint8).tobytes()


def probe(repeats: int = 3) -> dict:
    """Milliseconds of a fixed piece of host work, the least and the most
    of ``repeats``: an interpreter loop, ``zlib`` level 6 over 1 MiB, and a
    numpy sort of 2**20 numbers; and the CPUs this process may use."""
    work = {
        "loop": lambda: sum(i * i for i in range(200_000)),
        "zlib": lambda: zlib.compress(_BLOB, 6),
        "sort": lambda: np.sort(np.frombuffer(_BLOB, np.uint8)
                                .astype(np.int32) * 7919 % 65521),
    }
    out = {}
    for name, fn in work.items():
        ms = []
        for _ in range(repeats):
            t = time.perf_counter()
            fn()
            ms.append(1e3 * (time.perf_counter() - t))
        out[name] = [min(ms), max(ms)]
    out["cpus"] = len(os.sched_getaffinity(0))
    return out
