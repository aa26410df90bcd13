#!/usr/bin/env python3
"""Run one cell of the benchmark of ``swift_png_tpu_torch`` once, from the
root of a checkout, on the card it is started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result, one JSON object.  See
``harness/cli.py`` for the exit codes and ``BENCHMARK.json`` for the cells.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]
# the port builds inside the checkout (swift_png_tpu_torch/_build); any
# Triton or extension cache that torch opens goes there too, at a fixed path
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "benchmark_cache" / sub)

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
