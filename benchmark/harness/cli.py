"""The command line of one run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exit codes: 0 with the result as the last line of standard output; 2
without a CUDA card (or with fewer than the cell asks for); 3 when JAX or
the JAX package is loaded once the window has closed; 1 on any other
failure.  Only the result goes to standard output; the set-up and window
lines and, last, each compared number beside its limit go to standard
error."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "swift_png_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def main(argv: list[str], t_start: float, root: Path) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative whole number")

    from .spec import Spec
    spec = Spec(root)
    chips = spec.workload(args.workload)["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}, "
              f"cards: {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from .cell import run_cell
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
