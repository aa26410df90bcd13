#!/usr/bin/env python3
"""The control of the check that decides ``correct``: the reference put in
the program's place with the configuration's guarantee, exact samples,
broken (each 8-bit sample's lowest bit cleared, a 7-bit codec), judged by
the same check at the cell's own size.  It must come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed with the compared numbers.  The benchmark's
own runs never run it.  It needs no card: the control is plain numpy and
``zlib``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from harness import corpus  # noqa: E402
from harness.spec import Spec  # noqa: E402


def control_answer(op_name: str, pixels: np.ndarray, cfg: dict):
    """What the control returns for one call: decoded pixels, or PNG files
    written by the reference writer at zlib level 9, both from 7-bit
    samples."""
    lossy = pixels & np.uint8(0xFE)
    if op_name == "encode":
        writer = {**cfg["writer"], "zlib_level": 9}
        return corpus.make_files(lossy, writer)
    return lossy


def control_checks(spec: Spec, workload: str, seed: int,
                   overrides: dict | None = None) -> dict:
    """The cell's compared numbers with the control in the program's
    place, on the inputs of ``seed``."""
    overrides = overrides or {}
    cell = spec.workload(workload)
    cfg = {**spec.config(cell["config"]), **overrides.get("config", {})}
    traffic = {**spec.traffic(cell["traffic"]),
               **overrides.get("traffic", {})}
    op = spec.op(traffic["op"])
    pixels = corpus.make_images(spec.content(cfg["content"]), seed,
                                traffic["batch"], cfg["height"],
                                cfg["width"])
    answer = control_answer(traffic["op"], pixels, cfg)
    return op.check([answer], pixels, traffic,
                    np.random.default_rng([seed, 2]))


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = Spec(HERE.parent)
    for seed in args.seeds:
        checks = control_checks(spec, args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": all(v <= 0 for v in checks.values()),
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
