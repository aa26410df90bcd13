"""On the card: one short run of every cell through the command line, with
and without the trace, ends correct with its metrics.  Run there with
``python -m pytest -m cuda benchmark/tests/test_bench_cuda.py``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

DATA = json.load(open(ROOT / "BENCHMARK.json"))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in DATA["workloads"]])
def test_cell_on_the_card(card, spec, workload, traced):
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 17), "--seconds", "2", "--trace",
         str(traced)], cwd=ROOT, capture_output=True, text=True,
        timeout=360)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    want = {m["name"] for m in spec.metrics(workload, bool(traced))}
    assert set(out["metrics"]) == want
    if traced:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
