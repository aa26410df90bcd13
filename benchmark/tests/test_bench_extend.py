"""A configuration, a traffic mix and a per-layer metric added as new files
and new BENCHMARK.json entries alone are found and run, with no edit of a
file that is there."""

import hashlib
import json
import shutil

import pytest

from conftest import BENCH, ROOT
from harness.cell import run_cell
from harness.spec import Spec


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_alone(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(bench)
    cfg = json.load(open(bench / "configs" / "photo512_rgba8.json"))
    cfg.update(name="tiny_rgba8", width=20, height=9, content="stripes")
    (bench / "configs" / "tiny_rgba8.json").write_text(json.dumps(cfg))
    (bench / "content" / "stripes.py").write_text(
        "import numpy as np\n\n\n"
        "def image(seed, index, height, width):\n"
        "    y, x = np.mgrid[0:height, 0:width]\n"
        "    v = (x * 7 + y * (index + 1) + seed) % 256\n"
        "    return np.stack([v, v, x % 256, 255 + 0 * v],\n"
        "                    -1).astype(np.uint8)\n")
    traffic = json.load(open(bench / "traffic" / "decode_indexed.json"))
    traffic.update(batch=3, check_batches=1)
    (bench / "traffic" / "decode_indexed_b3.json").write_text(
        json.dumps(traffic))
    (bench / "metrics" / "calls_made.py").write_text(
        "def read(run):\n    return run.calls\n")
    data = json.load(open(ROOT / "BENCHMARK.json"))
    data["configs"].append({"name": "tiny_rgba8", "source": cfg["source"],
                            "file": "benchmark/configs/tiny_rgba8.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": "tiny_rgba8.decode_indexed_b3",
                              "config": "tiny_rgba8",
                              "traffic": "decode_indexed_b3", "chips": 1,
                              "why": "a test"})
    for m in data["end_to_end"]:
        if m["name"] == "decode_MBps":
            m["workloads"].append("tiny_rgba8.decode_indexed_b3")
    data["per_layer"].append({"name": "calls_made", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry", "moves": "decode_MBps",
                              "workloads": ["tiny_rgba8.decode_indexed_b3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    spec = Spec(tmp_path, bench)
    for traced in (False, True):
        r = run_cell(spec, "tiny_rgba8.decode_indexed_b3", 2**31 + 3, 0.2,
                     traced, device="cpu", log=lambda **kw: None)
        assert r["correct"]
        names = set(r["metrics"])
        if traced:
            assert r["metrics"]["calls_made"]["value"] == r["attempted"]
        else:
            assert names == {"decode_MBps", "setup_s"}
    after = digest(bench)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("change", [{"loop": "open"}, {"clients": 4},
                                    {"loop": None}, {"clients": None}])
def test_traffic_the_harness_does_not_drive_is_refused(spec, change):
    """A traffic file asking for another loop or more clients than the one
    closed-loop client the harness drives fails before any work."""
    with pytest.raises(ValueError, match="closed-loop"):
        run_cell(spec, "photo512_rgba8.decode_indexed", 1, 0.1, False,
                 device="cpu", overrides={"traffic": change},
                 log=lambda **kw: None)


def test_host_readings():
    from harness import host
    a = host.cpu_seconds()
    sum(range(100_000))
    assert host.cpu_seconds() >= a >= 0
    p = host.probe(repeats=1)
    assert {"loop", "zlib", "sort", "cpus"} <= set(p)
    assert all(0 < p[k][0] <= p[k][1] for k in ("loop", "zlib", "sort"))
