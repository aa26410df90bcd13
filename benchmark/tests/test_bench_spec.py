"""BENCHMARK.json keeps to the benchmark's contract: names, units, lengths,
the files it names, and the chip time a full check takes."""

import json
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
DATA = json.load(open(ROOT / "BENCHMARK.json"))
METRICS = DATA["end_to_end"] + DATA["per_layer"]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(DATA) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert DATA["command"] == ["python3", "benchmark/run.py"]
    assert all(PATH.match(p) and ".." not in p for p in DATA["paths"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entry(m):
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if m in DATA["end_to_end"] else {"layer", "moves"}
    assert set(m) <= allowed
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in DATA["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in DATA["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
        moved = next(e for e in DATA["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"
    own = BENCH / "metrics" / f"{m['name']}.py"
    family = BENCH / "metrics" / f"{m['name'].rsplit('.', 1)[0]}.py"
    assert own.is_file() or family.is_file()


def test_names_unique():
    for group in (METRICS, DATA["workloads"], DATA["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("c", DATA["configs"], ids=lambda c: c["name"])
def test_config_entry(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
    assert c["file"].startswith("benchmark/")
    cfg = json.load(open(ROOT / c["file"]))
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert len(c["reduced"]) <= 16
    assert all(NAME.match(k) for k in c["reduced"])
    assert (BENCH / "content" / f"{cfg['content']}.py").is_file()


@pytest.mark.parametrize("w", DATA["workloads"], ids=lambda w: w["name"])
def test_workload_entry(spec, w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and line(w["why"])
    traffic = spec.traffic(w["traffic"])
    assert (BENCH / "ops" / f"{traffic['op']}.py").is_file()
    e2e = [m["name"] for m in spec.metrics(w["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics(w["name"], True)


def test_every_config_used_and_pairs_once():
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in DATA["configs"]} == {p[0] for p in pairs}


def test_four_chip_cells_and_run_seconds_fit_a_check():
    fours = sum(w["chips"] == 4 for w in DATA["workloads"])
    assert fours <= max(1, len(DATA["workloads"]) // 4)
    rs = DATA["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_setup_bound():
    setup = next(m for m in DATA["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


def test_split_metric_falls_back_to_its_familys_reader(spec):
    assert (spec.reader("device_idle_pct.encode")
            is spec.reader("device_idle_pct.decode")
            is spec.reader("device_idle_pct"))
    assert spec.reader("inflate_ms.decode_png") is not spec.reader(
        "inflate_ms.decode_indexed")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.decode")
