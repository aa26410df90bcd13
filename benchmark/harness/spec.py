"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``benchmark/configs/<name>.json``, a traffic mix
``benchmark/traffic/<name>.json``, a content recipe
``benchmark/content/<name>.py``, an entry ``benchmark/ops/<name>.py`` and a
metric's reader ``benchmark/metrics/<name>.py``; a metric split by a suffix
(``device_idle_pct.decode``) without a file of its own is read by its
family's (``device_idle_pct.py``).  Adding any of them needs a new file and
a new entry in ``BENCHMARK.json``, and no edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


class Spec:
    """The parsed ``BENCHMARK.json`` of a checkout, and the lookups by
    name into the benchmark's folder ``bench_dir``."""

    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)
        self._modules: dict = {}

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def content(self, name: str):
        return self._module("content", name)

    def op(self, name: str):
        return self._module("ops", name)

    def reader(self, metric: str):
        """The reader of ``metric``: its own file, or else the file of the
        name before its last ``.``."""
        if (not (self.dir / "metrics" / f"{metric}.py").is_file()
                and "." in metric):
            return self._module("metrics", metric.rsplit(".", 1)[0])
        return self._module("metrics", metric)

    def metrics(self, workload: str, traced: bool) -> list:
        """The cell's metric entries: its ``end_to_end`` ones untraced, its
        ``per_layer`` ones traced (a metric without ``workloads`` is every
        cell's)."""
        group = self.data["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]

    def _json(self, kind: str, name: str) -> dict:
        self._check(name)
        with open(self.dir / kind / f"{name}.json") as f:
            return json.load(f)

    def _module(self, kind: str, name: str):
        self._check(name)
        key = (kind, name)
        if key not in self._modules:
            path = self.dir / kind / f"{name}.py"
            mod_name = f"bench_{kind}_{name}".replace(".", "_").replace(
                "-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            if spec is None or not path.is_file():
                raise FileNotFoundError(path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    @staticmethod
    def _check(name: str) -> None:
        if not NAME.match(name):
            raise ValueError(f"not a benchmark name: {name!r}")
