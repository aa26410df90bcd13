"""Nothing the benchmark runs imports JAX or the JAX package, the
reference imports nothing of the port, and a run without a card or without
the program fails with nothing on standard output."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "swift_png_tpu"}
REFERENCE = ["harness/reference.py", "harness/corpus.py", "harness/stats.py",
             "content/photo.py", "control.py"]


def imported(path) -> set:
    """Top-level names (before the first dot) of every module ``path``
    imports, by ``import`` or ``from ... import``, at any depth."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources():
    return sorted(p for p in BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("rel", REFERENCE)
def test_reference_imports_nothing_of_the_port(rel):
    names = imported(BENCH / rel)
    assert "swift_png_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_hook_targets_name_the_port_only(spec):
    for m in spec.data["per_layer"] + spec.data["end_to_end"]:
        for targets in getattr(spec.reader(m["name"]), "SPANS", {}).values():
            for t in targets:
                assert t.split(":")[0].split(".")[0] == "swift_png_tpu_torch"


@pytest.mark.parametrize("mods, found", [
    (["swift_png_tpu_torch", "swift_png_tpu_torch.ops.deflate"], []),
    (["jaxtyping", "flaxen", "swift_png_tpu2"], []),
    (["jax", "jax.numpy"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["swift_png_tpu.ops", "swift_png_tpu_torch"], ["swift_png_tpu.ops"]),
    (["flax.linen"], ["flax.linen"]),
])
def test_forbidden_modules_compares_whole_top_level_names(monkeypatch, mods,
                                                          found):
    from harness import cli
    fake = {m: object() for m in mods}
    monkeypatch.setattr(sys, "modules", fake)
    assert cli.forbidden_modules() == sorted(found)


def run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "photo512_rgba8.decode_indexed", "--seed", str(2**31 + 11),
         "--seconds", "1", "--trace", "0", *extra], cwd=cwd,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    r = run(ROOT)
    assert r.returncode != 0
    assert r.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run(tmp_path)
    assert r.returncode != 0
    assert r.stdout == ""
    assert json.load(open(tmp_path / "BENCHMARK.json"))["paths"] == [
        "benchmark"]
