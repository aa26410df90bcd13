"""The port's module paths and its copies of the JAX package's examples.

* Every ``.py`` file of ``swift_png_tpu/`` (found on disk, not by import)
  has a dotted counterpart in the port, or an entry in the explicit tables
  below.  For ``png``, ``lz77`` and ``models`` every public name of the
  JAX module is in the port's, and each public submodule path is the same
  module object as its ``_host`` copy; so are ``native`` and
  ``utils.bits``.
* Each of the 11 examples runs in process through the port's
  ``swift_png_tpu_torch.examples.<name>.main`` on a 96×128 rgba8 PNG made
  here from a seed.  The nine host examples also run through the JAX
  example's ``main`` (``runpy.run_path`` of ``examples/<name>.py``), each
  package in a directory of its own with the same relative paths: the
  printed lines (the port's package name read as the JAX package's) and
  every file written must be equal.  The two device examples run with
  ``device="cpu"``; their pixels must equal the JAX package's
  ``Image.decompress_bytes(…).unpack_rgba8()`` of the same files.

Both packages' native libraries are on.
"""

import __future__

import functools
import importlib
import inspect
import io
import os
import runpy
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import swift_png_tpu.native as jax_native
import swift_png_tpu_torch._host.native as torch_native
from swift_png_tpu import png as jpng
from swift_png_tpu_torch import png as tpng
from swift_png_tpu_torch.parallel.distributed import shutdown

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "swift_png_tpu")

# ---- module paths ----------------------------------------------------------

#: JAX modules the port serves under another name
RENAMED = {"ops.inflate_pallas": "ops.inflate_stamp",
           "ops.unfilter_pallas": "ops.unfilter"}
#: JAX modules not ported, each with the words of ROADMAP's "Not to port"
NOT_PORTED = {"ops.inflate": "`ops/inflate.py::inflate_blocks`"}
#: public paths served by a ``_host`` module (besides png, lz77, models)
HOST_ALIASES = {"native": "native", "utils.bits": "bits"}


def _jax_module_names() -> list[str]:
    """Dotted names, relative to the package, of every ``.py`` file under
    ``swift_png_tpu/`` (``""`` for the package itself)."""
    names = []
    for root, dirs, files in os.walk(JAX_ROOT):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f[:-3]), JAX_ROOT)
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            names.append(".".join(parts))
    return names


def _public(module) -> set[str]:
    """``__all__`` and every other name of ``module`` not starting with
    ``_``, less what it imports from outside its package (``np``, ``os``,
    ``dataclass``, ``annotations``)."""
    pkg = module.__name__.split(".")[0]
    names = set(getattr(module, "__all__", ()))
    for name, value in vars(module).items():
        if name.startswith("_") or value is __future__.annotations:
            continue
        if inspect.ismodule(value):
            if value.__name__.startswith(pkg + "."):
                names.add(name)
            continue
        if ((inspect.isclass(value) or inspect.isroutine(value))
                and not (getattr(value, "__module__", None) or ""
                         ).startswith(pkg)):
            continue
        names.add(name)
    return names


def _roadmap_not_to_port() -> str:
    text = open(os.path.join(REPO, "ROADMAP.md"), encoding="utf-8").read()
    start = text.index("Not to port:")
    return text[start:text.index("\n### ", start)]


JAX_MODULES = _jax_module_names()


def test_the_walk_finds_the_jax_package():
    assert {"", "png.format", "lz77.gzip", "native.build", "utils.bits",
            "ops.inflate_pallas", "parallel.distributed"} <= set(JAX_MODULES)


@pytest.mark.parametrize("name", JAX_MODULES, ids=lambda n: n or "package")
def test_module_path_served_by_the_port(name):
    if name in NOT_PORTED:
        assert NOT_PORTED[name] in _roadmap_not_to_port()
        return
    target = RENAMED.get(name, name)
    port = importlib.import_module(
        "swift_png_tpu_torch" + (f".{target}" if target else ""))
    top, _, sub = name.partition(".")
    if top in ("png", "lz77", "models"):
        jax_module = importlib.import_module(f"swift_png_tpu.{name}")
        missing = _public(jax_module) - set(dir(port))
        assert not missing, f"{name}: not in the port: {sorted(missing)}"
        if sub:
            assert port is sys.modules[f"swift_png_tpu_torch._host.{name}"]
    if name in HOST_ALIASES:
        assert port is importlib.import_module(
            f"swift_png_tpu_torch._host.{HOST_ALIASES[name]}")


def test_top_level_names():
    import swift_png_tpu
    import swift_png_tpu_torch

    assert swift_png_tpu_torch.__version__ == swift_png_tpu.__version__
    assert swift_png_tpu_torch.png is tpng
    assert swift_png_tpu_torch.lz77 is importlib.import_module(
        "swift_png_tpu_torch.lz77")
    assert swift_png_tpu_torch.native is torch_native
    from swift_png_tpu_torch.utils.bits import BitWriter, reverse_bits

    assert reverse_bits(0b1101, 4) == 0b1011
    assert BitWriter is importlib.import_module(
        "swift_png_tpu_torch._host.bits").BitWriter


def test_lz77_stats_printout_as_jax(monkeypatch, capsys):
    """``DUMP_STATS`` (``SPT_DUMP_LZ77_STATS=1``) prints the same token
    statistics from both packages' ``Inflator`` at checksum time."""
    import zlib

    from swift_png_tpu.lz77 import inflate as jinflate
    from swift_png_tpu_torch.lz77 import inflate as tinflate

    rng = np.random.default_rng(7)
    data = bytes(np.repeat(rng.integers(0, 256, 3000, dtype=np.uint8),
                           rng.integers(1, 9, 3000)))
    stream = zlib.compress(data, 6)
    printed = []
    for module in (jinflate, tinflate):
        monkeypatch.setattr(module, "DUMP_STATS", True)
        inflator = module.Inflator()
        for at in range(0, len(stream), 1000):
            inflator.push(stream[at:at + 1000])
        assert bytes(inflator.pull()) == data
        printed.append(capsys.readouterr().out)
    assert "[lz77] blocks=" in printed[0] and printed[1] == printed[0]


# ---- the examples ----------------------------------------------------------

HOST_EXAMPLES = {
    "basic_encoding": [["out"]],
    "custom_color": [["in.png"]],
    "decode_basic": [["in.png"]],
    "gzip_tool": [["c", "in.png", "in.png.gz"], ["d", "in.png.gz", "back"]],
    "image_metadata": [["in.png", "metadata.png"]],
    "indexing": [["in.png", "indexed.png"]],
    "iphone_optimized": [["in.png", "ios"]],
    "online_decoding": [["in.png"]],
    "streaming_zlib": [["in.png"]],
}
DEVICE_EXAMPLES = ["indexed_decode", "batch_decode_cuda"]
#: the one fixed output path of the JAX examples (``custom_color.py``),
#: written into each package's directory instead
FIXED_OUT = "/tmp/spt_value_plane.png"
MODES = ("c", "d")     # gzip_tool's first argument; every other is a path


def _rgba8_png(seed: int, h: int = 96, w: int = 128) -> bytes:
    """A gradient with noise and a varying alpha, as an rgba8 PNG."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([x * 2, y * 2, (x + y + seed * 40) % 256,
                   255 - (x // 4)], -1)
    px = (px + rng.integers(0, 24, px.shape)).clip(0, 255).astype(np.uint8)
    return jpng.Image.pack(px, jpng.Layout(jpng.Format("rgba8", ()), False)
                           ).compress_bytes(level=6)


@pytest.fixture
def native():
    if not (jax_native.available() and torch_native.available()):
        pytest.fail("a native library did not build")


def _run(main, calls, folder, printed: io.StringIO) -> tuple[str, dict]:
    """Run ``main(*args)`` for each of ``calls``, its paths in ``folder``;
    return what it printed, with ``folder`` cut from the paths, and
    ``{file: bytes}`` of the folder afterwards."""
    for args in calls:
        main(*[a if a in MODES else str(folder / a) for a in args])
    files = {f: (folder / f).read_bytes() for f in sorted(os.listdir(folder))}
    return printed.getvalue().replace(f"{folder}{os.sep}", ""), files


@pytest.mark.parametrize("name", sorted(HOST_EXAMPLES) + DEVICE_EXAMPLES)
def test_example_runs_on_the_port(name, native, tmp_path, monkeypatch):
    example = importlib.import_module(f"swift_png_tpu_torch.examples.{name}")
    if name == "indexed_decode":
        files, pixels = example.main(device="cpu")
        want = [jpng.Image.decompress_bytes(f).unpack_rgba8() for f in files]
        np.testing.assert_array_equal(pixels, np.stack(want))
        return
    if name == "batch_decode_cuda":
        blobs = [_rgba8_png(s) for s in range(3)] + [_rgba8_png(3, 40, 24)]
        paths = []
        for i, blob in enumerate(blobs):
            paths.append(str(tmp_path / f"{i}.png"))
            open(paths[-1], "wb").write(blob)
        assert not torch.distributed.is_initialized()
        try:
            got = example.main(paths, device="cpu")
        finally:
            shutdown()
        assert len(got) == len(blobs)
        for g, blob in zip(got, blobs):
            np.testing.assert_array_equal(
                g, jpng.Image.decompress_bytes(blob).unpack_rgba8())
        return
    # each package in a thread of its own, in a folder of its own, its
    # prints captured by a ``print`` in the example's globals: the native
    # deflate releases the interpreter lock, so the two level-13 encodes
    # of ``basic_encoding`` (about 25 s each on the native library) overlap
    mains, folders = {}, {}
    for pkg in ("jax", "torch"):
        folders[pkg] = tmp_path / pkg
        folders[pkg].mkdir()
        (folders[pkg] / "in.png").write_bytes(_rgba8_png(16))
    printed = {pkg: io.StringIO() for pkg in folders}
    mains["jax"] = runpy.run_path(
        os.path.join(REPO, "examples", f"{name}.py"), init_globals={
            "print": functools.partial(print, file=printed["jax"])})["main"]
    monkeypatch.setattr(example, "print", functools.partial(
        print, file=printed["torch"]), raising=False)
    mains["torch"] = example.main
    for pkg, cls in (("jax", jpng.Image), ("torch", tpng.Image)):
        monkeypatch.setattr(cls, "compress_path", functools.partialmethod(
            _redirected, cls.compress_path, str(folders[pkg] / "value.png")))
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(_run, mains["jax"], HOST_EXAMPLES[name],
                              folders["jax"], printed["jax"])
        torch_text, torch_files = _run(mains["torch"], HOST_EXAMPLES[name],
                                       folders["torch"], printed["torch"])
        jax_text, jax_files = jax_run.result()
    assert torch_text.replace("swift_png_tpu_torch", "swift_png_tpu") \
        == jax_text
    assert jax_text and "in.png" in jax_files
    assert sorted(torch_files) == sorted(jax_files)
    for f, data in jax_files.items():
        assert torch_files[f] == data, f


def _redirected(self, compress_path, fixed_to, path, *args, **kwargs):
    """``Image.compress_path`` with the JAX example's fixed output path
    sent to ``fixed_to``."""
    return compress_path(self, fixed_to if path == FIXED_OUT else path,
                         *args, **kwargs)
