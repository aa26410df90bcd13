"""The port's batched indexed decode end to end against the JAX package's
``decode_indexed(backend="pallas")`` (Pallas kernels in interpret mode):
the same PNG bytes, exact pixel equality.  Also the inputs both decline,
the port's isolation from JAX, and its refusal to run without a device."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

from swift_png_tpu import png
from swift_png_tpu.parallel.batch import decode_indexed as jax_decode_indexed
from swift_png_tpu.png.format import Format, Layout
from swift_png_tpu_torch import decode_indexed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 16
PITCH = 96   # every case has 16 rows of 1 + 96 bytes: one inflate shape


def _image(kind, seed):
    """``(pixels, Layout)`` for one test image of ``kind``."""
    rng = np.random.default_rng(seed)
    if kind == "rgba8":
        px = rng.integers(0, 256, (H, 24, 4), dtype=np.uint8)
        return px, Layout(Format("rgba8", ()), False)
    if kind in ("rgb8", "rgb8_key"):
        px = rng.integers(0, 256, (H, 32, 4), dtype=np.uint8)
        px[..., 3] = 255
        key = None
        if kind == "rgb8_key":
            px[::3, ::5, :3] = (10, 20, 30)   # the keyed color occurs
            key = (10, 20, 30)
        return px, Layout(Format("rgb8", (), key=key), False)
    if kind in ("v8", "v1"):
        w = 96 if kind == "v8" else 768
        v = rng.integers(0, 256, (H, w), dtype=np.uint8)
        if kind == "v1":
            v = np.where(v >= 128, 255, 0).astype(np.uint8)
        px = np.stack([v, v, v, np.full_like(v, 255)], axis=-1)
        return px, Layout(Format(kind, ()), False)
    if kind == "va16":
        v = rng.integers(0, 1 << 16, (H, 24), dtype=np.uint16)
        a = rng.integers(0, 1 << 16, (H, 24), dtype=np.uint16)
        return (np.stack([v, v, v, a], axis=-1),
                Layout(Format("va16", ()), False))
    if kind == "rgba16":
        px = rng.integers(0, 1 << 16, (H, 12, 4), dtype=np.uint16)
        return px, Layout(Format("rgba16", ()), False)
    if kind == "indexed4":
        # per-image palettes with tRNS alphas on the first entries
        pal = tuple((int(r), int(g), int(b), int(a)) for r, g, b, a in zip(
            *rng.integers(0, 256, (3, 16)), [0, 64, 128] + [255] * 13))
        idx = rng.integers(0, 16, H * 192)
        px = np.array([pal[i] for i in idx], np.uint8).reshape(H, 192, 4)
        return px, Layout(Format("indexed4", pal), False)
    raise ValueError(kind)


def _pngs(kind, n=2, index=True, **kw):
    out = []
    for seed in range(n):
        px, layout = _image(kind, seed)
        out.append(png.Image.pack(px, layout).compress_bytes(
            level=6, index=index, **kw))
    return out


CASES = [("rgba8", 8), ("rgb8", 8), ("v8", 8), ("va16", 8), ("v1", 8),
         ("indexed4", 8), ("rgb8_key", 8), ("rgba16", 16), ("v8", 16)]


@pytest.mark.parametrize("kind,bits", CASES,
                         ids=[f"{k}-{b}" for k, b in CASES])
def test_decode_indexed_matches_jax(kind, bits):
    pngs = _pngs(kind)
    want = jax_decode_indexed(pngs, backend="pallas", bits=bits)
    got = decode_indexed(pngs, bits=bits, device="cpu")
    assert want is not None and got is not None
    want = np.asarray(want)
    assert got.device.type == "cpu"
    assert got.dtype == (torch.uint8 if bits == 8 else torch.uint16)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "rgb8_key":
        assert (want[..., 3] == 0).any() and (want[..., 3] != 0).any()


def _declined():
    mixed = _pngs("rgba8", n=1) + [
        png.Image.pack(np.zeros((8, 8, 4), np.uint8),
                       Layout(Format("rgba8", ()), False))
        .compress_bytes(level=6, index=True)]
    cgbi = [png.Image.pack(_image("rgba8", 0)[0],
                           Layout(Format("bgra8", ()), False))
            .compress_bytes(level=6, index=True)]
    interlaced = [png.Image.pack(_image("rgba8", 0)[0],
                                 Layout(Format("rgba8", ()), True))
                  .compress_bytes(level=6, index=True)]
    return {"no_index": _pngs("rgba8", index=False), "mixed_shapes": mixed,
            "cgbi": cgbi, "interlaced": interlaced}


@pytest.mark.parametrize("case", ["no_index", "mixed_shapes", "cgbi",
                                  "interlaced"])
def test_decode_indexed_declines_what_jax_declines(case):
    pngs = _declined()[case]
    assert jax_decode_indexed(pngs, backend="pallas") is None
    assert decode_indexed(pngs, device="cpu") is None


_ISOLATED = r"""
import importlib, pkgutil, sys, zlib
sys.modules["jax"] = None            # any import of these now fails
sys.modules["swift_png_tpu"] = None
import numpy as np
import swift_png_tpu_torch
for m in pkgutil.walk_packages(swift_png_tpu_torch.__path__,
                               "swift_png_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from swift_png_tpu_torch._host.lz77.index import build_index
chip_smoke.H, chip_smoke.W = 8, 8
px = chip_smoke.bench_image(0)
f = chip_smoke.filter_rows(px.reshape(8, 32), 4)
s = zlib.compress(f.tobytes(), 6)
blob = chip_smoke.make_png(s, build_index(s[2:-4], f.size, 64).serialize())
out = swift_png_tpu_torch.decode_indexed([blob], device="cpu")
assert np.array_equal(out[0].numpy(), px)
assert not any(k == "jax" or k.startswith("jax.") or
               k.startswith("swift_png_tpu.") for k in sys.modules
               if sys.modules[k] is not None)
print("isolated ok")
"""


def test_port_imports_without_jax_or_the_jax_package():
    r = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    assert "isolated ok" in r.stdout


def test_decode_indexed_without_device_raises_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    pngs = _pngs("rgba8", n=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_indexed(pngs)
