"""The port's host ``Deflator`` (``_host/lz77/deflate.py``) against
``swift_png_tpu.lz77.Deflator`` level by level, on the same seeded
payloads: every zlib and iOS stream byte for byte, pushed whole or in
pieces, and inflating back through ``zlib``.  The full strategy (levels
8–13) is a pure-Python minimum-cost parse, so its payloads stay at a few
hundred bytes."""

import zlib

import numpy as np
import pytest

from swift_png_tpu.lz77 import deflate as jdeflate
from swift_png_tpu_torch._host.lz77 import deflate as tdeflate


def _payloads(n):
    rng = np.random.default_rng(n)
    row = rng.integers(0, 256, 37, dtype=np.uint8)
    return {
        "text": (b"a deflate stream of text, of text and of more text. "
                 * (n // 50 + 1))[:n],
        "noise": rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
        "rows": (np.tile(row, n // 37 + 1)[:n]
                 + (np.arange(n) // 111 % 3)).astype(np.uint8).tobytes(),
        "small_alphabet": rng.integers(0, 4, n, dtype=np.uint8).tobytes(),
    }


def _both(data, level, fmt="zlib", pieces=None, **kw):
    out = []
    for mod in (tdeflate, jdeflate):
        d = mod.Deflator(fmt, level, **kw)
        parts = pieces or [data]
        chunks = []
        for i, p in enumerate(parts):
            d.push(p, last=i == len(parts) - 1)
            chunks.append(d.pull())
        out.append(chunks)
    return out


@pytest.mark.parametrize("level", range(14))
def test_deflator_matches_jax_at_every_level(level):
    n = 400 if level >= 8 else 6000
    for name, data in _payloads(n).items():
        got, want = _both(data, level)
        assert got == want, name
        assert zlib.decompress(b"".join(got)) == data


@pytest.mark.parametrize("data", [b"", b"x", b"xy", b"xyz", b"xyzw"],
                         ids=["0", "1", "2", "3", "4"])
@pytest.mark.parametrize("level", [0, 6, 9])
def test_deflator_short_inputs_match_jax(data, level):
    got, want = _both(data, level)
    assert got == want
    assert zlib.decompress(b"".join(got)) == data


@pytest.mark.parametrize("level", [1, 5, 8])
def test_deflator_in_pieces_matches_jax(level):
    """Pushes above and below the 4,096-byte flush, and past the window
    that releases input (levels <= 7)."""
    n = 2000 if level >= 8 else 150_000
    data = _payloads(n)["rows"]
    cuts = ([0, 100, 5000, 5001, 110_000, 140_000, n] if level < 8
            else [0, 300, 1000, 1999, n])
    pieces = [data[a:b] for a, b in zip(cuts, cuts[1:])]
    got, want = _both(data, level, pieces=pieces)
    assert got == want
    assert zlib.decompress(b"".join(got)) == data


@pytest.mark.parametrize("exponent", [8, 11, 15])
def test_deflator_window_exponents_match_jax(exponent):
    data = _payloads(9000)["small_alphabet"]
    got, want = _both(data, 4, exponent=exponent)
    assert got == want
    assert b"".join(got)[0] == (exponent - 8) << 4 | 0x08
    assert zlib.decompress(b"".join(got)) == data


@pytest.mark.parametrize("level", [2, 9])
def test_deflator_ios_format_matches_jax(level):
    data = _payloads(300)["text"]
    got, want = _both(data, level, fmt="ios")
    assert got == want
    assert zlib.decompressobj(-15).decompress(b"".join(got)) == data


def test_deflator_pop_and_bad_arguments_match_jax():
    for mod in (tdeflate, jdeflate):
        d = mod.Deflator("zlib", 1, hint=64)
        d.push(b"q" * 5000)
        assert d.pop() is None           # under 4,096 held back
        d.push(b"r" * 100, last=True)
        assert len(d.pop()) > 0 and d.pop() is None
        with pytest.raises(ValueError):
            mod.Deflator("gzip")
        with pytest.raises(ValueError):
            mod.Deflator("zlib", exponent=16)


def test_depths_generalize_matches_jax():
    rng = np.random.default_rng(2)
    lit = rng.integers(0, 12, 286)
    dist = rng.integers(0, 9, 30)
    mine, theirs = tdeflate.Depths(), jdeflate.Depths()
    for d in (mine, theirs):
        d.update(lit, dist)
        d.generalize()
    np.testing.assert_array_equal(mine.storage, theirs.storage)
