"""The port's gzip and sequential deflate (``swift_png_tpu_torch.lz77``)
against the JAX package's ``swift_png_tpu.lz77``: ``archive`` bytes at
levels 0–9; ``extract`` of members written by Python's ``gzip`` module
(with FEXTRA, FNAME and FCOMMENT) and Python's ``gzip`` reading the port's
members; ``GzipInflator`` fed byte by byte; header and CRC errors with the
same class and ``case``; ``NativeDeflator`` and ``make_deflator`` output
with the native libraries on and off."""

import gzip as pygzip
import zlib

import numpy as np
import pytest

import conftest  # noqa: F401

import swift_png_tpu.native as jax_native
import swift_png_tpu_torch._host.native as torch_native
from swift_png_tpu.lz77 import deflate as jdeflate
from swift_png_tpu.lz77 import gzip as jgzip
from swift_png_tpu_torch.lz77 import GzipInflator
from swift_png_tpu_torch.lz77 import gzip as tgzip
from swift_png_tpu_torch._host.lz77 import deflate as tdeflate


def _data(n, seed):
    """Text-like bytes: runs of a few symbols with repeats, so every level
    finds matches."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9)))
             for _ in range(40)]
    out = b" ".join(words[i] for i in rng.integers(0, 40, n // 4))
    return out[:n]


@pytest.mark.parametrize("level", range(10))
def test_archive_matches_jax_and_inflates(level):
    data = _data(3000 if level >= 8 else 20_000, level)
    blob = tgzip.archive(data, level=level)
    assert blob == jgzip.archive(data, level=level)
    assert pygzip.decompress(blob) == data
    assert tgzip.extract(blob) == data


def test_archive_of_nothing_and_of_one_byte():
    for data in (b"", b"x"):
        blob = tgzip.archive(data, level=6)
        assert blob == jgzip.archive(data, level=6)
        assert pygzip.decompress(blob) == data


def _member(data, name=None, comment=None, extra=None, mtime=7):
    """A member written by Python's ``gzip`` module, with FNAME, FCOMMENT
    and FEXTRA spliced into its header where asked."""
    blob = pygzip.compress(data, 6, mtime=mtime)
    flags, rest = blob[3], blob[10:]
    fields = b""
    if extra is not None:
        flags |= 0x04
        fields += len(extra).to_bytes(2, "little") + extra
    if name is not None:
        flags |= 0x08
        fields += name + b"\x00"
    if comment is not None:
        flags |= 0x10
        fields += comment + b"\x00"
    return blob[:3] + bytes([flags]) + blob[4:10] + fields + rest


@pytest.mark.parametrize("fields", [{}, {"name": b"a.txt"},
                                    {"comment": b"hello", "name": b"n"},
                                    {"extra": b"AB\x02\x00xy"},
                                    {"extra": b"", "name": b"", "comment":
                                     b"c"}],
                         ids=["bare", "fname", "fname_fcomment", "fextra",
                              "all"])
def test_extract_members_from_python_gzip(fields):
    data = _data(50_000, 1)
    blob = _member(data, **fields)
    assert tgzip.extract(blob) == data
    assert jgzip.extract(blob) == data


@pytest.mark.parametrize("fields", [{}, {"name": b"a.txt", "extra": b"q"}],
                         ids=["bare", "fields"])
def test_gzip_inflator_byte_by_byte(fields):
    data = _data(4000, 2)
    blob = _member(data, **fields)
    inf = GzipInflator()
    out = []
    for i in range(len(blob)):
        inf.push(blob[i:i + 1])
        assert inf.terminal == (i == len(blob) - 1)
        piece = inf.pull(100)
        while piece is not None:
            out.append(piece)
            piece = inf.pull(100)
    out.append(inf.pull())
    assert b"".join(out) == data


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return type(e).__name__, getattr(e, "case", None), str(e)
    return None


def _bad_members():
    good = pygzip.compress(_data(2000, 3), 6, mtime=0)
    crc_off = bytearray(good)
    crc_off[-8] ^= 0xFF
    body = bytearray(good)
    body[12] ^= 0x5A
    return {
        "sigil": b"\x1f\x8c" + good[2:],
        "method": good[:2] + b"\x07" + good[3:],
        "flag_bits": good[:3] + b"\x20" + good[4:],
        "fhcrc": good[:3] + b"\x02" + good[4:],
        "crc": bytes(crc_off),
        "body": bytes(body),
    }


@pytest.mark.parametrize("name", sorted(_bad_members()))
def test_header_and_crc_errors_raise_as_jax(name):
    blob = _bad_members()[name]
    want = _error(lambda: jgzip.extract(blob))
    assert want is not None
    assert _error(lambda: tgzip.extract(blob)) == want


@pytest.fixture(params=["off", "on"])
def native(request, monkeypatch):
    if request.param == "off":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(torch_native, "available", lambda: False)
    elif not (jax_native.available() and torch_native.available()):
        pytest.fail("a native library did not build")
    return request.param


def _drain(d, pieces):
    """Push ``pieces`` (the last one with ``last``) and collect what
    ``pop`` and ``pull`` give, as the single-image encoder does."""
    out = []
    for i, p in enumerate(pieces):
        got = d.pop()
        if got is not None:
            out.append(got)
        d.push(p, last=i == len(pieces) - 1)
    while True:
        got = d.pull()
        if not got:
            return out
        out.append(got)


@pytest.mark.parametrize("fmt", ["zlib", "ios"])
@pytest.mark.parametrize("level", [1, 6, 9])
def test_make_deflator_matches_jax(level, fmt, native):
    data = _data(4000 if level == 9 else 30_000, level)
    pieces = [data[i:i + 5000] for i in range(0, len(data), 5000)]
    for engine in ("auto", "python", "native"):
        if engine == "native" and native == "off":
            continue
        kw = dict(format=fmt, level=level, hint=4096, engine=engine)
        t = tdeflate.make_deflator(**kw)
        j = jdeflate.make_deflator(**kw)
        assert type(t).__name__ == type(j).__name__
        got = _drain(t, pieces)
        assert got == _drain(j, pieces)
        stream = b"".join(got)
        if fmt == "zlib":
            assert zlib.decompress(stream) == data
        else:
            assert zlib.decompress(stream, -15) == data


@pytest.mark.parametrize("exponent", [8, 12, 15])
def test_native_deflator_matches_jax(exponent):
    if not (jax_native.available() and torch_native.available()):
        pytest.fail("a native library did not build")
    data = _data(70_000, exponent)
    t = tdeflate.NativeDeflator("zlib", 9, exponent, hint=10_000)
    j = jdeflate.NativeDeflator("zlib", 9, exponent, hint=10_000)
    got = _drain(t, [data])
    assert got == _drain(j, [data])
    assert all(len(p) <= 10_000 for p in got)
    assert zlib.decompress(b"".join(got)) == data
    for bad in (dict(format="gzip"), dict(exponent=7), dict(exponent=16)):
        kw = {"format": "zlib", "exponent": 15, **bad}
        want = _error(lambda: jdeflate.NativeDeflator(**kw))
        assert _error(lambda: tdeflate.NativeDeflator(**kw)) == want
