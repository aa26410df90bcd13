"""The port's host layer against the JAX package's: the checkpoint index
walker, spIx parsing and serialization, and index_from_arrays.  Integer
data throughout, so every comparison is exact."""

import dataclasses
import zlib

import numpy as np
import pytest

import conftest  # noqa: F401

from swift_png_tpu import png
from swift_png_tpu.lz77 import index as jindex
from swift_png_tpu.lz77.deflate import Deflator
from swift_png_tpu.png.format import Format, Layout
from swift_png_tpu_torch._host.lz77 import index as tindex
from swift_png_tpu_torch._host.png import chunk as tchunk

OB = 256
ARRAYS = ("bit_pos", "skip", "n_tokens", "lit_lengths", "dist_lengths",
          "unit_block", "unit_kind", "eob_jump", "gap_off", "gap_len",
          "pair_steps")
SCALARS = ("ob", "out_size", "end_bit", "match_bytes", "match_segs")


def assert_same_index(port, ref):
    for name in SCALARS:
        assert getattr(port, name) == getattr(ref, name), name
    for name in ARRAYS:
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (port.extra_gaps or None) == (ref.extra_gaps or None)


def _payload(n=24_000, seed=0):
    rng = np.random.default_rng(seed)
    y = (np.sin(np.arange(n) / 9.0) * 50 + 128).astype(np.int64)
    return np.clip(y + rng.integers(-6, 7, n), 0, 255).astype(
        np.uint8).tobytes()


def _deflator_multiblock():
    data = np.random.default_rng(3).integers(0, 96, 20_000,
                                             dtype=np.uint8).tobytes()
    d = Deflator(level=4)
    for i in range(0, len(data), 4096):
        d.push(data[i:i + 4096], last=i + 4096 >= len(data))
    return data, d.pull()


def _flush_chain():
    data = np.random.default_rng(4).integers(0, 256, 30_000,
                                             dtype=np.uint8).tobytes()
    co = zlib.compressobj(0)
    out = b""
    for i in range(0, len(data), 7000):
        out += co.compress(data[i:i + 7000]) + co.flush(zlib.Z_FULL_FLUSH)
    return data, out + co.flush()


def _streams():
    cases = []
    for level in (0, 1, 6, 9):
        data = _payload(70_000 if level == 0 else 24_000)
        cases.append((f"zlib{level}", data, zlib.compress(data, level)))
    cases.append(("deflator_multiblock", *_deflator_multiblock()))
    cases.append(("stored_flush_chain", *_flush_chain()))
    return cases


@pytest.mark.parametrize("name,data,stream", _streams(),
                         ids=[c[0] for c in _streams()])
def test_build_index_matches_jax_host_walker(name, data, stream):
    body = stream[2:-4]
    ref = jindex._build_index_host(body, len(data), OB)
    port = tindex.build_index(body, len(data), OB)
    assert ref is not None and port is not None, name
    assert_same_index(port, ref)
    assert port.serialize() == ref.serialize()
    if name == "deflator_multiblock":
        assert port.multiblock and port.n_blocks > 1
    if name.startswith("stored") or name == "zlib0":
        assert port.unit_kind.any()


def _spix_of(png_bytes: bytes) -> bytes:
    src = tchunk.ByteSource(png_bytes)
    src.signature()
    kind = None
    while kind != tchunk.IEND:
        kind, payload = src.chunk()
        if kind == tchunk.spIx:
            return payload
    raise AssertionError("no spIx chunk")


@pytest.mark.parametrize("kind", ["rgba8", "v8"])
def test_spix_from_jax_encoder_parses_to_equal_arrays(kind):
    rng = np.random.default_rng(11)
    H, W = 24, 20
    px = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    if kind == "v8":
        px[..., 1] = px[..., 2] = px[..., 0]
    px[..., 3] = 255
    blob = png.Image.pack(px, Layout(Format(kind, ()), False)) \
        .compress_bytes(level=6, index=True)
    payload = _spix_of(blob)
    ref = jindex.CheckpointIndex.parse(payload)
    port = tindex.CheckpointIndex.parse(payload)
    assert_same_index(port, ref)
    assert port.serialize() == payload


def test_spix_v5_extra_gaps_parse_equal():
    data, _ = _flush_chain()
    co = zlib.compressobj(0)
    out = b""
    for i in range(0, len(data), 100):       # blocks << ob: multi-gap units
        out += co.compress(data[i:i + 100]) + co.flush(zlib.Z_FULL_FLUSH)
    out += co.flush()
    ref = jindex._build_index_host(out[2:-4], len(data), OB)
    assert ref is not None and ref.extra_gaps
    blob = ref.serialize()
    assert blob[0] == 5
    assert_same_index(tindex.CheckpointIndex.parse(blob),
                      jindex.CheckpointIndex.parse(blob))


def test_index_from_arrays_round_trips():
    data, stream = _deflator_multiblock()
    ref = jindex._build_index_host(stream[2:-4], len(data), OB)
    fields = {f.name: getattr(ref, f.name)
              for f in dataclasses.fields(jindex.CheckpointIndex)}
    port = tindex.index_from_arrays(fields)
    assert_same_index(port, ref)
    assert port.serialize() == ref.serialize()
    back = tindex.index_from_arrays(
        {f.name: getattr(port, f.name)
         for f in dataclasses.fields(tindex.CheckpointIndex)})
    assert back.serialize() == ref.serialize()
    with pytest.raises(ValueError):
        tindex.index_from_arrays({**fields, "bogus": 1})


@pytest.mark.parametrize("ob", [32, 100])
def test_parse_rejects_unit_sizes_jax_rejects(ob):
    data = _payload(4000)
    ix = tindex.build_index(zlib.compress(data, 6)[2:-4], len(data), 256)
    blob = bytearray(ix.serialize())
    blob[1:5] = ob.to_bytes(4, "big")
    with pytest.raises(ValueError):
        jindex.CheckpointIndex.parse(bytes(blob))
    with pytest.raises(ValueError):
        tindex.CheckpointIndex.parse(bytes(blob))
