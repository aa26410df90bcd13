"""The greedy device match search and what runs on it: ``_match_search``,
``greedy_tokens`` (greedy and lazy, both accept rules, 4/8/16 sorted
neighbours), ``term_frequencies``, ``_stream_bits``, ``deflate_device``
and ``deflate_shared_trees``, the port's plain PyTorch version against the
JAX package on the same seeded buffers of 8,192 positions (the JAX side
compiles each search once for the file), term by term and byte for
byte.  Terms are uint32 in the JAX package and int32
with the same bits in the port.  Both native libraries are switched off
(``deflate_device`` at level 9 runs the optimal parse)."""

import zlib

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

import swift_png_tpu.native as jax_native
import swift_png_tpu_torch._host.native as torch_native
from swift_png_tpu.ops import deflate as jd
from swift_png_tpu.parallel.batch import (
    deflate_shared_trees as jax_shared_trees)
from swift_png_tpu_torch.ops import deflate as td
from swift_png_tpu_torch.parallel.batch import deflate_shared_trees
from test_torch_encode import payload


N = 8192            # one buffer size, so the JAX side compiles each
#                     (k, lazy, accept rule) once for the whole file
_jax_match_search = jax.jit(jd._match_search, static_argnums=(2, 3))


@pytest.fixture(autouse=True)
def _no_native(monkeypatch):
    """Both native libraries off; one torch thread (the suite runs files
    side by side)."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(torch_native, "available", lambda: False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(kind, n, seed=0):
    """``test_torch_encode.payload``'s kinds, plus ``ones`` (every key the
    sentinel 0xFFFFFFFF) and ``mixed`` (noise, then runs and repeats)."""
    rng = np.random.default_rng(seed)
    if kind == "ones":
        return b"\xff" * n
    if kind == "mixed":
        noise = rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes()
        rest = bytearray(noise)
        while len(rest) < n:
            d = int(rng.integers(1, 4000))
            ln = int(rng.integers(3, 300))
            for _ in range(ln):
                rest.append(rest[max(len(rest) - d, 0)])
            rest += rng.integers(0, 256, 3, dtype=np.uint8).tobytes()
        return bytes(rest[:n])
    return payload(kind, n)[:n]


def _buffers(kind, n, N):
    data = _data(kind, n)
    buf = np.zeros(N, np.uint8)
    buf[:n] = np.frombuffer(data, np.uint8)
    return data, buf


@pytest.mark.parametrize("kind,n", [
    ("noise", 3000), ("rows", 8189), ("rle", 5000), ("text", 8000),
    ("ones", 4000), ("mixed", 7000)])
@pytest.mark.parametrize("k", [4, 16])
def test_match_search_matches_jax(kind, n, k):
    _, buf = _buffers(kind, n, N)
    jr, jdist = _jax_match_search(jnp.asarray(buf), jnp.int32(n), k, 31)
    tr, tdist = td._match_search(torch.from_numpy(buf), n, k, 31)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))


# (k, lazy) as ``deflate_device`` picks them at levels 0–2, 3, 4–5 and
# 6–7, so that its tests below reuse these compiled searches
@pytest.mark.parametrize("k,lazy", [(4, False), (8, False), (8, True),
                                    (16, True)])
@pytest.mark.parametrize("short_far", [0, 1024])
@pytest.mark.parametrize("kind", ["mixed", "text", "noise"])
def test_greedy_tokens_match_jax(kind, k, short_far, lazy):
    n = {"mixed": 7000, "text": 4000, "noise": 8000}[kind]
    _, buf = _buffers(kind, n, N)
    mr = 4 if short_far else 6
    jt, jv, jc = jd.greedy_tokens(jnp.asarray(buf), jnp.int32(n), k=k,
                                  t_cap=N, lazy=lazy, min_run=mr,
                                  short_far=short_far)
    tt, tv, tc = td.greedy_tokens(torch.from_numpy(buf), n, k=k, t_cap=N,
                                  lazy=lazy, min_run=mr, short_far=short_far)
    assert tc == int(jc)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).view(np.int32))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jf = jd.term_frequencies(np.asarray(jt), np.asarray(jv))
    tf = td.term_frequencies(tt.numpy(), tv.numpy())
    np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("n", [N, 1, 5])
def test_greedy_tokens_at_the_buffer_end_match_jax(n):
    """``n == N`` (no padding: past-the-end targets stay fixed points) and
    streams too short for any key."""
    _, buf = _buffers("rle", n, N)
    for lazy in (False, True):
        jt, jv, jc = jd.greedy_tokens(jnp.asarray(buf), jnp.int32(n),
                                      t_cap=N, lazy=lazy)
        tt, tv, tc = td.greedy_tokens(torch.from_numpy(buf), n, t_cap=N,
                                      lazy=lazy)
        assert tc == int(jc)
        np.testing.assert_array_equal(tt.numpy(),
                                      np.asarray(jt).view(np.int32))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("kind", ["mixed", "text", "noise"])
def test_stream_bits_match_jax(kind):
    _, buf = _buffers(kind, 6000, N)
    tt, tv, _ = td.greedy_tokens(torch.from_numpy(buf), 6000, t_cap=N,
                                 lazy=True)
    terms, valid = tt.numpy(), tv.numpy()
    from swift_png_tpu_torch._host.lz77.huffman import (
        lengths_from_frequencies)
    f = td.term_frequencies(terms, valid)
    ll = lengths_from_frequencies(f[:286], 15, force=True)
    dl = lengths_from_frequencies(f[288:318], 15, force=False)
    assert td._stream_bits(terms, valid, ll, dl) == jd._stream_bits(
        terms.view(np.uint32), valid, ll, dl)


@pytest.mark.parametrize("level", [1, 3, 5, 7])
@pytest.mark.parametrize("kind,n", [("mixed", 7000), ("text", 5000),
                                    ("rows", 8000)])
def test_deflate_device_matches_jax(kind, n, level):
    """Buffers of N = 8,192: the JAX search compiles as in the tests
    above."""
    data = _data(kind, n)
    got = td.deflate_device(data, level, device="cpu")
    assert got == jd.deflate_device(data, level)
    assert zlib.decompress(got) == data


@pytest.mark.parametrize("data", [b"", b"ab", b"abc"],
                         ids=["empty", "two", "three"])
def test_deflate_device_short_streams_match_jax(data):
    got = td.deflate_device(data, 1, device="cpu")
    assert got == jd.deflate_device(data, 1)
    assert zlib.decompress(got) == data


def test_deflate_device_level_9_matches_jax():
    data = _data("rows", 5000)
    got = td.deflate_device(data, 9, device="cpu")
    assert got == jd.deflate_device(data, 9)
    assert zlib.decompress(got) == data


@pytest.mark.parametrize("level", [1, 4, 6])
def test_deflate_shared_trees_matches_jax(level):
    """Three streams pooled into one tree set (buffers of N = 8,192)."""
    datas = [_data("mixed", 7000, 1), _data("text", 5000),
             _data("mixed", 4500, 2)]
    got = deflate_shared_trees(datas, level, device="cpu")
    assert got == jax_shared_trees(datas, level)
    assert [zlib.decompress(s) for s in got] == datas


def test_emit_pack_shared_matches_per_stream_packing():
    """One K6 launch over the batch gives each stream the bits that
    packing it alone against the same trees gives."""
    datas = [_data("mixed", 7000, 3), _data("rle", 2000)]
    toks = []
    for d in datas:
        buf = torch.zeros(N, dtype=torch.uint8)
        buf[:len(d)] = torch.frombuffer(bytearray(d), dtype=torch.uint8)
        t, _, c = td.greedy_tokens(buf, len(d), t_cap=N)
        toks.append((t, c))
    from swift_png_tpu_torch.parallel.batch import shared_tree
    tree, freq = shared_tree(toks)
    both = td.emit_pack_shared([t for t, _ in toks], [c for _, c in toks],
                               tree, freq)
    alone = [td.emit_pack_shared([t], [c], tree, freq)[0] for t, c in toks]
    assert both == alone
