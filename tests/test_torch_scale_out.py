"""The port's scale-out layer in one process, against the JAX package:
the checksum combines, ``segment_tokens`` and ``deflate_segmented``
(term by term and byte for byte), the corpus probe, buckets and
``CorpusDecoder``, and the one-process mesh that ``global_mesh()`` sets
up (gloo).  Inputs are made from seeds with numpy; PNGs are built with
``chip_smoke.py``'s writers.  The multi-process meshes are in
``tests/test_torch_distributed.py``."""

import types
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
import conftest  # noqa: F401

import jax.numpy as jnp

from swift_png_tpu.lz77 import checksums as jax_checksums
from swift_png_tpu.parallel import blocks as jax_blocks
from swift_png_tpu.parallel import corpus as jax_corpus
from swift_png_tpu_torch import BatchCodec
from swift_png_tpu_torch._host.lz77 import checksums
from swift_png_tpu_torch.ops.filter import filter_select_batch
from swift_png_tpu_torch.parallel import blocks, corpus, distributed
from swift_png_tpu_torch.parallel.batch import filter_select_sharded

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs files side by side
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payload(n, seed=0):
    """``n`` bytes: noise, then copies of earlier bytes from seeded
    distances and runs, so that the trees and both search modes differ."""
    rng = np.random.default_rng(seed)
    out = bytearray(rng.integers(0, 256, min(n, 700), dtype=np.uint8))
    while len(out) < n:
        if rng.random() < 0.2:
            out += bytes([int(rng.integers(0, 256))]) * int(
                rng.integers(3, 90))
        else:
            d = int(rng.integers(1, min(len(out), 30_000) + 1))
            ln = int(rng.integers(3, 200))
            for _ in range(ln):
                out.append(out[-d])
        out += rng.integers(0, 256, int(rng.integers(0, 12)),
                            dtype=np.uint8).tobytes()
    return bytes(out[:n])


# ---- the checksum combines -------------------------------------------------

LENGTHS = [0, 1, 7, 5551, 5552, 65520, 65521, 65522, 1 << 20, 123_456_789]


@pytest.mark.parametrize("len_b", LENGTHS)
def test_combines_match_jax(len_b):
    rng = np.random.default_rng(len_b % 1000)
    for _ in range(8):
        a, b = (int(x) for x in rng.integers(0, 1 << 32, 2, dtype=np.uint64))
        assert checksums.adler32_combine(a, b, len_b) == \
            jax_checksums.adler32_combine(a, b, len_b)
        assert checksums.crc32_combine(a, b, len_b) == \
            jax_checksums.crc32_combine(a, b, len_b)


@pytest.mark.parametrize("seed", range(4))
def test_shard_combines_match_zlib(seed):
    """Seeded shards, empty ones among them, against zlib over their
    concatenation."""
    rng = np.random.default_rng(seed)
    parts = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(0, 7000, 6)]
    parts.insert(int(rng.integers(0, 6)), b"")
    whole = b"".join(parts)
    assert distributed.combine_adler_shards(
        [(zlib.adler32(p), len(p)) for p in parts]) == zlib.adler32(whole)
    assert distributed.combine_crc_shards(
        [(checksums.crc32(p), len(p)) for p in parts]) == zlib.crc32(whole)


# ---- segments --------------------------------------------------------------

@pytest.mark.parametrize("lazy", [False, True], ids=["greedy", "lazy"])
@pytest.mark.parametrize("lens", [[4096], [4096, 1000, 3]],
                         ids=["one", "three"])
def test_segment_tokens_match_jax(lazy, lens):
    L = 4096
    seg = np.zeros((len(lens), L), np.uint8)
    for s, n in enumerate(lens):
        seg[s, :n] = np.frombuffer(_payload(n, seed=s), np.uint8)
    seg_len = np.array(lens, np.int32)
    want = jax_blocks.segment_tokens(jnp.asarray(seg), jnp.asarray(seg_len),
                                     t_cap=L, lazy=lazy)
    got = blocks.segment_tokens(torch.from_numpy(seg), seg_len, t_cap=L,
                                lazy=lazy)
    w_terms, w_valid, w_counts = (np.asarray(x) for x in want)
    assert np.array_equal(got[0].numpy().view(np.uint32),
                          w_terms.astype(np.uint32))
    assert np.array_equal(got[1].numpy(), w_valid)
    assert got[2].tolist() == w_counts.tolist()


SIZES = [0, 1, 2, 100, 4097, 60_000]
_JAX_STREAMS: dict = {}


def _jax_segmented(n, lazy, segments):
    """The JAX stream, once per (n, lazy, segments): its level enters only
    through ``lazy = level >= 4``."""
    key = (n, lazy, segments)
    if key not in _JAX_STREAMS:
        _JAX_STREAMS[key] = jax_blocks.deflate_segmented(
            _payload(n), level=6 if lazy else 3, segments=segments)
    return _JAX_STREAMS[key]


@pytest.mark.parametrize("segments", [1, 2, 4, 8])
@pytest.mark.parametrize("level", range(8))
@pytest.mark.parametrize("n", SIZES)
def test_deflate_segmented_matches_jax(n, level, segments):
    data = _payload(n)
    got = blocks.deflate_segmented(data, level=level, segments=segments,
                                   device="cpu")
    assert got == _jax_segmented(n, level >= 4, segments)
    assert zlib.decompress(got) == data


def test_deflate_segmented_launches_emit_once_for_all_segments(monkeypatch):
    """Every segment's terms go through one K6 call, each against its own
    table: 60,000 bytes in 8 segments of 8,192 are 8 rows of tables."""
    from swift_png_tpu_torch.ops import deflate_emit

    calls = []
    real = deflate_emit.emit_terms_batch

    def spy(terms, tabs, per_image):
        calls.append(tabs.clone())
        return real(terms, tabs, per_image)

    monkeypatch.setattr(deflate_emit, "emit_terms_batch", spy)
    blocks.deflate_segmented(_payload(60_000), level=6, segments=8,
                             device="cpu")
    assert len(calls) == 1 and calls[0].shape == (8, 320)
    assert len({tuple(r.tolist()) for r in calls[0]}) == 8


# ---- the corpus ------------------------------------------------------------

def _indexed_png(idx, palette):
    """An indexed8 PNG (PLTE, no tRNS) of ``idx`` ``(h, w)`` uint8, its
    rows filtered with ``chip_smoke.filter_rows``."""
    h, w = idx.shape
    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([8, 3, 0, 0, 0]))
    f = chip_smoke.filter_rows(idx, 1).tobytes()
    return (bytes([137, 80, 78, 71, 13, 10, 26, 10])
            + chip_smoke.png_chunk(b"IHDR", ihdr)
            + chip_smoke.png_chunk(b"PLTE", bytes(palette))
            + chip_smoke.png_chunk(b"IDAT", zlib.compress(f, 6))
            + chip_smoke.png_chunk(b"IEND", b""))


def corpus_set(seed=0):
    """A mixed set: rgba8 16×12 (three, one bucket), rgb8 33×17 (two),
    Adam7 gray 9×11, indexed8 12×10, CgBI bgra8 8×8 (two): five
    buckets."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        out.append(chip_smoke.general_png(
            rng.integers(0, 256, (12, 16, 4), dtype=np.uint8), "rgba8"))
    for _ in range(2):
        px = rng.integers(0, 256, (17, 33 * 3), dtype=np.uint8)
        out.append(chip_smoke.plain_png(33, 17, zlib.compress(
            chip_smoke.filter_rows(px, 3).tobytes(), 6), color=2))
    gray = rng.integers(0, 256, (11, 9, 1), dtype=np.uint8)
    out.append(chip_smoke.plain_png(9, 11, zlib.compress(
        chip_smoke.adam7_filtered(gray, 1), 6), color=0, interlaced=True))
    out.append(_indexed_png(rng.integers(0, 20, (10, 12), dtype=np.uint8),
                            rng.integers(0, 256, 60, dtype=np.uint8)))
    for _ in range(2):
        out.append(chip_smoke.general_png(
            rng.integers(0, 256, (8, 8, 4), dtype=np.uint8), "cgbi"))
    order = rng.permutation(len(out))
    return [out[i] for i in order]


CORPUS = corpus_set()


def test_probe_bucket_and_shards_match_jax():
    for data in CORPUS:
        got, want = corpus.probe(data), jax_corpus.probe(data)
        assert (got.size, got.pixel_name, got.interlaced, got.standard) == (
            want.size, want.pixel_name, want.interlaced, want.standard)
        assert got.bucket_key == want.bucket_key
    got, want = corpus.bucket(CORPUS), jax_corpus.bucket(CORPUS)
    assert list(got) == list(want) and len(got) == 5
    assert got == want
    for count in (1, 2, 3):
        parts = [corpus.shard_buckets(got, i, count) for i in range(count)]
        assert parts == [jax_corpus.shard_buckets(want, i, count)
                         for i in range(count)]
        dealt = [repr(k) for part in parts for k in part]
        assert sorted(dealt) == sorted(map(repr, got))   # each key once


_JAX_CORPUS: dict = {}


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("batch_size", [2, 8])
def test_corpus_decoder_matches_jax(batch_size, bits):
    key = (batch_size, bits)
    if key not in _JAX_CORPUS:
        _JAX_CORPUS[key] = jax_corpus.CorpusDecoder(
            batch_size=batch_size).decode(CORPUS, bits=bits)
    got = corpus.CorpusDecoder(batch_size=batch_size,
                               device="cpu").decode(CORPUS, bits=bits)
    assert len(got) == len(CORPUS)
    for g, w in zip(got, _JAX_CORPUS[key]):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


# ---- one process: the mesh global_mesh() sets up --------------------------

@pytest.fixture
def one_rank_mesh():
    assert not torch.distributed.is_initialized()
    mesh = distributed.global_mesh()
    try:
        yield mesh
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()


def test_one_rank_mesh_equals_no_mesh(one_rank_mesh):
    mesh = one_rank_mesh
    assert mesh.mesh_dim_names == ("images", "rows")
    assert tuple(mesh.mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.integers(0, 256, (3, 7, 12),
                                         dtype=np.uint8))
    assert torch.equal(filter_select_sharded(mesh, rows, 4),
                       filter_select_batch(rows, 4))
    pngs = [p for p in CORPUS if corpus.probe(p).pixel_name == "rgba8"
            and corpus.probe(p).standard == "common"]
    assert np.array_equal(BatchCodec(mesh=mesh).decode(pngs),
                          BatchCodec("cpu").decode(pngs))
    px = rng.integers(0, 256, (3, 9, 10, 4), dtype=np.uint8)
    assert BatchCodec(mesh=mesh).encode(px, level=6) == \
        BatchCodec("cpu").encode(px, level=6)
    data = _payload(20_000)
    assert blocks.deflate_segmented(data, 6, 4, mesh=mesh) == \
        blocks.deflate_segmented(data, 6, 4, device="cpu")


def test_global_mesh_rows_must_divide_the_world(one_rank_mesh):
    with pytest.raises(ValueError, match="1 devices not divisible into "
                                         "2 row shards"):
        distributed.global_mesh(rows=2)


def test_mesh_device_and_codec_device():
    """A CPU mesh gives ``cpu``; a ``cuda`` mesh without a card raises, as
    does a device that is not the mesh's."""
    cpu_mesh = types.SimpleNamespace(device_type="cpu")
    assert distributed.mesh_device(cpu_mesh) == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            distributed.mesh_device(types.SimpleNamespace(device_type="cuda"))
    with pytest.raises(ValueError, match="not this process's device"):
        BatchCodec("cuda:0", mesh=cpu_mesh)
