"""The level 8–13 batched encode: the port's plain PyTorch versions against
the JAX package on the same inputs — filter select, row packing, the host
tree and table code, the cost refresh, the candidate search (K4), the DP
parse (K5), term emission (K6), whole deflate streams and
``BatchCodec.encode``'s PNG bytes.  Everything is integer (the cost
refresh rounds float32 logarithms to integers) and compares exactly.  The
JAX side runs as its own tests do on the CPU: Pallas in interpret mode.
Both packages' native libraries are switched off here;
``tests/test_torch_native.py`` holds the two with their libraries on."""

import zlib

import numpy as np
import pytest
import torch

import chip_smoke
import conftest  # noqa: F401

import jax
import jax.numpy as jnp

import swift_png_tpu.native as jax_native
import swift_png_tpu_torch._host.native as torch_native
import swift_png_tpu.ops.deflate_optimal as jdo
from swift_png_tpu.lz77 import constants as JC
from swift_png_tpu.lz77 import deflate as jdeflate
from swift_png_tpu.lz77.huffman import (
    lengths_from_frequencies as j_lengths)
from swift_png_tpu.ops import convolve as jconvolve
from swift_png_tpu.ops import deflate as jops_deflate
from swift_png_tpu.ops.deflate_emit import (
    emit_terms_batch as j_emit, pack_emit_table as j_pack_emit_table)
from swift_png_tpu.ops.filter import filter_select_batch as j_filter
from swift_png_tpu.parallel.batch import BatchCodec as JaxBatchCodec
from swift_png_tpu.utils.bits import BitWriter as JaxBitWriter
from swift_png_tpu_torch import BatchCodec, decode_indexed
from swift_png_tpu_torch._host.bits import BitWriter
from swift_png_tpu_torch._host.lz77 import deflate as tdeflate
from swift_png_tpu_torch._host.lz77.huffman import lengths_from_frequencies
from swift_png_tpu_torch.ops import convolve
from swift_png_tpu_torch.ops import deflate as tops_deflate
from swift_png_tpu_torch.ops import deflate_optimal as tdo
from swift_png_tpu_torch.ops.deflate_emit import (emit_terms_batch,
                                                  pack_emit_table)
from swift_png_tpu_torch.ops.filter import filter_select_batch

TILE = 128 * 1024


@pytest.fixture(autouse=True)
def _no_native(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(torch_native, "available", lambda: False)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def payload(kind, n=12_000):
    """``tests/test_deflate_optimal.py``'s payload kinds."""
    rng = np.random.default_rng(21)
    if kind == "noise":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "rows":
        row = rng.integers(0, 256, 200, dtype=np.uint8)
        img = np.tile(row, n // 200 + 1)[:n]
        img = img + np.repeat(np.arange(n // 200 + 1), 200)[:n] % 3
        return img.astype(np.uint8).tobytes()
    if kind == "rle":
        return (b"A" * 500 + b"xy" * 300 + b"B" * 700) * (n // 1800 + 1)
    if kind == "text":
        return (b"the quick brown fox jumps over the lazy dog. " * 300)[:n]
    raise AssertionError(kind)


# ---- filter select and row packing ----------------------------------------

@pytest.mark.parametrize("delay", [1, 2, 3, 4, 6, 8])
def test_filter_select_batch_matches_jax(delay):
    rng = np.random.default_rng(delay)
    pitch = 12 * delay
    rows = rng.integers(0, 256, (2, 9, pitch), dtype=np.uint8)
    rows[1] = rows[1] // 64 * 64                 # smooth: filters differ
    want = np.asarray(j_filter(jnp.asarray(rows), delay))
    got = filter_select_batch(_t(rows), delay).numpy()
    np.testing.assert_array_equal(got, want)


def test_filter_select_ties_go_to_the_lowest_filter():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 2, (3, 16, 8), dtype=np.uint8)
    rows[0] = 0                                  # every filter scores 0
    rows[1, :, :] = rows[1, :1, :]               # Up ties None on row 0
    got = filter_select_batch(_t(rows), 2).numpy()
    want = np.asarray(j_filter(jnp.asarray(rows), 2))
    np.testing.assert_array_equal(got, want)
    assert (got[0, :, 0] == 0).all()
    # the first minimum of the five scores, as numpy's argmin picks it
    cur = rows.astype(np.int32)
    prev = np.concatenate([np.zeros_like(cur[:, :1]), cur[:, :-1]], 1)
    a = np.pad(cur, ((0, 0), (0, 0), (2, 0)))[..., :8]
    c = np.pad(prev, ((0, 0), (0, 0), (2, 0)))[..., :8]
    pa, pb, pc = abs(prev - c), abs(a - c), abs(a + prev - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
    cand = np.stack([cur, cur - a, cur - prev, cur - ((a + prev) >> 1),
                     cur - paeth]) & 0xFF
    scores = np.abs(cand.astype(np.uint8).view(np.int8).astype(np.int32)
                    ).sum(-1)
    np.testing.assert_array_equal(got[:, :, 0], scores.argmin(0))


@pytest.mark.parametrize("depth,channels", [(1, 1), (2, 1), (4, 1), (8, 3),
                                            (16, 2)])
def test_pack_rows_matches_jax(depth, channels):
    rng = np.random.default_rng(depth)
    W = 13
    s = rng.integers(0, 1 << depth, (2, 5, W, channels)).astype(np.int32)
    want = np.stack([np.asarray(jconvolve.pack_rows(
        jnp.asarray(x), depth, channels, W)) for x in s])
    got = convolve.pack_rows(_t(s), depth, channels, W).numpy()
    np.testing.assert_array_equal(got, want)


# ---- host trees, cost tables, block headers -------------------------------

def _freqs(seed, n, zeros=0.3):
    rng = np.random.default_rng(seed)
    f = rng.integers(1, 10 ** int(rng.integers(1, 6)), n)
    f[rng.random(n) < zeros] = 0
    return f


@pytest.mark.parametrize("seed", range(6))
def test_lengths_depths_and_tables_match_jax(seed):
    lit_f = _freqs(seed, 286)
    dist_f = _freqs(seed + 100, 30, zeros=0.6 if seed % 2 else 1.0)
    for f, limit, force in ((lit_f, 15, True), (dist_f, 15, False),
                            (lit_f[:19], 7, False)):
        np.testing.assert_array_equal(lengths_from_frequencies(f, limit,
                                                               force),
                                      j_lengths(f, limit, force))
    ll = lengths_from_frequencies(lit_f, 15, True)
    dl = lengths_from_frequencies(dist_f, 15, False)
    jd, td = jdeflate.Depths(), tdeflate.Depths()
    jd.update(ll, dl)
    td.update(ll, dl)
    np.testing.assert_array_equal(td.storage, jd.storage)
    for a, b in zip(tops_deflate._emit_tables(ll, dl),
                    jops_deflate._emit_tables(ll, dl)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        pack_emit_table(*tops_deflate._emit_tables(ll, dl)),
        j_pack_emit_table(*jops_deflate._emit_tables(ll, dl)))
    assert (tops_deflate.max_term_bits(ll, dl, np.r_[lit_f, 0, 0, dist_f])
            == jops_deflate.max_term_bits(ll, dl, np.r_[lit_f, 0, 0, dist_f]))
    tw, jw = BitWriter(), JaxBitWriter()
    tw.write(5, 3)
    jw.write(5, 3)
    tops_deflate._write_block_header_and_tables(tw, ll, dl, True)
    jops_deflate._write_block_header_and_tables(jw, ll, dl, True)
    tw.pad_to_byte()
    jw.pad_to_byte()
    assert tw.drain() == jw.drain()


def test_append_bits_matches_the_byte_loop():
    rng = np.random.default_rng(4)
    body = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    for lead, nbits in ((0, 0), (3, 8 * 3000), (5, 8 * 2999 + 3),
                        (61, 17), (7, 1)):
        a, b = BitWriter(), BitWriter()
        a.write(0x5A5A5A5A5A5A5A5A, lead)
        b.write(0x5A5A5A5A5A5A5A5A, lead)
        tops_deflate.append_bits(a, body, nbits)
        # the JAX package's loop: one write per body byte
        full, rem = divmod(nbits, 8)
        for i in range(full):
            b.write(body[i], 8)
        if rem:
            b.write(body[full] & ((1 << rem) - 1), rem)
        a.write(3, 2)
        b.write(3, 2)
        a.pad_to_byte()
        b.pad_to_byte()
        assert a.drain() == b.drain(), (lead, nbits)


@pytest.mark.parametrize("seed", range(20))
def test_device_depths_update_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B = 2
    hist = np.zeros((B, 320), np.int32)
    scale = 10 ** int(rng.integers(0, 7))
    hist[:, :286] = rng.integers(0, scale + 1, (B, 286))
    hist[:, 288:318] = rng.integers(0, scale + 1, (B, 30))
    hist[rng.random((B, 320)) < 0.4] = 0
    hist[:, 286:288] = 0
    hist[:, 318:] = 0
    dep = rng.integers(4, 61, (B, 256)).astype(np.int32)
    run = rng.integers(4, 90, (B, 256)).astype(np.int32)
    dde = rng.integers(4, 110, (B, 32)).astype(np.int32)
    want = jax.vmap(jdo._device_depths_update)(
        jnp.asarray(hist), jnp.asarray(dep), jnp.asarray(run),
        jnp.asarray(dde))
    got = tdo._device_depths_update(_t(hist), _t(dep), _t(run), _t(dde))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- the kernels' plain versions against the Pallas kernels ----------------

def _kernel_case():
    """Two images, one tile each: photographic-like bytes and a smooth
    image's long runs, partial last chunks, menus padded with 0 slots."""
    rng = np.random.default_rng(11)
    ns = [20_500, 9_001]
    data = np.zeros(2 * TILE, np.uint8)
    y = (np.sin(np.arange(ns[0]) / 7.0) * 60 + 128).astype(np.int64)
    data[:ns[0]] = np.clip(y + rng.integers(-9, 10, ns[0]), 0, 255)
    data[TILE:TILE + ns[1]] = np.frombuffer(payload("rows", ns[1]),
                                            np.uint8)
    data[TILE + 3000: TILE + 5000] = 7
    menus = [(1, 2, 3, 4, 8, 200, 1025, 4099, 20_000),
             (1, 3, 12, 200, 400, 600)]
    dmax = 16
    dv = np.zeros((2, dmax), np.int32)
    cv = np.zeros((2, dmax), np.int32)
    for i, m in enumerate(menus):
        dv[i, :len(m)] = m
        cv[i, :len(m)] = [int(JC.DISTANCE_DECADE[d]) for d in m]
    return data, np.asarray(ns, np.int32), dv, cv, dmax


def _grid(flat, *lead):
    """Flat position order → JAX's (T, [lead,] 1024, 128) tile layout."""
    x = np.asarray(flat).reshape(*lead, -1, 128, 1024)
    return np.moveaxis(x, -3, 0).swapaxes(-1, -2) if lead else \
        x.swapaxes(-1, -2)


def _flat(grid, lead=False):
    """JAX tile layout → flat position order."""
    g = np.asarray(grid)
    if lead:
        return np.moveaxis(g, 1, 0).swapaxes(-1, -2).reshape(g.shape[1], -1)
    return g.swapaxes(-1, -2).reshape(-1)


def test_candidates_plain_matches_pallas():
    data, ns, dv, cv, dmax = _kernel_case()
    out, _ = jdo.menu_candidates_pallas_batch(
        jnp.asarray(dv), jnp.asarray(cv), jnp.asarray(data),
        jnp.asarray(ns), dmax=dmax, stride=TILE, interpret=True)
    want = _flat(out, lead=True)
    got = tdo.menu_candidates_batch(_t(dv), _t(cv), _t(data), _t(ns),
                                    dmax=dmax, stride=TILE).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] >> 9 > 1).sum() > 1000     # the case has real matches


@pytest.mark.parametrize("name", ["residues_far_d", "d_at_least_n",
                                  "all_zero", "equal_scores", "dmax8",
                                  "dmax32", "costs_outside_keys"])
def test_candidates_plain_matches_pallas_edge_cases(name):
    # every d % 4 residue and d up to 32,768, n off multiples of 4 and 32,
    # d >= n, runs cut at 258, equal scores, dmax 8/16/32 (chip_smoke.py's
    # K4 edge cases, which the card holds the kernel to)
    data, ns, dv, cv = chip_smoke.k4_edge_cases()[name]
    dmax = dv.shape[1]
    out, _ = jdo.menu_candidates_pallas_batch(
        jnp.asarray(dv), jnp.asarray(cv), jnp.asarray(data),
        jnp.asarray(ns), dmax=dmax, stride=TILE, interpret=True)
    got = tdo.menu_candidates_batch(_t(dv), _t(cv), _t(data), _t(ns),
                                    dmax=dmax, stride=TILE).numpy()
    np.testing.assert_array_equal(got, _flat(out, lead=True))
    assert ((got[0] & 0x1FF) >= 3).sum() > 1000


def _dp_tables(rng, B):
    dep = rng.integers(8, 50, (B, 256)).astype(np.int32)
    run = rng.integers(10, 60, (B, 256)).astype(np.int32)
    dde = rng.integers(6, 80, (B, 32)).astype(np.int32)
    return dep, run, dde


def _clen(ns, tpi=1):
    clen = np.zeros(len(ns) * tpi * 128, np.int32)
    for i, n in enumerate(ns):
        c = np.arange(-(-int(n) // 1024))
        clen[i * tpi * 128 + c] = np.minimum(1024, n - c * 1024)
    return clen


def _rep(x):
    return jnp.asarray(np.repeat(x.reshape(-1)[:, None], 128, axis=1))


def test_dp_parse_plain_matches_pallas():
    data, ns, dv, cv, dmax = _kernel_case()
    cand = tdo.menu_candidates_batch(_t(dv), _t(cv), _t(data), _t(ns),
                                     dmax=dmax, stride=TILE)
    dep, run, dde = _dp_tables(np.random.default_rng(5), 2)
    clen = _clen(ns)
    terms, valid, hist = tdo.optimal_parse(_t(data), _t(clen), cand,
                                           _t(dep), _t(run), _t(dde), tpi=1)
    clen_g = np.zeros((2, 8, 128), np.int32)
    clen_g[:, 0] = clen.reshape(2, 128)
    rdinfo, dbase = tdo._RDINFO, tdo._DBASE
    jt, jv, jh = jdo.optimal_parse_device(
        jnp.asarray(_grid(data.view(np.int8))), jnp.asarray(clen_g),
        jnp.asarray(_grid(cand.numpy(), 2)), _rep(dep), _rep(run),
        _rep(dde), _rep(rdinfo), _rep(dbase), k=2, interpret=True, tpi=1)
    np.testing.assert_array_equal(terms.numpy(), _flat(jt))
    np.testing.assert_array_equal(valid.numpy(), _flat(jv))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jh))
    assert int(valid.sum()) < int(ns.sum())    # matches were taken


def test_emit_plain_matches_pallas_on_the_whole_grid():
    data, ns, dv, cv, dmax = _kernel_case()
    cand = tdo.menu_candidates_batch(_t(dv), _t(cv), _t(data), _t(ns),
                                     dmax=dmax, stride=TILE)
    dep, run, dde = _dp_tables(np.random.default_rng(6), 2)
    terms, _, hist = tdo.optimal_parse(_t(data), _t(_clen(ns)), cand,
                                       _t(dep), _t(run), _t(dde), tpi=1)
    trees, tabs, _ = tdo._host_trees(hist.numpy().astype(np.int64))
    lo, hi, nb = emit_terms_batch(terms, _t(tabs), TILE)
    want = j_emit(jnp.asarray(_grid(terms.numpy())),
                  jnp.asarray(np.repeat(tabs[:, :, None], 128, axis=2)),
                  jnp.full((1,), 1, jnp.int32), interpret=True)
    for g, w in zip((lo, hi, nb), want):
        np.testing.assert_array_equal(g.numpy(), _flat(w))
    # the table-gather route gives the same pieces
    lo2, hi2, nb2 = jops_deflate.pack_terms32(
        jnp.asarray(terms.numpy()[:TILE]).astype(jnp.uint32),
        *jops_deflate._emit_tables(*trees[0]))
    for g, w in zip((lo, hi, nb), (lo2, hi2, nb2)):
        np.testing.assert_array_equal(g.numpy()[:TILE], np.asarray(w))


def test_compact_route_at_512_slots_matches_jax_host_pack():
    # under 1,024 slots per image the JAX package packs each image with
    # pack_stream32/_short; the port compacts and emits them through K6
    datas = [payload("rle", 3_000), payload("noise", 300)]
    plan = tdo._batch_inputs(datas, 4, 0, torch.device("cpu"))
    cand = tdo.menu_candidates_batch(
        plan["dists2"], plan["decades2"], plan["dbuf"], plan["nvec"],
        dmax=plan["dmax"], stride=plan["stride"])
    dep, run, dde, iters = tdo._initial_tables(plan, 9)
    terms, valid, hist = tdo.dp_iterated(plan["dbuf"], plan["clen"], cand,
                                         dep, run, dde, tpi=plan["TPI"],
                                         iters=iters)
    freqs = hist.numpy().astype(np.int64)
    trees, tabs, spans = tdo._host_trees(freqs)
    route, ctms, live, slots = tdo.emit_input(terms, valid, freqs,
                                              plan["TPI"])
    assert (route, slots) == ("compact", 512)
    atoms, totals = tdo._emit_pack(terms, valid, freqs, tabs, spans,
                                   plan["TPI"])
    for i, tree in enumerate(trees):
        pack = (jops_deflate.pack_stream32_short if spans[i] == 2
                else jops_deflate.pack_stream32)
        ja, jt = pack(jnp.asarray(ctms.view(2, slots)[i].numpy()
                                  ).astype(jnp.uint32),
                      jnp.asarray(live[i].numpy()),
                      *jops_deflate._emit_tables(*tree))
        np.testing.assert_array_equal(atoms[i].numpy(), np.asarray(ja))
        assert int(totals[i]) == int(jt)


# ---- whole streams and PNGs -------------------------------------------------

def _batch_payloads():
    datas = [payload(k, 20_000) for k in ("noise", "rows", "rle", "text")]
    return datas + [b"", b"ab", payload("rows", 5_000)]


@pytest.mark.parametrize("level", [8, 9])
def test_deflate_batch_streams_match_jax(level):
    datas = _batch_payloads()
    got = tdo.deflate_device_optimal_batch(datas, level=level, pitch=200,
                                           device="cpu")
    want = jdo.deflate_device_optimal_batch(datas, level=level, pitch=200)
    for d, g, w in zip(datas, got, want):
        assert zlib.decompress(g) == d
        assert g == w


def test_deflate_batch_two_buckets_match_jax():
    """A stream of two tiles and one of one run as two pipeline calls."""
    datas = [payload("rows", 140_000), payload("text", 3_000)]
    got = tdo.deflate_device_optimal_batch(datas, level=8, pitch=200,
                                           device="cpu")
    want = jdo.deflate_device_optimal_batch(datas, level=8, pitch=200)
    assert got == want
    assert [zlib.decompress(s) for s in got] == datas


def test_deflate_batch_warm_start_matches_jax(monkeypatch):
    """Both packages' samplers patched to the same statistics: the menu
    gains their distances and the cost model starts warm."""
    rng = np.random.default_rng(12)
    lit_f = rng.integers(0, 50, 286)
    dist_f = rng.integers(0, 9, 30)
    stats = lambda data: ([7, 333], lit_f, dist_f)   # noqa: E731
    monkeypatch.setattr(jdo, "_sample_stats", stats)
    monkeypatch.setattr(tdo, "_sample_stats", stats)
    datas = [payload("rows", 9_000), payload("text", 6_000)]
    got = tdo.deflate_device_optimal_batch(datas, level=9, pitch=200,
                                           device="cpu")
    want = jdo.deflate_device_optimal_batch(datas, level=9, pitch=200)
    assert got == want
    assert [zlib.decompress(s) for s in got] == datas


def _pixels(kind_channels, bits, seed):
    rng = np.random.default_rng(seed)
    hi = 256 if bits == 8 else 65536
    px = rng.integers(0, hi, (2, 48, 64, kind_channels))
    px[1] = px[1] // (hi // 16) * (hi // 16)    # a smoother second image
    return px.astype(np.uint8 if bits == 8 else np.uint16)


@pytest.mark.parametrize("index", [False, True], ids=["plain", "index"])
@pytest.mark.parametrize("kind,channels,bits", [
    ("rgba8", 4, 8), ("rgb8", 3, 8), ("v8", 1, 8), ("va16", 2, 16)])
def test_batch_encode_png_bytes_match_jax(kind, channels, bits, index):
    px = _pixels(channels, bits, channels)
    got = BatchCodec("cpu").encode(px, level=9, kind=kind, index=index)
    want = JaxBatchCodec().encode(px, level=9, kind=kind, index=index)
    assert got == want
    if index and kind == "rgba8":
        out = decode_indexed(got, device="cpu")
        assert torch.equal(out, torch.from_numpy(px))


def test_batch_encode_one_pixel_stored_stream_matches_jax():
    """A 1×1 v1 image filters to 2 bytes: a stored block, no parse."""
    px = np.ones((2, 1, 1, 1), np.uint8)
    got = BatchCodec("cpu").encode(px, level=9, kind="v1", index=True)
    assert got == JaxBatchCodec().encode(px, level=9, kind="v1", index=True)
