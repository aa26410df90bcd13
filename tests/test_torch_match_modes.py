"""The match-dominated branch of the indexed inflate: the port's plain
PyTorch versions against the JAX package on the same inputs — the dense
pointer collapse, the records build and the in-order records copy (K2 and
its feasibility version K2′), the distance sweeps, the output-byte Adler-32,
the host match probe, and ``CheckpointInflator.run``/``inflate_zlib_batch``
routing.  Everything is integer and compares exactly.  The JAX side runs
as its own tests do on the CPU: the xla backend, Pallas in interpret mode,
and its native library switched off (the port has no host tier, so it
routes as the JAX package does without one)."""

import importlib.util
import os
import zlib

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

import chip_smoke
import swift_png_tpu.native as jax_native
import swift_png_tpu.ops.inflate_checkpoint as jic
import swift_png_tpu.ops.inflate_seqcopy as jsq
from swift_png_tpu.lz77.errors import LZ77Error as JaxLZ77Error
from swift_png_tpu.lz77.index import _build_index_host
from swift_png_tpu.parallel.batch import decode_indexed as jax_decode_indexed
from swift_png_tpu_torch import decode_indexed
from swift_png_tpu_torch._host.lz77.errors import LZ77Error
from swift_png_tpu_torch._host.lz77.index import build_index
import swift_png_tpu_torch.ops.inflate_checkpoint as tic
import swift_png_tpu_torch.ops.inflate_seqcopy as tsq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OB = 256
SIDE = 64            # smooth test images are SIDE × SIDE rgba8
DISTS = [[1, 3, 4, 7, 8, 12, 200, 2052], [5], list(range(1, 70))]


@pytest.fixture(autouse=True)
def _no_native(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---- pointer sets (tests/test_expand_sweeps.py ``_rich_ptr``) ------------

def _rich_ptr(rng, B, Opad, dists):
    N = B * Opad
    ptr = np.arange(N, dtype=np.int32)
    lit = rng.integers(0, 256, N, dtype=np.uint8)
    for b in range(B):
        base = b * Opad
        pos = 10
        while pos < Opad - 40:
            ln = int(rng.integers(3, 20))
            d = min(int(rng.choice(dists)), pos)
            ln = min(ln, Opad - pos - 1)
            ptr[base + pos:base + pos + ln] = (
                base + np.arange(pos, pos + ln) - d)
            pos += ln + int(rng.integers(1, 6))
    return ptr, lit


def _ptr_case(dists):
    rng = np.random.default_rng(sum(dists) + len(dists))
    B, Opad = 2, 128 * 40
    return B, Opad, *_rich_ptr(rng, B, Opad, dists)


@pytest.mark.parametrize("dists", DISTS, ids=["mixed", "one", "many"])
def test_collapse_ptr_and_expansion_match_jax(dists):
    B, Opad, ptr, lit = _ptr_case(dists)
    p2, m1 = tic.collapse_ptr(_t(ptr))
    jp2, jm1 = jic._collapse_ptr(jnp.asarray(ptr))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(jp2))
    np.testing.assert_array_equal(m1.numpy(), np.asarray(jm1))
    N = B * Opad
    got = tic.expand_collapse(_t(ptr), _t(lit)).numpy()
    # identity-slot mode (cap ≥ N/2) and the compacted collapse branch
    for cap in (N, 1 << int(np.ceil(np.log2(
            int(np.sum(ptr != np.arange(N))) + 64)))):
        want, ovf, _, _ = jic._expand_legacy(jnp.asarray(ptr),
                                             jnp.asarray(lit), cap, None,
                                             (B, Opad))
        assert not bool(ovf)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("cap", [2048, 40], ids=["fits", "overflows"])
def test_build_records_matches_jax(cap):
    B, Opad, ptr, _ = _ptr_case(DISTS[0])
    starts, recs, ovf = tsq.build_records(_t(ptr), B, Opad, cap)
    jstarts, jrecs, jovf = jax.jit(jsq.build_records, static_argnums=(
        1, 2, 3))(jnp.asarray(ptr), B, Opad, cap)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    np.testing.assert_array_equal(recs.numpy(), np.asarray(jrecs))
    assert ovf == bool(jovf) == (cap == 40)


# ---- K2: records copy (inputs after tools/exp_seqcopy.py ``_make_case``) --

def _ref_expand(lit_flat, recs, starts, B, Rp):
    """``tools/exp_seqcopy.py`` ``_ref_expand``: a numpy byte loop."""
    out = lit_flat.copy().reshape(B, Rp * 128)
    for b in range(B):
        for t in range(starts[b], starts[b + 1]):
            pos, d, ln = recs[t]
            for i in range(ln):
                out[b, pos + i] = out[b, pos + i - d]
    return out


def _records(kind, B=2, n_recs=24, Rp=64):
    rng = np.random.default_rng(len(kind))
    if kind in ("random_d", "smooth"):
        return chip_smoke.k2_case(B, n_recs, Rp, rng, smooth=kind == "smooth")
    lit = rng.integers(0, 256, (B, Rp * 128), dtype=np.uint8)
    recs, starts = [], [0]
    for _ in range(B):
        pos = 300
        for _ in range(n_recs):
            d = {"tiled": int(rng.choice([2, 16, 64, 128])), "d1": 1,
                 "d_over_128": int(rng.integers(129, pos))}[kind]
            ln = int(rng.integers(3, 300))
            if pos + ln >= (Rp - 17) * 128:
                break
            recs.append((pos, d, ln))
            pos += ln + int(rng.integers(1, 40))
        starts.append(len(recs))
    return lit, np.asarray(recs, np.int32), np.asarray(starts, np.int32)


@pytest.mark.parametrize("kind", ["random_d", "tiled", "d1", "d_over_128"])
def test_seqcopy_reference_matches_jax_kernel(kind):
    lit, recs, starts = _records(kind)
    B, Opad = lit.shape
    got = tsq.seqcopy_reference(_t(starts), _t(recs), _t(lit)).numpy()
    np.testing.assert_array_equal(
        got, _ref_expand(lit, recs, starts, B, Opad // 128))
    want = jsq.seqcopy_expand(jnp.asarray(starts),
                              jnp.asarray(recs.reshape(-1)),
                              jnp.asarray(lit.reshape(-1)), B=B, Opad=Opad,
                              interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want).reshape(B, Opad))


@pytest.fixture(scope="module")
def exp_seqcopy():
    """``tools/exp_seqcopy.py`` loaded as a module.  Importing it sets a
    persistent JAX compilation cache, which this suite keeps off: the
    settings are put back before anything compiles."""
    keep = (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs,
            os.environ.get("JAX_COMPILATION_CACHE_DIR"))
    spec = importlib.util.spec_from_file_location(
        "exp_seqcopy", os.path.join(REPO, "tools", "exp_seqcopy.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", keep[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          keep[1])
        if keep[2] is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = keep[2]
    return mod


@pytest.mark.parametrize("smooth", [False, True], ids=["random_d", "smooth"])
def test_seqcopy_reference_matches_exp_seqcopy(exp_seqcopy, smooth):
    rng = np.random.default_rng(7)
    B, Rp = 2, 48
    lit, recs, starts = exp_seqcopy._make_case(B, 16, Rp, rng, smooth=smooth)
    want = exp_seqcopy.seqcopy(jnp.asarray(starts), jnp.asarray(recs),
                               jnp.asarray(lit.reshape(B, Rp, 128)),
                               interpret=True)
    got = tsq.seqcopy_reference(_t(starts), _t(recs), _t(lit))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(B, -1))


def test_seqcopy_reference_keeps_hostile_records_in_their_row():
    lit = np.arange(2 * 300, dtype=np.int64).astype(np.uint8).reshape(2, 300)
    # before the row, past its end, d < 1, a source before byte 0, padding
    recs = np.array([[-5, 3, 20], [290, 2, 50], [10, 0, 5], [5, 20, 10],
                     [0, 1, 0]], np.int32)
    out = tsq.seqcopy_reference(_t(np.array([0, 3, 5], np.int32)),
                                _t(recs), _t(lit)).numpy()
    want = lit.copy()
    for q in range(0, 15):
        i = q + 5
        s = -5 - 3 + i % 3
        want[0, q] = want[0, s] if s >= 0 else 0
    for q in range(290, 300):
        want[0, q] = want[0, 288 + (q - 290) % 2]
    for q in range(5, 15):
        want[1, q] = 0          # sources -15 … -6 read 0
    np.testing.assert_array_equal(out, want)


# ---- distance sweeps -------------------------------------------------------

@pytest.mark.parametrize("dists", DISTS, ids=["mixed", "one", "many"])
def test_top_distances_and_sweeps_match_jax(dists):
    B, Opad, ptr, lit = _ptr_case(dists)
    N = B * Opad
    d = np.arange(N) - ptr
    got_k = tic.top_distances(tic._wrap16(_t(d).long()), 16)
    want_k = jic._top_distances(jnp.asarray(d.astype(np.int16)), 16)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    got = tic.expand_sweeps(_t(ptr), _t(lit), 16).numpy()
    rc = 8192     # grow the residual cap as run() does until it converges
    while True:
        want, ovf, _, _ = jic._expand(jnp.asarray(ptr), jnp.asarray(lit), rc,
                                      None, (B, Opad), "heavy", None, True,
                                      16)
        if not bool(ovf):
            break
        rc *= 4
    np.testing.assert_array_equal(got, np.asarray(want))


def test_top_distances_never_chooses_the_wrapped_32768():
    d = np.zeros(509 * 64, np.int64)
    d[::509][:40] = 32768
    d[::509][40:50] = 7
    got = tic.top_distances(tic._wrap16(_t(d)), 4)
    want = jic._top_distances(jnp.asarray(d.astype(np.int16)), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [7, 0, 0, 0]


# ---- checksum and probe ----------------------------------------------------

@pytest.mark.parametrize("out_size", [5000, 5120], ids=["padded", "aligned"])
def test_adler_batch_matches_jax_and_zlib(out_size):
    rng = np.random.default_rng(out_size)
    out2 = rng.integers(0, 256, (3, 5120), dtype=np.uint8)
    got = tic.adler_batch(_t(out2), out_size).numpy()
    want = np.asarray(jic._adler_batch(jnp.asarray(out2), out_size))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.tolist() == [zlib.adler32(r[:out_size].tobytes())
                            for r in out2]


def _smooth_rows(i, filt="minsum"):
    px = chip_smoke.smooth_image(i, SIDE, SIDE)
    rows = px.reshape(SIDE, SIDE * 4)
    if filt == "minsum":
        return px, chip_smoke.filter_minsum(rows, 4)
    ft = (np.arange(SIDE) % 5).astype(np.uint8)[:, None]
    f = chip_smoke.filter_rows(rows, 4)
    assert (f[:, :1] == ft).all()
    return px, f


def _photo_rows(seed, n=16384):
    rng = np.random.default_rng(seed)
    y = (np.sin(np.arange(n) / 9.0 + seed) * 50 + 128).astype(np.int64)
    return np.clip(y + rng.integers(-6, 7, n), 0, 255).astype(np.uint8)


def _probe_bodies():
    smooth = _smooth_rows(0)[1].tobytes()
    photo = _photo_rows(0).tobytes()
    fixed = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)
    return {"smooth": zlib.compress(smooth, 6)[2:-4],
            "photographic": zlib.compress(photo, 6)[2:-4],
            "stored": zlib.compress(photo, 0)[2:-4],
            "fixed_huffman": (fixed.compress(smooth) + fixed.flush())[2:-4]}


@pytest.mark.parametrize("kind", ["smooth", "photographic", "stored",
                                  "fixed_huffman"])
def test_probe_match_profile_matches_jax(kind):
    body = _probe_bodies()[kind]
    got = tic.probe_match_profile(body)
    assert got is not None
    assert got == jic._probe_match_profile(body)


# ---- routing: run() and inflate_zlib_batch() -------------------------------

def _batch(kind):
    """``(rows, zlib streams)`` of a single-block batch of one kind."""
    if kind == "literal":
        rows = [_photo_rows(s) for s in range(2)]
    else:
        rows = [_smooth_rows(i, "minsum" if kind == "records" else "y5")[1]
                for i in range(3)]
    return rows, [zlib.compress(r.tobytes(), 6) for r in rows]


def _both_run(streams, out_size, **kw):
    bodies = [s[2:-4] for s in streams]
    jix = [_build_index_host(b, out_size, OB) for b in bodies]
    tix = [build_index(b, out_size, OB) for b in bodies]
    assert all(ix.n_blocks == 1 for ix in tix)
    jeng = jic.CheckpointInflator(ob=OB, backend="xla")
    jout, jadler = jeng.run(bodies, jix, keep_on_device=False, **kw)
    teng = tic.CheckpointInflator("cpu")
    tout, tadler = teng.run(bodies, tix, **kw)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tadler, np.asarray(jadler))
    keys = ("tier", "collapse", "records_cap", "sweep_k")
    assert {k: teng.last_plan[k] for k in keys} == \
        {k: jeng.last_plan[k] for k in keys}
    return tout, tadler, teng.last_plan


@pytest.mark.parametrize("kind,mode", [("literal", "literal"),
                                       ("records", "records"),
                                       ("records", "sweeps"),
                                       ("sweeps", "sweeps")])
def test_run_matches_jax(kind, mode, monkeypatch):
    if mode == "sweeps":
        for mod in (jsq, tsq):
            monkeypatch.setattr(mod, "RECORDS_SMEM_CAP", 64)
    rows, streams = _batch(kind)
    out, adler, plan = _both_run(streams, rows[0].size)
    for i, r in enumerate(rows):
        assert out[i].numpy().tobytes() == r.tobytes()
        assert int(adler[i]) == zlib.adler32(r.tobytes())
    assert plan["collapse"] == (mode != "literal")
    assert (plan["records_cap"] is not None) == (mode == "records")
    assert plan["sweep_k"] == (48 if mode == "sweeps" else None)


def test_records_overflow_flags_like_jax_and_run_reaches_sweeps(monkeypatch):
    rows, streams = _batch("records")
    out_size = rows[0].size
    bodies = [s[2:-4] for s in streams]
    # the tail with records_cap below the batch's record count
    jeng = jic.CheckpointInflator(ob=OB, backend="xla")
    jprep = jeng.prepare(bodies, [_build_index_host(b, out_size, OB)
                                  for b in bodies])
    B = len(bodies)
    N = B * jprep["Ui_pad"] * OB
    _, _, _, jovf = jic.inflate_indexed(
        jprep["spans"], jprep["sub0"], jprep["n_tokens"], jprep["skip"],
        jprep["lit"], jprep["dist"], ob=OB, n_streams=B, out_size=out_size,
        expand_cap=N, k_max=jprep["k_max"], collapse=True, records_cap=8,
        interpret=True)
    tix = [build_index(b, out_size, OB) for b in bodies]
    tprep = tic.CheckpointInflator("cpu").prepare(bodies, tix)
    _, _, _, ovf = tic.inflate_indexed_stamp(tprep, collapse=True,
                                             records_cap=8)
    assert ovf is True and bool(jovf)
    # run: the probe passes the batch to the records kernel, whose records
    # overflow the (shrunken) cap, so the retry switches to the sweeps
    monkeypatch.setattr(jic, "_probe_match_profile", lambda body: None)
    monkeypatch.setattr(tic, "probe_match_profile", lambda body: None)
    for mod in (jsq, tsq):
        monkeypatch.setattr(mod, "RECORDS_SMEM_CAP", 64)
    out, _, plan = _both_run(streams, out_size)
    assert plan["sweep_k"] == 48 and plan["records_cap"] is None
    assert out.numpy().tobytes() == b"".join(r.tobytes() for r in rows)


def _foreign():
    """``tests/test_expand_sweeps.py``'s foreign recipe: zlib -9 over
    repetitive content."""
    rng = np.random.default_rng(3)
    row = rng.integers(0, 48, 257, dtype=np.uint8)
    pay = (np.tile(row, 400) + rng.integers(0, 2, 257 * 400,
                                            dtype=np.uint8)).tobytes()
    return pay, zlib.compress(pay, 9)


def test_inflate_zlib_batch_matches_jax_on_foreign_stream():
    pay, stream = _foreign()
    jeng = jic.CheckpointInflator(ob=OB, backend="xla")
    want = jeng.inflate_zlib_batch([stream], len(pay), keep_on_device=False)
    teng = tic.CheckpointInflator("cpu", ob=OB)
    got = teng.inflate_zlib_batch([stream], len(pay))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].numpy().tobytes() == pay
    assert teng.last_plan["sweep_k"] == jeng.last_plan["sweep_k"]


def _spoiled(kind):
    pay, s = _foreign()
    if kind == "short":
        return pay, s[:5]
    if kind == "method":
        return pay, bytes([s[0] & 0xF0 | 7]) + s[1:]
    if kind == "check_bits":
        return pay, s[:1] + bytes([s[1] ^ 1]) + s[2:]
    return pay, s[:-4] + ((int.from_bytes(s[-4:], "big") + 1) % 2 ** 32
                          ).to_bytes(4, "big")


@pytest.mark.parametrize("kind", ["short", "method", "check_bits",
                                  "trailer"])
def test_inflate_zlib_batch_raises_like_jax(kind):
    pay, bad = _spoiled(kind)
    with pytest.raises(JaxLZ77Error) as jerr:
        jic.CheckpointInflator(ob=OB, backend="xla").inflate_zlib_batch(
            [bad], len(pay))
    with pytest.raises(LZ77Error) as terr:
        tic.CheckpointInflator("cpu", ob=OB).inflate_zlib_batch([bad],
                                                                len(pay))
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert terr.value.case == jerr.value.case
    assert terr.value.details == jerr.value.details


def test_inflate_zlib_batch_returns_none_where_a_stream_does_not_index():
    pay = _foreign()[0][:20_000]
    good = zlib.compress(pay, 9)
    # a block every 40 bytes: a 256-byte unit crosses several boundaries
    co = zlib.compressobj(6)
    odd = b"".join(co.compress(pay[i:i + 40]) + co.flush(zlib.Z_FULL_FLUSH)
                   for i in range(0, 20_000, 40)) + co.flush()
    assert _build_index_host(odd[2:-4], 20_000, OB) is None
    assert tic.CheckpointInflator("cpu", ob=OB).inflate_zlib_batch(
        [good, odd], 20_000) is None


# ---- decode_indexed on smooth PNGs ----------------------------------------

@pytest.mark.parametrize("filt", ["minsum", "y5"])
def test_decode_indexed_smooth_matches_jax(filt, monkeypatch):
    pngs, images = [], []
    for i in range(3):
        px, f = _smooth_rows(i, filt)
        s = zlib.compress(f.tobytes(), 6)
        ix = build_index(s[2:-4], f.size, OB)
        pngs.append(chip_smoke.make_png(s, ix.serialize(), SIDE, SIDE))
        images.append(px)
    calls = []
    ref = tsq.seqcopy_reference
    monkeypatch.setattr(tsq, "seqcopy_reference",
                        lambda *a: calls.append(1) or ref(*a))
    got = decode_indexed(pngs, device="cpu")
    want = jax_decode_indexed(pngs, backend="xla")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.stack(images))
    # the chunk carries no match count: the port counts it from K1's stamp
    # and takes the records kernel
    assert calls == [1]
