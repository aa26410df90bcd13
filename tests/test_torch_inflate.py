"""K1 (lockstep token decode + stamp) and the indexed inflate around it:
the port's plain PyTorch versions against the JAX package's Pallas kernel
in interpret mode, on the same streams and the same index state.  All
outputs are integers and compare exactly."""

import zlib

import numpy as np
import pytest
import torch

import chip_smoke
import conftest  # noqa: F401

from swift_png_tpu.lz77.deflate import Deflator
from swift_png_tpu.lz77.errors import DecompressionError as JaxDecompressionError
from swift_png_tpu.lz77.index import _build_index_host
from swift_png_tpu.ops.inflate_checkpoint import (
    CheckpointInflator as JaxInflator, inflate_indexed_pallas)
from swift_png_tpu.ops.inflate_pallas import decode_stamp_pallas
from swift_png_tpu_torch._host.lz77.errors import DecompressionError
from swift_png_tpu_torch._host.lz77.index import build_index
from swift_png_tpu_torch.ops.inflate_checkpoint import (
    CheckpointInflator, expand_matches, inflate_indexed_stamp)
from swift_png_tpu_torch.ops.inflate_stamp import (
    decode_stamp_reference, unit_tables)

OB = 256
N = 16384   # every stream inflates to N bytes, so any of them batch together


def _streams():
    rng = np.random.default_rng(0)
    y = (np.sin(np.arange(N) / 9.0) * 50 + 128).astype(np.int64)
    single = np.clip(y + rng.integers(-6, 7, N), 0, 255).astype(
        np.uint8).tobytes()
    # long runs crossing unit boundaries: skip > 0 on many units
    crossing = ((b"x" * 700 + b"yz" * 700 + b"x" * 700) * 8)[:N]
    multi = (np.random.default_rng(3).integers(0, 8, N) * 31 % 251).astype(
        np.uint8).tobytes()
    d = Deflator(level=4)      # one block per push: boundary EOB jumps
    for i in range(0, N, 4096):
        d.push(multi[i:i + 4096], last=i + 4096 >= N)
    stored = np.random.default_rng(4).integers(0, 256, N,
                                               dtype=np.uint8).tobytes()
    co = zlib.compressobj(0)   # stored chain with mid-unit header gaps
    chain = b""
    for i in range(0, N, 3000):
        chain += co.compress(stored[i:i + 3000]) + co.flush(zlib.Z_FULL_FLUSH)
    # chip_smoke.py's all-literal stream (a batch of it runs the TPU
    # kernel's literal-pair loop, mode 1) and match-dense one (mode 0)
    extra = chip_smoke.k1_corrupt_streams()
    return {
        "huffman": extra["huffman"],
        "dense": extra["dense"],
        "single": (single, zlib.compress(single, 6)),
        "crossing": (crossing, zlib.compress(crossing, 6)),
        "multiblock": (multi, d.pull()),
        "stored": (stored, chain + co.flush()),
    }


STREAMS = _streams()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the plain K1 loops over tensors of a few hundred units: more torch
    # threads only spin, and starve the suite's other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BATCHES = {"single_block": ("single", "crossing"),
           "mixed": ("single", "crossing", "multiblock", "stored")}


def _prepare(bodies, index_bodies=None):
    """JAX and port prep of the same bodies; the indexes are built from
    ``index_bodies`` (default: the bodies themselves)."""
    index_bodies = index_bodies or bodies
    jix = [_build_index_host(b, N, OB) for b in index_bodies]
    tix = [build_index(b, N, OB) for b in index_bodies]
    jprep = JaxInflator(ob=OB, backend="pallas").prepare(bodies, jix)
    tprep = CheckpointInflator("cpu").prepare(bodies, tix)
    return bodies, jix, tix, jprep, tprep


@pytest.fixture(scope="module")
def prepared():
    """Per batch: the two preps, plus both stamps computed once."""
    cache = {}

    def get(batch):
        if batch not in cache:
            _, jix, _, jp, tp = _prepare(
                [STREAMS[n][1][2:-4] for n in BATCHES[batch]])
            stamp = decode_stamp_reference(*_k1_args(tp), ob=OB)
            cache[batch] = (jix, jp, tp, stamp, _jax_stamp(jp))
        return cache[batch]
    return get


def _k1_args(tprep):
    return (tprep["spans"], tprep["meta"], tprep["pool_t"], tprep["pool_s"],
            tprep["ids"], tprep["kbound"])


def _jax_stamp(jprep):
    attr, flag, s1, s2 = decode_stamp_pallas(
        jprep["kbound"], jprep["spans3"], jprep["meta"], jprep["tabs"],
        jprep["symtab"], S=jprep["S"], ob=OB, interpret=True,
        multiblock=jprep["multiblock"], transposed=True)
    return (np.asarray(attr).reshape(-1, OB), np.asarray(flag).reshape(-1),
            np.asarray(s1).reshape(-1), np.asarray(s2).reshape(-1))


def _jax_inflate(jprep, jix):
    B = len(jix)
    cap_max = B * jprep["Ui_pad"] * OB
    r8k = lambda n: max(1 << 10, -(-n // 8192) * 8192)  # noqa: E731
    pow2 = JaxInflator._pow2
    out, flag, adler, _ = inflate_indexed_pallas(
        jprep["kbound"], jprep["spans3"], jprep["meta"], jprep["tabs"],
        jprep["symtab"], ob=OB, n_streams=B, out_size=N,
        expand_cap=min(r8k(sum(ix.match_bytes for ix in jix) + 64),
                       pow2(cap_max)),
        seg_cap=min(r8k(sum(ix.match_segs for ix in jix) + 64),
                    pow2(cap_max)),
        S=jprep["S"], interpret=True, multiblock=jprep["multiblock"],
        has_stored=jprep["has_stored"], stored_gap=jprep["stored_gap"])
    return np.asarray(out), np.asarray(flag), np.asarray(adler)


@pytest.mark.parametrize("batch", list(BATCHES))
def test_prepare_matches_jax_after_untransposing(batch, prepared):
    jix, jp, tp, _, _ = prepared(batch)
    U = len(jix) * jp["Ui_pad"]
    assert tp["S"] == jp["S"] and tp["multiblock"] == jp["multiblock"]
    assert tp["has_stored"] == jp["has_stored"]
    S = jp["S"]
    spans = np.asarray(jp["spans3"]).transpose(0, 1, 3, 2).reshape(-1, S)
    np.testing.assert_array_equal(tp["spans"].numpy().view(np.uint32),
                                  spans[:U])
    meta = np.asarray(jp["meta"])
    np.testing.assert_array_equal(tp["meta"].numpy(),
                                  meta.reshape(meta.shape[0], -1).T[:U])
    # the pool indexed by the unit ids gives JAX's per-unit tables
    per_unit = unit_tables(tp["pool_t"], tp["pool_s"], tp["ids"])
    for key, got in zip(("tabs", "symtab"), per_unit):
        ref = np.asarray(jp[key])
        ref = ref.transpose(0, 2, 3, 1).reshape(-1, ref.shape[1])
        np.testing.assert_array_equal(got.numpy(), ref[:U], key)
    # every unit carries its tile's step budget and mode
    np.testing.assert_array_equal(
        tp["kbound"].numpy(), np.repeat(np.asarray(jp["kbound"]), 1024, 0)[:U])
    if jp["has_stored"]:
        np.testing.assert_array_equal(tp["stored_gap"].numpy(),
                                      np.asarray(jp["stored_gap"])[:, :U])


def _stamp_cases():
    return ([("single_block", n) for n in BATCHES["single_block"]]
            + [("mixed", n) for n in BATCHES["mixed"]])


@pytest.mark.parametrize("batch,name", _stamp_cases(),
                         ids=[f"{b}-{n}" for b, n in _stamp_cases()])
def test_decode_stamp_reference_matches_pallas_kernel(batch, name, prepared):
    _, jp, tp, (attr, flag, s1, s2), (jattr, jflag, js1, js2) = \
        prepared(batch)
    i = BATCHES[batch].index(name)
    Ui = jp["Ui_pad"]
    rows = slice(i * Ui, (i + 1) * Ui)
    # compare attr on owned bytes only: past a unit's last token the TPU
    # kernel leaves the last token's stamp, the port leaves it uncovered
    owned = np.arange(OB)[None, :] < tp["meta"].numpy()[rows, 2:3]
    np.testing.assert_array_equal(attr.numpy()[rows][owned],
                                  jattr[rows][owned])
    np.testing.assert_array_equal(flag.numpy()[rows], jflag[rows])
    np.testing.assert_array_equal(s1.numpy()[rows], js1[rows])
    np.testing.assert_array_equal(s2.numpy()[rows], js2[rows])
    assert not flag.numpy()[rows].any()
    if name == "stored":
        assert not owned.any()   # stored units own no kernel bytes
    else:
        assert owned.all()


@pytest.mark.parametrize("batch", list(BATCHES))
def test_inflate_matches_jax_and_zlib(batch, prepared):
    jix, jp, tp, _, _ = prepared(batch)
    out, flag, adler, ovf = inflate_indexed_stamp(tp)
    jout, jflag, jadler = _jax_inflate(jp, jix)
    U = len(jix) * jp["Ui_pad"]
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_array_equal(flag.numpy(), jflag[:U])
    np.testing.assert_array_equal(adler.numpy(), jadler.astype(np.int64))
    assert ovf is False
    for i, name in enumerate(BATCHES[batch]):
        data = STREAMS[name][0]
        assert out[i].numpy().tobytes() == data, name
        assert int(adler[i]) == zlib.adler32(data), name


def test_corrupt_body_flags_the_same_streams():
    # the mixed batch with its first body corrupted, decoded with the
    # intact bodies' indexes (same shapes, so the JAX programs are reused)
    good = [STREAMS[n][1][2:-4] for n in BATCHES["mixed"]]
    bad = bytearray(good[0])
    for at in range(len(bad) // 3, len(bad) // 3 + 400):
        bad[at] ^= 0xA5
    bodies, jix, tix, jp, tp = _prepare([bytes(bad)] + good[1:], good)
    _, flag, _, _ = inflate_indexed_stamp(tp)
    _, jflag, _ = _jax_inflate(jp, jix)
    B, Ui = len(good), jp["Ui_pad"]
    per_stream = flag.numpy().reshape(B, Ui).any(1)
    np.testing.assert_array_equal(per_stream,
                                  jflag[:B * Ui].reshape(B, Ui).any(1))
    assert per_stream.tolist() == [True, False, False, False]
    with pytest.raises(JaxDecompressionError) as jerr:
        JaxInflator(ob=OB, backend="pallas").run(bodies, jix)
    with pytest.raises(DecompressionError) as terr:
        CheckpointInflator("cpu").run(bodies, tix)
    assert terr.value.case == jerr.value.case == "invalidHuffmanTable"


@pytest.mark.parametrize("case", ["mixed", "corrupt"])
def test_pool_and_ids_stamp_equals_per_unit_tables(case, prepared):
    # the plain K1 on the pool and ids against the Pallas kernel on JAX's
    # per-unit table copies; every unit runs its tile's step budget, so
    # on a corrupt body too the flags are equal, unit by unit
    if case == "mixed":
        _, jp, tp, got, want = prepared("mixed")
    else:
        good = [STREAMS[n][1][2:-4] for n in BATCHES["mixed"]]
        bad = bytearray(good[2])           # the multiblock stream's body
        for at in range(len(bad) // 2, len(bad) // 2 + 300):
            bad[at] ^= 0x3C
        _, _, _, jp, tp = _prepare(good[:2] + [bytes(bad)] + good[3:], good)
        got = decode_stamp_reference(*_k1_args(tp), ob=OB)
        want = _jax_stamp(jp)
    U = tp["meta"].shape[0]
    attr, flag, s1, s2 = (g.numpy() for g in got)
    jattr, jflag, js1, js2 = (w[:U] for w in want)
    B = len(BATCHES["mixed"])
    np.testing.assert_array_equal(flag, jflag)
    ok = flag == 0
    np.testing.assert_array_equal(s1[ok], js1[ok])
    np.testing.assert_array_equal(s2[ok], js2[ok])
    owned = (np.arange(OB)[None, :] < tp["meta"].numpy()[:, 2:3]) & ok[:, None]
    np.testing.assert_array_equal(attr[owned], jattr[owned])
    flagged = flag.reshape(B, -1).any(1)
    assert flagged.tolist() == ([False] * 4 if case == "mixed"
                                else [False, False, True, False])


# chip_smoke.py's seeded corruptions, each of a batch whose tiles run one
# step mode of the TPU kernel: (streams, streams the corruption picks
# from, the mode, seeds); "mixed" is this file's mixed batch
CORRUPT = chip_smoke.K1_CORRUPT


def _run_outcome(inflator, bodies, indexes, **kw):
    """The error case ``run`` raises, or its bytes and Adler-32."""
    try:
        out, adler = inflator.run(bodies, indexes, **kw)
    except (DecompressionError, JaxDecompressionError) as e:
        return e.case
    return np.asarray(out).tobytes(), np.asarray(adler).tolist()


@pytest.mark.parametrize(
    "batch,seed", [(b, s) for b, c in CORRUPT.items() for s in c[3]],
    ids=[f"{b}-{s}" for b, c in CORRUPT.items() for s in c[3]])
def test_corrupt_stream_decodes_as_pallas_kernel(batch, seed, monkeypatch):
    # a corrupt body decoded with its intact index: the plain K1 runs each
    # unit to its tile's step budget in its tile's mode, as the Pallas
    # kernel does, so flags, owned bytes, Adler partials and the outcome
    # of run are the JAX package's
    import swift_png_tpu.native as jax_native
    import swift_png_tpu_torch._host.native as torch_native
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(torch_native, "available", lambda: False)
    names, n_pick, mode, _ = CORRUPT[batch]
    good = [STREAMS[n][1][2:-4] for n in names]
    bodies, jix, tix, jp, tp = _prepare(
        chip_smoke.corrupt_bodies(good, n_pick, seed), good)
    assert np.asarray(jp["kbound"])[:, 1].tolist() == [mode]
    assert set(tp["kbound"][:, 1].tolist()) == {mode}
    attr, flag, s1, s2 = (g.numpy() for g in
                          decode_stamp_reference(*_k1_args(tp), ob=OB))
    U = flag.shape[0]
    jattr, jflag, js1, js2 = (w[:U] for w in _jax_stamp(jp))
    np.testing.assert_array_equal(flag, jflag)
    ok = flag == 0
    np.testing.assert_array_equal(s1[ok], js1[ok])
    np.testing.assert_array_equal(s2[ok], js2[ok])
    owned = (np.arange(OB)[None, :] < tp["meta"].numpy()[:, 2:3]) & ok[:, None]
    np.testing.assert_array_equal(attr[owned], jattr[owned])
    want = _run_outcome(JaxInflator(ob=OB, backend="pallas"), bodies, jix,
                        keep_on_device=False)
    assert _run_outcome(CheckpointInflator("cpu"), bodies, tix) == want


@pytest.mark.parametrize("bad_id", [-1, "P"])
def test_decode_stamp_rejects_ids_outside_the_pool(bad_id, prepared):
    tp = prepared("mixed")[2]
    ids = tp["ids"].clone()
    ids[5, 1] = tp["pool_t"].shape[0] if bad_id == "P" else bad_id
    args = list(_k1_args(tp))
    args[4] = ids
    with pytest.raises(ValueError, match="ids must index"):
        decode_stamp_reference(*args, ob=OB)


def _fifteen_bit_stream():
    """Fibonacci symbol counts, shuffled, Huffman-only at level 9: the
    rarest literals take 15-bit codes."""
    f = [1, 2]
    while len(f) < 18:
        f.append(f[-1] + f[-2])
    syms = np.repeat((np.arange(18) * 37 + 5) % 256, f)
    np.random.default_rng(7).shuffle(syms)
    data = syms.astype(np.uint8).tobytes()
    co = zlib.compressobj(9, zlib.DEFLATED, 15, 9, zlib.Z_HUFFMAN_ONLY)
    return data, co.compress(data) + co.flush()


def test_decode_stamp_fifteen_bit_codes_match_pallas_kernel():
    data, stream = _fifteen_bit_stream()
    body = stream[2:-4]
    n = len(data)
    jix = _build_index_host(body, n, OB)
    tix = build_index(body, n, OB)
    assert int(tix.lit_lengths.max()) == 15
    jp = JaxInflator(ob=OB, backend="pallas").prepare([body], [jix])
    tp = CheckpointInflator("cpu").prepare([body], [tix])
    attr, flag, s1, s2 = decode_stamp_reference(*_k1_args(tp), ob=OB)
    jattr, jflag, js1, js2 = _jax_stamp(jp)
    U = tix.units
    owned = np.arange(OB)[None, :] < tp["meta"].numpy()[:, 2:3]
    np.testing.assert_array_equal(attr.numpy()[owned], jattr[:U][owned])
    for g, w in ((flag, jflag), (s1, js1), (s2, js2)):
        np.testing.assert_array_equal(g.numpy(), w[:U])
    assert not flag.numpy().any()
    lit = attr.numpy()[owned]
    assert bytes((-lit - 1).astype(np.uint8)) == data


def test_prepare_keeps_one_table_row_per_block(prepared):
    jix, _, tp, _, _ = prepared("mixed")
    P = sum(ix.n_blocks for ix in jix)
    assert tuple(tp["pool_t"].shape) == (P, 72)
    assert tp["pool_s"].shape[0] == P
    assert tp["ids"].dtype == torch.int32
    assert tuple(tp["ids"].shape) == (len(jix) * tp["Ui"], 2)
    assert 0 <= int(tp["ids"].min()) and int(tp["ids"].max()) < P
    assert "tabs" not in tp and "symtab" not in tp


def test_expand_matches_is_forward_copy():
    rng = np.random.default_rng(9)
    n = 3000
    ptr = np.arange(n)
    litv = rng.integers(0, 256, n).astype(np.uint8)
    want = litv.copy()
    j = 1
    while j < n:   # random overlapping matches, copied byte by byte
        if rng.random() < 0.5:
            dist, run = int(rng.integers(1, min(j, 40) + 1)), \
                int(rng.integers(3, 60))
            for k in range(j, min(j + run, n)):
                ptr[k] = k - dist
                want[k] = want[k - dist]
            j += run
        else:
            j += 1
    got = expand_matches(torch.from_numpy(ptr), torch.from_numpy(litv))
    np.testing.assert_array_equal(got.numpy(), want)


def test_prepare_block_tables_matches_jax_per_block():
    from swift_png_tpu.ops.inflate_pallas import (
        prepare_block_tables as jax_tables)
    from swift_png_tpu_torch.ops.inflate_stamp import prepare_block_tables

    rng = np.random.default_rng(12)
    lits, dists = [], []
    for ix in (_build_index_host(s[2:-4], N, OB) for _, s in
               STREAMS.values()):
        lits += list(ix.lit_lengths)
        dists += list(ix.dist_lengths)
    # odd trees: one distance code, no distance codes, random junk lengths
    lits += [lits[0], lits[0], rng.integers(0, 20, 288)]
    dists += [np.eye(32, dtype=np.uint8)[3], np.zeros(32, np.uint8),
              rng.integers(0, 20, 32)]
    tabs, symtab = prepare_block_tables(np.stack(lits), np.stack(dists))
    for p, (lit, dist) in enumerate(zip(lits, dists)):
        want_t, want_s = jax_tables(lit, dist)
        np.testing.assert_array_equal(tabs[p], want_t)
        np.testing.assert_array_equal(symtab[p], want_s)
        one_t, one_s = prepare_block_tables(lit, dist)
        np.testing.assert_array_equal(one_t, want_t)
        np.testing.assert_array_equal(one_s, want_s)


@pytest.mark.parametrize("fault", ["bit_pos_past_body", "block_id"])
def test_prepare_rejects_index_pointing_outside_its_stream(fault):
    body = STREAMS["multiblock"][1][2:-4]
    ix = build_index(body, N, OB)
    if fault == "bit_pos_past_body":
        ix.bit_pos[-1] = np.uint64(8 * len(body) + 64)
    else:
        ix.unit_block[3] = ix.n_blocks
    with pytest.raises(DecompressionError):
        CheckpointInflator("cpu").prepare([body], [ix])
