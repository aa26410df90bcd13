"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; run them
on the card with ``python -m pytest --noconftest tests/test_torch_cuda.py``
(the suite's conftest pins JAX to the CPU, and the card's machine has no
JAX)."""

import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from swift_png_tpu_torch import BatchCodec, _kernels, decode_indexed
from swift_png_tpu_torch._host.lz77.index import build_index
from swift_png_tpu_torch.ops import deflate_optimal as tdo
from swift_png_tpu_torch.ops.deflate_emit import (emit_terms_cuda,
                                                  emit_terms_reference)
from swift_png_tpu_torch.ops.deinterlace import (deinterlace_samples,
                                                 pass_geometry)
from swift_png_tpu_torch._host.lz77.errors import DecompressionError
from swift_png_tpu_torch.ops.inflate_fused import (InflateFused,
                                                   inflate_fused,
                                                   inflate_fused_batch)
from swift_png_tpu_torch.ops.inflate_checkpoint import CheckpointInflator
from swift_png_tpu_torch.ops.inflate_seqcopy import (records_well_formed,
                                                     seqcopy_cuda,
                                                     seqcopy_reference)
from swift_png_tpu_torch.ops.inflate_stamp import (decode_stamp_cuda,
                                                   decode_stamp_reference)
from swift_png_tpu_torch.ops.unfilter import defilter_cuda, defilter_reference

pytestmark = pytest.mark.cuda
OB = 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(kind):
    """``(data, zlib stream, body to decode)``; ``corrupt`` decodes a body
    with bits flipped in its dynamic block under the intact body's index
    (1,000 bytes: each copy then flags a unit under its tile's budget)."""
    rng = np.random.default_rng(2)
    if kind in ("literal", "corrupt"):
        y = (np.sin(np.arange(40_000) / 9.0) * 50 + 128).astype(np.int64)
        data = np.clip(y + rng.integers(-6, 7, y.size), 0, 255).astype(
            np.uint8).tobytes()
        stream = zlib.compress(data, 6)
        body = bytearray(stream[2:-4])
        if kind == "corrupt":
            for at in range(len(body) // 3, len(body) // 3 + 1000):
                body[at] ^= 0xA5
        return data, stream, bytes(body)
    if kind == "stored":
        data = rng.integers(0, 256, 90_000, dtype=np.uint8).tobytes()
        stream = zlib.compress(data, 0)
    elif kind == "fifteen_bit":
        # Fibonacci symbol counts, Huffman-only: 15-bit literal codes
        f = [1, 2]
        while len(f) < 20:
            f.append(f[-1] + f[-2])
        syms = np.repeat((np.arange(20) * 37 + 5) % 256, f)
        rng.shuffle(syms)
        data = syms.astype(np.uint8).tobytes()
        co = zlib.compressobj(9, zlib.DEFLATED, 15, 9, zlib.Z_HUFFMAN_ONLY)
        stream = co.compress(data) + co.flush()
    else:
        data = (rng.integers(0, 8, 150_000) * 31 % 251).astype(
            np.uint8).tobytes()
        stream = zlib.compress(data, 6)      # multiblock (stdlib blocks)
    return data, stream, stream[2:-4]


@pytest.mark.parametrize("kind,ob", [("literal", 256), ("literal", 1024),
                                     ("stored", 256), ("multiblock", 256),
                                     ("corrupt", 256), ("fifteen_bit", 256)])
def test_decode_stamp_kernel_matches_plain(cuda, kind, ob):
    data, stream, body = _stream(kind)
    ix = build_index(stream[2:-4], len(data), ob)
    prep = CheckpointInflator(cuda).prepare([body] * 3, [ix] * 3)
    args = (prep["spans"], prep["meta"], prep["pool_t"], prep["pool_s"],
            prep["ids"], prep["kbound"])
    got = decode_stamp_cuda(*args, ob=ob)
    torch.cuda.synchronize()
    want = decode_stamp_reference(*args, ob=ob)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[1].any()) == (kind == "corrupt")
    if kind == "corrupt":
        return
    out, adler = CheckpointInflator(cuda).run([stream[2:-4]], [ix])
    assert out[0].cpu().numpy().tobytes() == data
    assert int(adler[0]) == zlib.adler32(data)


@pytest.mark.parametrize("batch", ["mixed", "literal", "dense"])
def test_decode_stamp_kernel_keeps_tile_budget_on_corrupt_bodies(cuda,
                                                                  batch):
    # the seeded corruptions of chip_smoke.py's k1_corrupt phase, each batch
    # in one step mode: K1 exact against its plain version, and run on the
    # card ends as run on the CPU does (same error case, or same bytes and
    # Adler-32)
    import chip_smoke as cs

    names, n_pick, mode, seeds = cs.K1_CORRUPT[batch]
    streams = cs.k1_corrupt_streams()
    good = [streams[n][1][2:-4] for n in names]
    indexes = [build_index(b, cs.K1C_N, OB) for b in good]
    eng, host = CheckpointInflator(cuda), CheckpointInflator("cpu")
    for seed in seeds:
        bodies = cs.corrupt_bodies(good, n_pick, seed)
        prep = eng.prepare(bodies, indexes)
        assert set(prep["kbound"][:, 1].tolist()) == {mode}
        args = (prep["spans"], prep["meta"], prep["pool_t"], prep["pool_s"],
                prep["ids"], prep["kbound"])
        got = decode_stamp_cuda(*args, ob=OB)
        torch.cuda.synchronize()
        for g, w in zip(got, decode_stamp_reference(*args, ob=OB)):
            assert torch.equal(g, w), seed
        assert (cs.run_outcome(eng, bodies, indexes)
                == cs.run_outcome(host, bodies, indexes)), seed


# delays 5 and 7 come from no PNG but are in the kernel's contract
ODD_PITCH = {1: 97, 2: 98, 3: 99, 4: 100, 5: 105, 6: 102, 7: 98, 8: 104}


@pytest.mark.parametrize("delay", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("height,pitch,offset", [
    (5, "wide", 0), (1100, "wide", 0),
    # what K3's memory path branches on: pitches that are not multiples of
    # 4 or 16, one pixel group, warp edges, a second row chunk, a base
    # pointer off 16-byte alignment
    (1, "odd", 3), (31, "odd", 5), (33, "odd", 1), (1100, "odd", 15),
    (33, "one_group", 7)])
def test_defilter_kernel_matches_plain(cuda, delay, height, pitch, offset):
    pitch = {"wide": 12 * delay, "odd": ODD_PITCH[delay],
             "one_group": delay}[pitch]
    B = 6 if height == 1 else 2
    rng = np.random.default_rng(delay)
    f = rng.integers(0, 256, (B, height, 1 + pitch), dtype=np.uint8)
    # every filter type (0..4 and one of 5..255) on at least one row
    kind = (np.arange(B)[:, None] + np.arange(height)[None, :]) % 6
    f[:, :, 0] = np.where(kind == 5, rng.integers(5, 256, kind.shape), kind)
    flat = torch.zeros(f.size + 16, dtype=torch.uint8, device=cuda)
    f_dev = flat[offset:offset + f.size].view(f.shape)
    f_dev.copy_(torch.from_numpy(f))
    assert f_dev.data_ptr() % 16 == offset
    got = defilter_cuda(f_dev, delay)
    torch.cuda.synchronize()
    assert torch.equal(got, defilter_reference(f_dev, delay))


def _png(W, H, stream, index_blob):
    """An rgba8 PNG with one IDAT and an ``spIx`` chunk."""
    def chunk(kind, data):
        return (len(data).to_bytes(4, "big") + kind + data
                + zlib.crc32(kind + data).to_bytes(4, "big"))

    return (bytes([137, 80, 78, 71, 13, 10, 26, 10])
            + chunk(b"IHDR", W.to_bytes(4, "big") + H.to_bytes(4, "big")
                    + bytes([8, 6, 0, 0, 0]))
            + chunk(b"IDAT", stream) + chunk(b"spIx", index_blob)
            + chunk(b"IEND", b""))


def test_decode_indexed_on_card_counts_launches(cuda):
    rng = np.random.default_rng(0)
    H, W = 64, 48
    px = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    rows = np.hstack([np.zeros((H, 1), np.uint8), px.reshape(H, W * 4)])
    s = zlib.compress(rows.tobytes(), 6)
    ix = build_index(s[2:-4], rows.size, OB)

    blob = _png(W, H, s, ix.serialize())
    _kernels.reset_launches()
    out = decode_indexed([blob, blob])
    assert out.device.type == "cuda"
    assert _kernels.launch_counts() == {"decode_stamp": 1, "defilter": 1,
                                        "seqcopy": 0, "cand": 0,
                                        "dp_parse": 0, "emit": 0,
                                        "inflate_stream": 0}
    assert torch.equal(out.cpu(), torch.from_numpy(np.stack([px, px])))


def _k2_case(B, n_recs, Rp, rng, smooth):
    """Records after ``tools/exp_seqcopy.py`` ``_make_case``."""
    lit = rng.integers(0, 256, (B, Rp * 128), dtype=np.uint8)
    recs, starts = [], [0]
    for _ in range(B):
        pos = 300
        for _ in range(n_recs):
            if smooth:
                d, ln = int(rng.choice([1, 2, 4, 8])), int(rng.integers(64,
                                                                         258))
            else:
                d = int(rng.integers(1, min(pos, 32768)))
                ln = int(rng.integers(3, 259))
            if pos + ln >= (Rp - 17) * 128:
                break
            recs.append((pos, d, ln))
            pos += ln + int(rng.integers(1, 40))
        starts.append(len(recs))
    return lit, np.asarray(recs, np.int32), np.asarray(starts, np.int32)


def _k2_holds(cuda, starts, recs, lit):
    """K2 on the card equals its plain version, and each stream took the
    path ``records_well_formed`` gives it; returns the paths."""
    args = [x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
            for x in (starts, recs, lit)]
    args = [x.to(cuda) for x in args]
    paths = torch.full((args[2].shape[0],), -1, dtype=torch.int32,
                       device=cuda)
    got = seqcopy_cuda(*args, paths=paths)
    torch.cuda.synchronize()
    assert torch.equal(got, seqcopy_reference(*args))
    ring = records_well_formed(args[0], args[1], args[2].shape[1])
    assert torch.equal(paths, ring.to(torch.int32))
    return paths.tolist()


@pytest.mark.parametrize("smooth", [False, True], ids=["random_d", "smooth"])
def test_seqcopy_kernel_matches_plain(cuda, smooth):
    lit, recs, starts = _k2_case(3, 300, 700, np.random.default_rng(5),
                                 smooth)
    assert _k2_holds(cuda, starts, recs, lit) == [1, 1, 1]


def test_seqcopy_kernel_keeps_hostile_records_in_their_row(cuda):
    lit = torch.arange(2 * 301, device=cuda).to(torch.uint8).reshape(2, 301)
    recs = torch.tensor([[-5, 3, 20], [290, 2, 50], [10, 0, 5],
                         [5, 20, 10], [0, 1, 0]], dtype=torch.int32,
                        device=cuda)
    starts = torch.tensor([0, 3, 5], dtype=torch.int32, device=cuda)
    assert _k2_holds(cuda, starts, recs, lit) == [0, 0]


K2_CASES = ["row_crossing", "long", "many", "noop_runs", "mixed",
            "odd_opad", "no_records"]


@pytest.mark.parametrize("name", K2_CASES)
def test_seqcopy_kernel_ring_and_global_paths(cuda, name):
    """``chip_smoke.py``'s K2 cases: runs through the ring several times,
    more records than one staged batch, runs of 64 to 200 ``len = 0``
    records between well-formed ones, a hostile stream (global path)
    among well-formed ones, rows off 16-byte alignment, no records."""
    rng = np.random.default_rng(6)
    if name in ("odd_opad", "no_records"):
        lit, recs, starts = chip_smoke.k2_edge_cases(rng)[name]
    else:
        lit, recs, starts = {
            "row_crossing": lambda: chip_smoke.k2_rows_case(3, 300_000, rng),
            "long": lambda: chip_smoke.k2_long_case(1 << 20, 600_000, rng),
            "many": lambda: chip_smoke.k2_many_case(3000, rng),
            "noop_runs": lambda: chip_smoke.k2_noop_case(rng),
            "mixed": lambda: chip_smoke.k2_mixed_case(rng)}[name]()
    paths = _k2_holds(cuda, starts, recs, lit)
    assert paths == ([1, 0, 1, 1] if name == "mixed" else [1] * len(paths))


def test_decode_indexed_records_mode_on_card(cuda):
    H = W = 128
    y, x = np.mgrid[0:H, 0:W]
    pngs, images = [], []
    for i in range(3):
        px = np.stack([(x // 8 + y // 8 + i) % 256, x // 4 % 256,
                       y // 4 % 256, np.full_like(x, 255)],
                      axis=-1).astype(np.uint8)
        # Up on every row: smooth content becomes a few long matches
        raw = px.reshape(H, W * 4).astype(np.int32)
        up = np.vstack([np.zeros((1, W * 4), np.int32), raw[:-1]])
        rows = np.hstack([np.full((H, 1), 2, np.uint8),
                          ((raw - up) & 255).astype(np.uint8)])
        s = zlib.compress(rows.tobytes(), 6)
        ix = build_index(s[2:-4], rows.size, OB)
        pngs.append(_png(W, H, s, ix.serialize()))
        images.append(px)
    _kernels.reset_launches()
    out = decode_indexed(pngs)
    assert _kernels.launch_counts() == {"decode_stamp": 1, "defilter": 1,
                                        "seqcopy": 1, "cand": 0,
                                        "dp_parse": 0, "emit": 0,
                                        "inflate_stream": 0}
    assert torch.equal(out.cpu(), torch.from_numpy(np.stack(images)))


def _encode_case(cuda):
    """Two streams of one tile each (noisy waves, and rows repeated with
    small changes and a flat run), per-image menus padded with 0 slots."""
    rng = np.random.default_rng(11)
    tile = tdo.TILE
    ns = [20_500, 9_001]
    data = np.zeros(2 * tile, np.uint8)
    y = (np.sin(np.arange(ns[0]) / 7.0) * 60 + 128).astype(np.int64)
    data[:ns[0]] = np.clip(y + rng.integers(-9, 10, ns[0]), 0, 255)
    row = rng.integers(0, 256, 200, dtype=np.uint8)
    rows = (np.tile(row, 46)[:ns[1]]
            + np.repeat(np.arange(46), 200)[:ns[1]] % 3)
    data[tile:tile + ns[1]] = rows
    data[tile + 3000: tile + 5000] = 7
    plan = tdo._batch_inputs([data[:ns[0]].tobytes(),
                              data[tile:tile + ns[1]].tobytes()],
                             4, 200, cuda)
    return plan


def test_cand_kernel_matches_plain(cuda):
    p = _encode_case(cuda)
    args = (p["dists2"], p["decades2"], p["dbuf"], p["nvec"])
    got = tdo.menu_candidates_cuda(*args, dmax=p["dmax"], stride=p["stride"])
    torch.cuda.synchronize()
    want = tdo.menu_candidates_reference(*args, dmax=p["dmax"],
                                         stride=p["stride"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["residues_far_d", "d_at_least_n",
                                  "all_zero", "equal_scores", "dmax8",
                                  "dmax32", "costs_outside_keys"])
def test_cand_kernel_edge_cases(cuda, name):
    # chip_smoke.py's K4 edge cases, the bytes 1..15 bytes off 16-byte
    # alignment so the kernel's edge reads are guarded
    import chip_smoke as cs

    data, nvec, dv, cv = cs.k4_edge_cases()[name]
    off = 1 + len(name) % 15
    flat = torch.zeros(data.size + 32, dtype=torch.uint8, device=cuda)
    d = flat[off:off + data.size]
    d.copy_(torch.from_numpy(data))
    args = [torch.from_numpy(x).to(cuda) for x in (dv, cv)]
    nv = torch.from_numpy(nvec).to(cuda)
    kw = dict(dmax=dv.shape[1], stride=cs.K4_STRIDE)
    got = tdo.menu_candidates_cuda(*args, d, nv, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, tdo.menu_candidates_reference(*args, d, nv, **kw))


def test_dp_parse_and_emit_kernels_match_plain(cuda):
    p = _encode_case(cuda)
    cand = tdo.menu_candidates_cuda(p["dists2"], p["decades2"], p["dbuf"],
                                    p["nvec"], dmax=p["dmax"],
                                    stride=p["stride"])
    rng = np.random.default_rng(5)
    tabs = [torch.from_numpy(rng.integers(6, 60, (2, w)).astype(np.int32)
                             ).to(cuda) for w in (256, 256, 32)]
    # costs up to about 2^17 per edge, and the level's own size
    for scale in (2000, 1):
        args = (p["dbuf"], p["clen"], cand, *[t * scale for t in tabs])
        got = tdo.optimal_parse_cuda(*args, tpi=1)
        torch.cuda.synchronize()
        want = tdo.optimal_parse_reference(*args, tpi=1)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # entries that could wrap an int32 cost are refused
    for big in (tdo.DP_COST_CAP, -1):
        bad = [t.clone() for t in tabs]
        bad[0][1, 7] = big
        with pytest.raises(ValueError, match="cost table"):
            tdo.optimal_parse_cuda(p["dbuf"], p["clen"], cand, *bad, tpi=1)
    # built to tie: zeros (candidates d = 1 and 2) and a period-2 pattern
    # (d = 2 and 4) cost the same at every length under generic tables
    for data in (bytes(9_000), bytes([0x21, 0x7E]) * 4_500):
        q = tdo._batch_inputs([data, data], 4, 200, cuda)
        qc = tdo.menu_candidates_cuda(q["dists2"], q["decades2"], q["dbuf"],
                                      q["nvec"], dmax=q["dmax"],
                                      stride=q["stride"])
        qargs = (q["dbuf"], q["clen"], qc, *tdo._initial_tables(q, 9)[:3])
        tie = tdo.optimal_parse_cuda(*qargs, tpi=1)
        torch.cuda.synchronize()
        for g, w in zip(tie, tdo.optimal_parse_reference(*qargs, tpi=1)):
            assert torch.equal(g, w)
    terms, _, hist = got
    etabs = torch.from_numpy(tdo._host_trees(
        hist.cpu().numpy().astype(np.int64))[1]).to(cuda)
    for per_image in (tdo.TILE, 1024):
        t = terms[: 2 * per_image]
        e = emit_terms_cuda(t, etabs, per_image)
        torch.cuda.synchronize()
        for g, w in zip(e, emit_terms_reference(t, etabs, per_image)):
            assert torch.equal(g, w)


def test_encode_on_card_decodes_back(cuda, monkeypatch):
    # the card's parse against the CPU's plain versions of it: with the
    # native library on, a CPU device would encode natively and the strict
    # policy could ship native streams, so both run without it
    from swift_png_tpu_torch._host import native

    monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (2, 48, 64, 4)).astype(np.uint8)
    px[1] = px[1] // 16 * 16
    _kernels.reset_launches()
    pngs = BatchCodec().encode(px, level=9, kind="rgba8", index=True)
    counts = _kernels.launch_counts()
    assert (counts["cand"], counts["dp_parse"], counts["emit"]) == (1, 4, 1)
    assert pngs == BatchCodec("cpu").encode(px, level=9, kind="rgba8",
                                            index=True)
    _kernels.reset_launches()
    out = decode_indexed(pngs)
    assert _kernels.launch_counts()["decode_stamp"] == 1
    assert torch.equal(out.cpu(), torch.from_numpy(px))


@pytest.mark.parametrize("kind", ["literal", "stored", "multiblock",
                                  "fifteen_bit", "host_tier"])
def test_native_library_builds_and_matches_host_walk_and_zlib(cuda, kind):
    # the port's native host library on the card's machine: it builds
    # there (g++, at first use), its index walk gives the Python walk's
    # index, and its threaded inflate gives zlib's bytes
    from swift_png_tpu_torch._host import native
    from swift_png_tpu_torch._host.lz77.index import _build_index_host

    assert native.available(), native.last_error()
    if kind == "host_tier":
        datas, streams = chip_smoke.host_tier_inputs(4, 64, 64)[:2]
    else:
        data, stream, _ = _stream(kind)
        datas, streams = [data], [stream]
    for data, stream in zip(datas, streams):
        got = build_index(stream[2:-4], len(data), OB)
        want = _build_index_host(stream[2:-4], len(data), OB)
        assert got.serialize() == want.serialize()
    outs = native.inflate_batch([s[2:-4] for s in streams],
                                [len(d) for d in datas], "ios")
    assert outs == [zlib.decompress(s) for s in streams] == datas


def test_device_parse_with_native_sampling_matches_plain(cuda):
    # with the native library on, each menu gains sampled distances and the
    # cost model starts warm: the card's streams equal the plain versions'
    datas = [chip_smoke.filter_rows(chip_smoke.bench_image(s, 48, 64)
                                    .reshape(48, 256), 4).tobytes()
             for s in range(2)]
    plan = tdo._batch_inputs(datas, 4, 257, cuda)
    assert plan["lit_fs"][0] is not None
    _kernels.reset_launches()
    got = tdo.deflate_device_optimal_batch(datas, level=9, pitch=257,
                                           device=cuda)
    assert _kernels.launch_counts()["dp_parse"] == \
        tdo._initial_tables(plan, 9)[3]
    assert got == tdo.deflate_device_optimal_batch(datas, level=9,
                                                   pitch=257, device="cpu")
    assert [zlib.decompress(s) for s in got] == datas


def _general_batch(config, n=3, h=37, w=29):
    rng = np.random.default_rng(5)
    px = rng.integers(0, 256, (n, h, w, 4), dtype=np.uint8)
    return px, [chip_smoke.general_png(p, config, hint=999) for p in px]


@pytest.mark.parametrize("config", chip_smoke.GD_CONFIGS)
def test_general_decode_on_card_matches_cpu(cuda, config):
    """``BatchCodec().decode`` of ordinary rgba8, Adam7 and CgBI PNGs on the
    card: its intermediates on the card, K3 once per image shape or Adam7
    pass, pixels equal to the CPU port's and to the source."""
    px, pngs = _general_batch(config)
    codec = BatchCodec()
    assert codec.device.type == "cuda"
    flat, info = codec.decode_filtered(pngs, keep_on_device=True)
    assert flat.device.type == "cuda"
    passes = pass_geometry(info["size"], 32)[0]
    _kernels.reset_launches()
    out = codec.decode(pngs, keep_on_device=True)
    assert out.device.type == "cuda"
    assert _kernels.launch_counts()["defilter"] == (
        len(passes) if config == "adam7" else 1)
    assert torch.equal(out.cpu(), torch.from_numpy(px))
    cpu = BatchCodec(device="cpu").decode(pngs)
    assert np.array_equal(out.cpu().numpy(), cpu)
    host = codec.decode(pngs, bits=16, device_inflate=False)
    assert np.array_equal(host, BatchCodec(device="cpu").decode(pngs,
                                                                bits=16))


def test_inflate_fused_on_card_matches_cpu(cuda):
    """The fused inflate's every field on the card (one ``inflate_stream``
    launch) and on the CPU (the plain version), on valid streams and seeded
    corruptions in one batch, rows past the stream zero or random."""
    rng = np.random.default_rng(9)
    data = bytes(rng.integers(0, 16, 20000, dtype=np.uint8))
    body = zlib.compress(data, 6)[2:]
    n = 1 << 16
    Ds = np.zeros((12, n), np.uint8)
    for i in range(12):
        Ds[i, :len(body)] = np.frombuffer(body, np.uint8)
        if i >= 2:
            bit = int(rng.integers(0, 8 * len(body)))
            Ds[i, bit >> 3] ^= 1 << (bit & 7)
        if i >= 8:
            Ds[i, len(body):] = rng.integers(0, 256, n - len(body))
    kw = dict(out_size=len(data), win_words=1 << 14, t_max=1 << 15,
              max_blocks=1 << 14, tok_cap=len(data) + 1)
    _kernels.reset_launches()
    got = inflate_fused_batch(torch.from_numpy(Ds).to(cuda), **kw)
    assert _kernels.launch_counts()["inflate_stream"] == 1
    want = inflate_fused_batch(torch.from_numpy(Ds), **kw)
    assert got[0].device.type == "cuda"
    assert torch.equal(got[0].cpu(), want[0])
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g, w)
    assert got[1][0] == 0 and bytes(got[0][0, :len(data)].cpu()) == data


def test_inflate_fused_on_card_takes_any_row(cuda):
    """``inflate_fused`` on the card of a row that starts at an odd address
    and whose length is no multiple of 4 (the kernel reads aligned words:
    the row is copied) gives what the CPU gives; a row shorter than its
    windows raises ``ValueError``, as ``lax.dynamic_slice`` refuses it."""
    data = bytes(range(256)) * 40
    body = zlib.compress(data, 6)[2:]
    kw = dict(out_size=len(data), win_words=1 << 12, t_max=1 << 12,
              max_blocks=1 << 14, tok_cap=len(data) + 1)
    buf = np.zeros(1 + len(body) + (1 << 12) + 9, np.uint8)
    buf[1:1 + len(body)] = np.frombuffer(body, np.uint8)
    row = torch.from_numpy(buf).to(cuda)[1:]
    assert row.data_ptr() % 4 and row.shape[0] % 4
    got = inflate_fused(row, **kw)
    want = inflate_fused(torch.from_numpy(buf[1:]), **kw)
    assert torch.equal(got[0].cpu(), want[0]) and got[1:] == want[1:]
    assert got[1] == 0 and bytes(got[0][:len(data)].cpu()) == data
    with pytest.raises(ValueError, match="shorter"):
        inflate_fused(row[:1 << 10], **kw)


def _run_outcome(eng, fn, size):
    """The bytes and Adler-32 (or Adler-32 and CRC check) ``fn`` gives, or
    its error's class and case; with the engine's ``last_run``."""
    try:
        out = fn()
        if isinstance(out, tuple):
            out, adler = out
            got = bytes(out[:size].cpu().numpy()), adler
        else:
            got = bytes(out.cpu().numpy() if isinstance(out, torch.Tensor)
                        else out)
    except DecompressionError as e:
        got = type(e).__name__, e.case
    return got, dict(eng.last_run)


INFLATE_CASES = chip_smoke.inflate_stream_cases()


@pytest.mark.parametrize("name", list(INFLATE_CASES))
def test_inflate_stream_matches_cpu(cuda, name):
    """``InflateFused.run`` on the card (one ``inflate_stream`` launch) and
    on the CPU (the plain loop with its budget retries): the same bytes and
    Adler-32 or the same error, and the same blocks and retries."""
    body, size = INFLATE_CASES[name]
    card = InflateFused(device=cuda)
    _kernels.reset_launches()
    got = _run_outcome(card, lambda: card.run(body, size), size)
    assert _kernels.launch_counts()["inflate_stream"] == 1
    cpu = InflateFused(device="cpu")
    assert got == _run_outcome(cpu, lambda: cpu.run(body, size), size)


@pytest.mark.parametrize("fmt", ["zlib", "ios", "gzip"])
@pytest.mark.parametrize("budget", [{}, {"win_bytes": 64, "t_max": 8}],
                         ids=["default", "retries"])
def test_inflate_stream_formats_and_retries(cuda, fmt, budget):
    """``InflateFused.inflate`` on the card against the CPU for a zlib, a
    raw (CgBI, "ios") and a gzip stream, at the default budgets and at
    budgets so small that the plain loop retries up to its ceilings."""
    import gzip
    data = chip_smoke.inflate_stream_cases(corrupt=0)
    body, size = data["blocks64"]
    raw = zlib.decompressobj(-15).decompress(body)
    stream = {"zlib": zlib.compress(raw, 9), "ios": body,
              "gzip": gzip.compress(raw, 6, mtime=0)}[fmt]
    card = InflateFused(device=cuda, **budget)
    cpu = InflateFused(device="cpu", **budget)
    got = _run_outcome(card, lambda: card.inflate(stream, size, fmt), size)
    want = _run_outcome(cpu, lambda: cpu.inflate(stream, size, fmt), size)
    assert got == want and got[0] == raw
    assert (got[1]["retries"] > 0) == bool(budget)


def test_general_decode_launches_inflate_stream_once_an_image(cuda):
    """``BatchCodec.decode`` of ordinary PNGs on the card: one
    ``inflate_stream`` launch an image, pixels equal to the CPU decode."""
    px, pngs = _general_batch("rgba8", n=4)
    _kernels.reset_launches()
    out = BatchCodec(cuda).decode(pngs)
    assert _kernels.launch_counts()["inflate_stream"] == 4
    assert np.array_equal(out, BatchCodec(device="cpu").decode(pngs))
    assert np.array_equal(out, px)


@pytest.mark.parametrize("size", [(1, 1), (3, 5), (9, 17), (33, 31)])
@pytest.mark.parametrize("depth,channels", [(1, 1), (8, 3), (16, 4), (8, 2)])
def test_deinterlace_on_card_matches_cpu(cuda, size, depth, channels):
    """Adam7 passes through K3 at heights and widths down to 1 and pitches
    off multiples of 16."""
    passes, total = pass_geometry(size, depth * channels)
    flat = np.random.default_rng(depth + size[0]).integers(
        0, 256, (3, total), dtype=np.uint8)
    _kernels.reset_launches()
    got = deinterlace_samples(torch.from_numpy(flat).to(cuda), size=size,
                              depth=depth, channels=channels)
    assert _kernels.launch_counts()["defilter"] == len(passes)
    want = deinterlace_samples(torch.from_numpy(flat), size=size,
                               depth=depth, channels=channels)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("lazy", [False, True], ids=["greedy", "lazy"])
@pytest.mark.parametrize("short_far", [0, 1024])
def test_greedy_tokens_on_card_match_cpu(cuda, lazy, short_far):
    """The greedy match search's terms on the card equal the CPU's (the
    int64 key sort, the scatter-max, the pointer jumping)."""
    from swift_png_tpu_torch.ops.deflate import greedy_tokens

    px = chip_smoke.bench_image(4, 64, 96)
    data = chip_smoke.filter_rows(px.reshape(64, 96 * 4), 4).tobytes()
    n, N = len(data), 1 << 15
    buf = torch.zeros(N, dtype=torch.uint8)
    buf[:n] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    kw = dict(t_cap=N, lazy=lazy, min_run=4 if short_far else 6,
              short_far=short_far)
    got = greedy_tokens(buf.to(cuda), n, **kw)
    want = greedy_tokens(buf, n, **kw)
    assert got[2] == want[2]
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("case", ["adam7", "indexed8", "shared", "bgra8"])
def test_encode_general_on_card_matches_cpu(cuda, case, monkeypatch):
    """``BatchCodec().encode`` beyond the plain kinds on the card: the same
    PNG bytes as on the CPU (both without the native library), with K4, K5
    and K6 or, for shared trees, K6 once launched on the card."""
    from swift_png_tpu_torch._host import native
    from swift_png_tpu_torch._host.png import parsing
    from swift_png_tpu_torch._host.png.metadata import Metadata

    monkeypatch.setattr(native, "available", lambda: False)
    px = np.stack([chip_smoke.bench_image(s, 40, 56) for s in range(2)])
    kw = dict(level=9, kind="rgba8")
    if case == "adam7":
        kw["interlaced"] = True
    elif case == "indexed8":
        idx, pals = chip_smoke.indexed_images(2, 40, 56)
        px = idx
        kw.update(kind="indexed8", palettes=pals, index=True)
    elif case == "shared":
        kw.update(level=6, shared_trees=True)
    else:
        kw.update(kind="bgra8", metadata=Metadata(
            gamma=parsing.Gamma(50000),
            color_profile=parsing.ColorProfile("p", bytes(300))))
    _kernels.reset_launches()
    pngs = BatchCodec().encode(px, **kw)
    counts = _kernels.launch_counts()
    if case == "shared":
        assert counts["emit"] == 1 and counts["cand"] == 0
    else:
        assert (counts["cand"], counts["dp_parse"], counts["emit"]) == (
            1, 4, 1)
    assert pngs == BatchCodec("cpu").encode(px, **kw)


def test_deflate_segmented_on_card_matches_cpu(cuda):
    """``deflate_segmented`` of 60,000 bytes in 8 segments: the card's
    stream is the CPU's, with K6 launched once for every segment."""
    from swift_png_tpu_torch.parallel import deflate_segmented

    rng = np.random.default_rng(8)
    data = np.tile(rng.integers(0, 256, 700, dtype=np.uint8), 90)
    data[::7] = rng.integers(0, 256, data[::7].size, dtype=np.uint8)
    data = data[:60_000].tobytes()
    _kernels.reset_launches()
    got = deflate_segmented(data, 6, 8)
    assert _kernels.launch_counts()["emit"] == 1
    assert got == deflate_segmented(data, 6, 8, device="cpu")
    assert zlib.decompress(got) == data


@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL mesh on the card (``global_mesh()``), torn down
    after the test."""
    from swift_png_tpu_torch.parallel.distributed import global_mesh, shutdown

    mesh = global_mesh()
    try:
        assert torch.distributed.get_backend() == "nccl"
        yield mesh
    finally:
        shutdown()


@pytest.mark.parametrize("call", ["encode", "decode", "filter_select"])
def test_one_rank_nccl_mesh_matches_no_mesh(nccl_mesh, call):
    """``BatchCodec(mesh)``'s encode and decode and
    ``filter_select_sharded`` on a one-rank NCCL mesh equal the calls
    without a mesh."""
    from swift_png_tpu_torch.ops.filter import filter_select_batch
    from swift_png_tpu_torch.parallel import filter_select_sharded

    px = np.stack([chip_smoke.bench_image(s, 40, 56) for s in range(3)])
    codec = BatchCodec(mesh=nccl_mesh)
    assert codec.device == torch.device("cuda", 0)
    if call == "encode":
        _kernels.reset_launches()
        got = codec.encode(px, level=9)
        assert _kernels.launch_counts()["emit"] >= 1
        assert got == BatchCodec().encode(px, level=9)
    elif call == "decode":
        pngs = [chip_smoke.general_png(p, "rgba8") for p in px]
        got = codec.decode(pngs, keep_on_device=True)
        assert torch.equal(got, BatchCodec().decode(pngs,
                                                    keep_on_device=True))
        assert torch.equal(got.cpu(), torch.from_numpy(px))
    else:
        rows = torch.from_numpy(px.reshape(3, 40, 56 * 4)).cuda()
        assert torch.equal(filter_select_sharded(nccl_mesh, rows, 4),
                           filter_select_batch(rows, 4))


@pytest.mark.parametrize("bits", [8, 16])
def test_convolve_twins_on_card_match_cpu(cuda, bits):
    """``samples_to_va`` (plain, keyed, indexed), ``premultiply`` and
    ``straighten`` on the card equal the same calls on the CPU."""
    from swift_png_tpu_torch.ops import convolve

    rng = np.random.default_rng(bits)
    dt = torch.uint8 if bits == 8 else torch.uint16
    raw = torch.from_numpy(rng.integers(0, 1 << 16, (2, 33, 47, 4),
                                        dtype=np.int64).astype(np.int32))
    pal = torch.from_numpy(rng.integers(0, 256, (2, 256, 4), dtype=np.int64))
    key = raw[:, 0, 0, :3].clone()
    cases = [dict(raw=raw, depth=16, channels=4),
             dict(raw=raw[..., :3], depth=16, channels=3, has_key=True,
                  key=key),
             dict(raw=raw[..., :3] >> 8, depth=8, channels=3, is_bgr=True),
             dict(raw=raw[..., :1] >> 8, depth=8, channels=1,
                  is_indexed=True, palette=pal)]
    for kw in cases:
        on_card = {k: v.to(cuda) if torch.is_tensor(v) else v
                   for k, v in kw.items()}
        want = convolve.samples_to_va(kw.pop("raw"), bits=bits, **kw)
        got = convolve.samples_to_va(on_card.pop("raw"), bits=bits,
                                     **on_card)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
    c = (raw[..., :3] >> (16 - bits)).to(dt)
    a = (raw[..., 3:] >> (16 - bits)).to(dt).expand_as(c)
    for fn in (convolve.premultiply, convolve.straighten):
        got = fn(c.to(cuda), a.to(cuda))
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), fn(c, a))


@pytest.mark.parametrize("config", ["rgba8", "adam7", "cgbi"])
def test_single_image_decode_matches_batch_decode_on_card(cuda, config):
    """``Image.decompress_bytes(p).unpack_rgba8()`` (host) equals
    ``BatchCodec().decode([p])`` on the card, and the source."""
    from swift_png_tpu_torch.png import Image

    px = chip_smoke.bench_image(3, 40, 56)
    p = chip_smoke.general_png(px, config)
    host = Image.decompress_bytes(p).unpack_rgba8()
    card = BatchCodec().decode([p], keep_on_device=True)
    assert card.device.type == "cuda"
    assert np.array_equal(card[0].cpu().numpy(), host)
    assert np.array_equal(host, px)


@pytest.mark.parametrize("name", ["indexed_decode", "batch_decode_cuda"])
def test_device_examples_run_on_card(cuda, name, tmp_path):
    """The two device examples with no device named: pixels exact, K1 and
    K3 launched by ``indexed_decode``, K3 by ``batch_decode_cuda`` (on a
    one-rank NCCL mesh from ``global_mesh()``, torn down after)."""
    import importlib

    from swift_png_tpu_torch.parallel.distributed import shutdown
    from swift_png_tpu_torch.png import Image

    example = importlib.import_module(f"swift_png_tpu_torch.examples.{name}")
    _kernels.reset_launches()
    if name == "indexed_decode":
        files, got = example.main()
        want = [Image.decompress_bytes(f).unpack_rgba8() for f in files]
        launched = ("decode_stamp", "defilter")
    else:
        want = [chip_smoke.bench_image(s, 40, 56) for s in range(3)]
        paths = [str(tmp_path / f"{s}.png") for s in range(3)]
        for path, px in zip(paths, want):
            open(path, "wb").write(chip_smoke.general_png(px, "rgba8"))
        try:
            got = example.main(paths)
            assert torch.distributed.get_backend() == "nccl"
        finally:
            shutdown()
        launched = ("defilter",)
    assert np.array_equal(np.stack(got), np.stack(want))
    counts = _kernels.launch_counts()
    assert all(counts[k] >= 1 for k in launched), counts
