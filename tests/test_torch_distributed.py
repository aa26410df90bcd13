"""The port's scale-out layer across processes: gloo ranks on the CPU,
against the port without a mesh and against the JAX package.

Two module fixtures each spawn one job (4 ranks on a 2 × 2 ``(images,
rows)`` mesh, and 2 ranks on 2 × 1), each under a deadline that kills its
ranks.  Every rank runs torch on one thread: ``initialize``,
``global_mesh``, an ``all_reduce`` and the Adler-32 combine (the
counterpart of ``test_distributed_multiprocess.py``), then
``filter_select_sharded``, ``BatchCodec(mesh)``'s ``decode``,
``decode_filtered`` and ``encode``, ``deflate_segmented(mesh)`` and
``CorpusDecoder(mesh)`` on inputs that this process makes from seeds and
hands over in a file; the ranks' results come back the same way.  No
result may depend on the rank.  ``dryrun_multichip(4)`` spawns a job of
its own."""

import os
import pickle
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
import conftest  # noqa: F401

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from swift_png_tpu.ops.filter import filter_select_batch as jax_filter
from swift_png_tpu.parallel import corpus as jax_corpus
from swift_png_tpu.parallel.batch import BatchCodec as JaxBatchCodec
from swift_png_tpu.parallel.batch import (
    filter_select_sharded as jax_filter_sharded)
from swift_png_tpu.parallel.blocks import (
    deflate_segmented as jax_deflate_segmented)
from swift_png_tpu_torch import BatchCodec
from swift_png_tpu_torch._host import native
from swift_png_tpu_torch.ops.filter import filter_select_batch
from swift_png_tpu_torch.parallel import corpus
from swift_png_tpu_torch.parallel.blocks import deflate_segmented
from swift_png_tpu_torch.parallel.distributed import free_port
from swift_png_tpu_torch.parallel.dryrun import dryrun_multichip
from test_torch_scale_out import _payload, corpus_set

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 240          # seconds a job may take before its ranks are killed
DELAYS = [1, 3, 4, 8]
B, H = 4, 8             # filter select: 4 images of 8 rows, 2 × 2 blocks
SEGMENT_CASES = [(4097, 8), (60_000, 8), (60_000, 3), (30_000, 1)]

WORKER = r"""
import pickle, sys, zlib
import numpy as np
import torch
torch.set_num_threads(1)

from swift_png_tpu_torch import BatchCodec
from swift_png_tpu_torch.parallel import corpus
from swift_png_tpu_torch.parallel.batch import filter_select_sharded
from swift_png_tpu_torch.parallel.blocks import deflate_segmented
from swift_png_tpu_torch.parallel.distributed import (
    axis_block, combine_adler_shards, global_mesh, initialize, shutdown)
import torch.distributed as dist

coord, n, rank, folder = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
with open(f"{folder}/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
initialize(coord, n, rank, backend="gloo")
try:
    out = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    # an all_reduce over the job, and the Adler-32 of a stream whose
    # shards each process checksums
    total = torch.tensor([rank + 1], dtype=torch.int64)
    dist.all_reduce(total)
    out["all_reduce"] = int(total)
    whole = inp["whole"]
    part = -(-len(whole) // n)
    shards = [whole[i * part:(i + 1) * part] for i in range(n)]
    adlers = [None] * n
    dist.all_gather_object(adlers, (zlib.adler32(shards[rank]),
                                    len(shards[rank])))
    out["adler"] = combine_adler_shards(adlers)
    if n % 3:
        try:
            global_mesh(rows=3)
            out["rows3"] = None
        except ValueError as e:
            out["rows3"] = str(e)

    rows = 2 if n == 4 else 1
    mesh = global_mesh(rows=rows)
    out["mesh"] = list(mesh.mesh.shape)
    # filter select: this rank's (images, rows) block
    b_lo, b_hi, _ = axis_block(mesh, "images", inp["filter_rows"][1].shape[0])
    h = inp["filter_rows"][1].shape[1] // rows
    r = mesh.get_local_rank("rows")
    out["filter"] = {
        delay: filter_select_sharded(
            mesh, torch.from_numpy(x[b_lo:b_hi, r * h:(r + 1) * h].copy()),
            delay).numpy()
        for delay, x in inp["filter_rows"].items()}
    out["filter_block"] = (b_lo, b_hi, r * h, (r + 1) * h)

    codec = BatchCodec(mesh=mesh)
    out["decode"] = {name: codec.decode(pngs, bits=bits)
                     for name, (pngs, bits) in inp["decode"].items()}
    out["decode_filtered"] = {
        name: codec.decode_filtered(pngs)[0]
        for name, (pngs, _) in inp["decode"].items()}
    out["encode"] = {level: codec.encode(inp["pixels"], level=level)
                     for level in inp["levels"]}
    out["segmented"] = {
        (size, segs): deflate_segmented(inp["payloads"][size], 6, segs,
                                        mesh=mesh)
        for size, segs in inp["segment_cases"]}
    out["corpus"] = corpus.CorpusDecoder(mesh=mesh, batch_size=2).decode(
        inp["corpus"])
    buckets = corpus.bucket(inp["corpus"])
    out["shard_keys"] = sorted(map(repr, corpus.shard_buckets(buckets, rank,
                                                              n)))
finally:
    shutdown()
with open(f"{folder}/rank{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
"""


def _spawn(folder, n):
    """Run WORKER as ``n`` ranks of one gloo job; kill every rank when the
    job is not done by the deadline.  Returns each rank's results."""
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs, procs = [], []
    try:
        for rank in range(n):
            log = open(os.path.join(folder, f"rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, coord, str(n), str(rank),
                 folder], stdout=log, stderr=subprocess.STDOUT, env=env))
        end = time.monotonic() + DEADLINE
        for p in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a {n}-rank job was not done in {DEADLINE} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(folder, f"rank{rank}.log")) as f:
                pytest.fail(f"rank {rank} of {n} failed "
                            f"({p.returncode}):\n{f.read()[-3000:]}")
    out = []
    for rank in range(n):
        with open(os.path.join(folder, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _decode_sets():
    """``{name: (PNGs of one bucket, bits)}``: five images, so the image
    blocks are uneven on two ranks, and one (``one``), so that a rank's
    block is empty."""
    rng = np.random.default_rng(4)
    px = rng.integers(0, 256, (5, 10, 12, 4), dtype=np.uint8)
    return {
        "rgba8": ([chip_smoke.general_png(p, "rgba8") for p in px], 8),
        "adam7": ([chip_smoke.general_png(p, "adam7") for p in px], 16),
        "cgbi": ([chip_smoke.general_png(p, "cgbi") for p in px], 8),
        "one": ([chip_smoke.general_png(px[0], "rgba8")], 8),
    }


def _inputs():
    rng = np.random.default_rng(9)
    filter_rows = {}
    for delay in DELAYS:
        x = rng.integers(0, 256, (B, H, 6 * delay), dtype=np.uint8)
        x[1] = x[1] // 64 * 64          # smooth: the filters differ
        filter_rows[delay] = x
    return dict(
        whole=rng.integers(0, 97, 40_000, dtype=np.uint8).tobytes(),
        filter_rows=filter_rows, decode=_decode_sets(),
        pixels=rng.integers(0, 256, (5, 9, 11, 4), dtype=np.uint8),
        levels=[9, 6], segment_cases=SEGMENT_CASES,
        payloads={n: _payload(n) for n, _ in SEGMENT_CASES},
        corpus=corpus_set())


INPUTS = _inputs()


def _job(tmp_path_factory, n):
    # the native library builds here once, not in every rank
    assert native.available(), native.last_error()
    folder = str(tmp_path_factory.mktemp(f"ranks{n}"))
    with open(os.path.join(folder, "inputs.pkl"), "wb") as f:
        pickle.dump(INPUTS, f)
    return _spawn(folder, n)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _job(tmp_path_factory, 4)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _job(tmp_path_factory, 2)


@pytest.fixture(params=[4, 2], ids=["four", "two"])
def job(request):
    return request.getfixturevalue({4: "four", 2: "two"}[request.param])


def _same_on_every_rank(job, key):
    first = job[0][key]
    for r in job[1:]:
        assert pickle.dumps(r[key]) == pickle.dumps(first), key
    return first


def test_job_runs_collectives(job):
    n = len(job)
    assert [r["rank"] for r in job] == list(range(n))
    assert {r["world"] for r in job} == {n}
    assert {r["all_reduce"] for r in job} == {n * (n + 1) // 2}
    assert {r["adler"] for r in job} == {zlib.adler32(INPUTS["whole"])}
    assert _same_on_every_rank(job, "mesh") == ([2, 2] if n == 4 else [2, 1])


def test_global_mesh_rows_must_divide_the_world(job):
    n = len(job)
    msg = _same_on_every_rank(job, "rows3")
    assert msg == f"{n} devices not divisible into 3 row shards"


@pytest.mark.parametrize("delay", DELAYS)
def test_filter_select_sharded_matches_jax(four, delay):
    """The four blocks put together equal JAX's filter_select_sharded on
    its 4 × 2 mesh and the port's filter_select_batch."""
    rows = INPUTS["filter_rows"][delay]
    got = np.zeros((B, H, 1 + rows.shape[2]), np.uint8)
    for r in four:
        b_lo, b_hi, h_lo, h_hi = r["filter_block"]
        got[b_lo:b_hi, h_lo:h_hi] = r["filter"][delay]
    assert sorted(r["filter_block"] for r in four) == [
        (0, 2, 0, 4), (0, 2, 4, 8), (2, 4, 0, 4), (2, 4, 4, 8)]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("images", "rows"))
    want = np.asarray(jax_filter_sharded(mesh, jnp.asarray(rows), delay))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(jax_filter(jnp.asarray(rows),
                                                        delay)), want)
    np.testing.assert_array_equal(
        filter_select_batch(torch.from_numpy(rows), delay).numpy(), want)


_JAX: dict = {}


def _jax(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


@pytest.mark.parametrize("name", ["rgba8", "adam7", "cgbi", "one"])
def test_batch_codec_mesh_decode(job, name):
    pngs, bits = INPUTS["decode"][name]
    got = _same_on_every_rank(job, "decode")[name]
    np.testing.assert_array_equal(got, BatchCodec("cpu").decode(pngs,
                                                                bits=bits))
    want = _jax(("decode", name), lambda: JaxBatchCodec().decode(
        pngs, bits=bits, device_inflate=False))
    np.testing.assert_array_equal(got, np.asarray(want))
    filt = _same_on_every_rank(job, "decode_filtered")[name]
    np.testing.assert_array_equal(
        filt, BatchCodec("cpu").decode_filtered(pngs)[0])
    np.testing.assert_array_equal(filt, _jax(
        ("filtered", name), lambda: JaxBatchCodec().decode_filtered(
            pngs, device_inflate=False)[0]))


@pytest.mark.parametrize("level", [9, 6])
def test_batch_codec_mesh_encode(job, level):
    got = _same_on_every_rank(job, "encode")[level]
    px = INPUTS["pixels"]
    assert got == BatchCodec("cpu").encode(px, level=level)
    assert got == _jax(("encode", level),
                       lambda: JaxBatchCodec().encode(px, level=level))


@pytest.mark.parametrize("size,segments", SEGMENT_CASES)
def test_deflate_segmented_mesh(job, size, segments):
    data = INPUTS["payloads"][size]
    got = _same_on_every_rank(job, "segmented")[(size, segments)]
    assert got == deflate_segmented(data, 6, segments, device="cpu")
    assert got == _jax(("segmented", size, segments),
                       lambda: jax_deflate_segmented(data, 6, segments))
    assert zlib.decompress(got) == data


def test_corpus_decoder_mesh_matches_jax(job):
    got = _same_on_every_rank(job, "corpus")
    want = _jax("corpus", lambda: jax_corpus.CorpusDecoder(
        batch_size=2).decode(INPUTS["corpus"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_shard_buckets_partition_the_buckets(two):
    keys = [set(r["shard_keys"]) for r in two]
    every = set(map(repr, corpus.bucket(INPUTS["corpus"])))
    assert keys[0] | keys[1] == every and not keys[0] & keys[1]
    assert all(keys)


def test_dryrun_multichip_four_ranks():
    out = dryrun_multichip(4, timeout=DEADLINE, backend="gloo")
    assert [r["rank"] for r in out] == [0, 1, 2, 3]
    assert {tuple(r["mesh"]) for r in out} == {(2, 2)}
    assert len({r["score"] for r in out}) == 1


def test_dryrun_past_its_deadline_raises_and_ends_its_ranks():
    import multiprocessing

    with pytest.raises(TimeoutError, match="not done in"):
        dryrun_multichip(2, timeout=0.5, backend="gloo")
    assert not multiprocessing.active_children()
