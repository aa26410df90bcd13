"""A dry run of one sharded codec step in several processes.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``.  :func:`dryrun_multichip` spawns one process per
rank, joins them into one job (NCCL when the host has a GPU for each
rank, gloo otherwise), and each rank runs :func:`dryrun_step` on an
``(images × rows)`` mesh, ``rows`` = 2 when the rank count is even:

* the decode stage (K3 defilter, convolve) on its block of images;
* the re-filter of the decoded rows through :func:`filter_select_sharded`,
  its row shard taking the halo row from the shard above;
* a global ``all_reduce`` of the re-filtered bytes' absolute sum;
* ``CheckpointInflator.run`` on its block of indexed streams;
* :func:`deflate_segmented` over the mesh.

Each result is held against the same work done without a mesh on the
rank, so a fault in a collective shows as a failed rank.  The JAX dry
run's XLA-backend ``inflate_indexed`` under a unit sharding has no
counterpart: the port does not port ``backend="xla"``.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import time
import traceback
import zlib

import numpy as np
import torch
import torch.distributed as dist

from .._host.lz77.index import CheckpointIndex, build_index
from ..ops.filter import filter_select_batch
from ..ops.inflate_checkpoint import CheckpointInflator
from .batch import decode_stage, filter_select_sharded
from .blocks import deflate_segmented
from .distributed import (axis_block, free_port, global_mesh, initialize,
                          mesh_device, shutdown)

__all__ = ["dryrun_multichip", "dryrun_step", "example_batch"]


def example_batch(B: int = 2, H: int = 32, W: int = 32,
                  seed: int = 0) -> np.ndarray:
    """``(B, H, 1 + 4W)`` random rgba8 filtered scanlines, filter types
    0–4 (the JAX dry run's ``_example_batch``)."""
    rng = np.random.default_rng(seed)
    filtered = rng.integers(0, 256, (B, H, 1 + W * 4), dtype=np.uint8)
    filtered[:, :, 0] = rng.integers(0, 5, (B, H), dtype=np.uint8)
    return filtered


def indexed_inputs() -> tuple[bytes, bytes, bytes]:
    """``(payload, raw DEFLATE body, serialized spIx index at ob = 256)``
    of the JAX dry run's 40,000-byte payload."""
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 9, 40_000, dtype=np.uint8).tobytes()
    body = zlib.compress(payload, 6)[2:-4]
    return payload, body, build_index(body, len(payload), 256).serialize()


def _score(refiltered: torch.Tensor) -> torch.Tensor:
    """Sum of the filtered bytes' absolute values read as int8."""
    x = refiltered[..., 1:].long()
    return torch.where(x > 127, x - 256, x).abs().sum()


def dryrun_step(n_ranks: int, inputs) -> dict:
    """One rank's codec step on a mesh of ``n_ranks`` (see the module
    docstring); raises on any disagreement with the unsharded work."""
    rows_dim = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    images_dim = n_ranks // rows_dim
    mesh = global_mesh(rows=rows_dim)
    dev = mesh_device(mesh)
    B, H, W = images_dim * 2, rows_dim * 8, 16
    filtered = torch.from_numpy(example_batch(B, H, W, seed=1)).to(dev)

    lo, hi, _ = axis_block(mesh, "images", B)
    r, hl = mesh.get_local_rank("rows"), H // rows_dim
    pixels = decode_stage(filtered[lo:hi], delay=4, depth=8, channels=4,
                          width=W)
    mine = pixels.reshape(hi - lo, H, W * 4)[:, r * hl:(r + 1) * hl]
    refiltered = filter_select_sharded(mesh, mine.contiguous(), 4)
    score = _score(refiltered)
    dist.all_reduce(score)
    want = filter_select_batch(decode_stage(
        filtered, delay=4, depth=8, channels=4, width=W).reshape(
            B, H, W * 4), 4)
    if not torch.equal(refiltered, want[lo:hi, r * hl:(r + 1) * hl]):
        raise AssertionError("the sharded filter select differs")
    if int(score) != int(_score(want)):
        raise AssertionError(f"all_reduce gave {int(score)}, the whole "
                             f"batch scores {int(_score(want))}")

    payload, body, blob = inputs
    ix = CheckpointIndex.parse(blob)
    out, adler = CheckpointInflator(dev).run([body] * (hi - lo),
                                             [ix] * (hi - lo))
    want_out = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    if not (out.cpu() == want_out).all() or any(
            int(a) != zlib.adler32(payload) for a in adler):
        raise AssertionError("the indexed inflate differs")

    enc = bytes(np.tile(np.frombuffer(payload[:8192], np.uint8), 8))
    segments = max(2, images_dim)
    stream = deflate_segmented(enc, 6, segments=segments, mesh=mesh)
    if stream != deflate_segmented(enc, 6, segments=segments, device=dev):
        raise AssertionError("deflate_segmented over the mesh differs")
    if zlib.decompress(stream) != enc:
        raise AssertionError("the segmented stream does not inflate")
    return dict(rank=dist.get_rank(), mesh=[images_dim, rows_dim],
                device=str(dev), score=int(score),
                segmented_bytes=len(stream))


def _rank_main(rank: int, n_ranks: int, coordinator: str, backend: str,
               results, inputs) -> None:
    """A spawned rank: join the job, run the step, report to ``results``."""
    try:
        torch.set_num_threads(1)
        initialize(coordinator, n_ranks, rank, backend=backend)
        results.put((rank, None, dryrun_step(n_ranks, inputs)))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        shutdown()


def dryrun_multichip(n_ranks: int, timeout: float = 300.0) -> list[dict]:
    """Run :func:`dryrun_step` in ``n_ranks`` spawned processes, one job;
    return each rank's summary.  Raises when a rank fails, dies or is not
    done within ``timeout`` seconds; every process is gone on return.
    The processes start by ``spawn``, which imports the caller's main
    module again: a script calls this under ``if __name__ ==
    "__main__"``."""
    backend = ("nccl" if torch.cuda.is_available()
               and torch.cuda.device_count() >= n_ranks else "gloo")
    inputs = indexed_inputs()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, coordinator, backend, results,
                               inputs))
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout
    done, error, exited_at = {}, None, None
    try:
        for p in procs:
            p.start()
        while len(done) < n_ranks and error is None:
            if time.monotonic() > deadline:
                missing = sorted(set(range(n_ranks)) - set(done))
                raise TimeoutError(f"dry run: ranks {missing} not done in "
                                   f"{timeout} s")
            try:
                rank, error, summary = results.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that exited has its result in the queue, unless
                # it died: allow its result a few seconds to arrive
                if any(p.exitcode is not None and i not in done
                       for i, p in enumerate(procs)):
                    exited_at = exited_at or time.monotonic()
                    if time.monotonic() - exited_at > 5:
                        raise RuntimeError(
                            "dry run: a rank exited without a result "
                            f"(exit codes {[p.exitcode for p in procs]})")
                continue
            if error is None:
                done[rank] = summary
            else:
                error = f"rank {rank}:\n{error}"
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        # a failed rank leaves the others waiting in a collective
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(f"dry run failed on {error}")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"dry run: exit codes {codes}")
    return [done[r] for r in range(n_ranks)]
