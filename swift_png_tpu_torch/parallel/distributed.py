"""Process bring-up, the global device mesh, and shard checksum combines.

Counterpart of ``swift_png_tpu/parallel/distributed.py`` on
``torch.distributed``: one process per device, NCCL between GPUs and gloo
between CPU processes.  A JAX ``Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` with the same dimension
names.  Every process holds the same host inputs, as each JAX controller
does; a sharded stage runs its own block on its device and a collective
gives the whole result back to every process.

Compressed shards are joined in order on the host; their checksums
combine associatively (:func:`combine_adler_shards`,
:func:`combine_crc_shards`) in place of one sequential pass over the
whole stream.
"""

from __future__ import annotations

import math
import socket
import warnings

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._host.lz77.checksums import adler32_combine, crc32_combine

__all__ = ["initialize", "global_mesh", "shutdown", "free_port",
           "mesh_device", "axis_block", "gather_blocks",
           "combine_adler_shards", "combine_crc_shards"]


def _backend(backend: str | None) -> str:
    """The backend a job runs on: NCCL unless the caller names another.
    With none named and no GPU present this raises: a missing card is
    never hidden by a quiet run on the CPU."""
    if backend is not None:
        return backend
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass backend='gloo' to run the "
                           "job on the CPU")
    return "nccl"


def free_port() -> int:
    """A TCP port on the local host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join this process to a job of ``num_processes`` (nothing to do for
    one process or none, as in the JAX package).

    The rendezvous is ``tcp://<coordinator_address>`` (``host:port``).
    ``backend``: NCCL unless the caller names another (``"gloo"`` for
    CPU processes); with none named and no GPU present this raises.
    Under NCCL the process takes the GPU of its local rank
    (``process_id`` modulo the host's GPUs) as its current device.
    """
    if num_processes is None or num_processes <= 1:
        return
    backend = _backend(backend)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the job: destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(images_axis: str = "images", rows_axis: str = "rows",
                rows: int = 1, backend: str | None = None) -> DeviceMesh:
    """An ``(images × rows)`` mesh of ``(world // rows, rows)`` over every
    process of the job, one device each.

    In a process that has joined no job, this first sets up a one-process
    group on a free local port, so that ``global_mesh()`` works in one
    process as the JAX package's does; :func:`shutdown` ends it.  Its
    ``backend`` is NCCL unless the caller names another (``"gloo"`` for
    the CPU); with none named and no GPU present this raises.  Inside a
    job the mesh keeps the job's backend.  The mesh's device type is
    ``cuda`` under NCCL and ``cpu`` under gloo.
    """
    if not dist.is_initialized():
        backend = _backend(backend)
        if backend == "nccl":
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0)
    world = dist.get_world_size()
    if world % rows:
        raise ValueError(f"{world} devices not divisible into "
                         f"{rows} row shards")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // rows, rows),
                            mesh_dim_names=(images_axis, rows_axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This process's device on ``mesh``: ``cuda:<local rank>`` or
    ``cpu``.  A mesh on ``cuda`` without a card raises."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"a mesh on {mesh.device_type} needs a CUDA "
                           f"device, and there is none")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def axis_block(mesh: DeviceMesh, axis: str, n: int) -> tuple[int, int, int]:
    """This process's contiguous block of ``n`` items along ``axis``:
    ``(start, stop, block)``, where every process's block is padded to
    ``block = ceil(n / axis size)`` items for the gather."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    block = -(-n // size)
    start = min(n, mesh.get_local_rank(axis) * block)
    return start, min(n, start + block), block


def gather_blocks(mesh: DeviceMesh, axis: str, part: torch.Tensor,
                  n: int, block: int) -> torch.Tensor:
    """Every process's block of the leading axis, gathered over ``axis``
    in mesh order: ``part`` (this process's block, up to ``block`` rows)
    is padded to ``block`` rows, the blocks are gathered as bytes (gloo
    and NCCL take no uint16) with ``all_gather_into_tensor``, and the
    result is cut to ``n`` rows.  A failed collective raises."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    shape = part.shape[1:]
    send = torch.zeros((block, *shape), dtype=part.dtype,
                       device=part.device)
    send[:part.shape[0]] = part
    send = send.reshape(block, math.prod(shape)).view(torch.uint8)
    out = torch.empty((size * block, send.shape[1]), dtype=torch.uint8,
                      device=part.device)
    with warnings.catch_warnings():
        # newer PyTorch names it all_gather_single; both gather the same
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, send, group=mesh.get_group(axis))
    return out.view(part.dtype).reshape(size * block, *shape)[:n]


def combine_adler_shards(parts: list[tuple[int, int]]) -> int:
    """Adler-32 of a concatenation from its shards' ``(adler, length)``
    pairs, in order."""
    total = 1
    for a, length in parts:
        total = adler32_combine(total, a, length)
    return total


def combine_crc_shards(parts: list[tuple[int, int]]) -> int:
    """CRC-32 of a concatenation from its shards' ``(crc, length)`` pairs,
    in order."""
    total = 0
    for c, length in parts:
        total = crc32_combine(total, c, length)
    return total
