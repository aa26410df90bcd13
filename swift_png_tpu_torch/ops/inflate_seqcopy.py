"""Sequential-copy expansion for match-dominated streams (K2) and its plain
version.

Counterpart of ``swift_png_tpu/ops/inflate_seqcopy.py``.  Smooth and
RLE-heavy images compress to streams whose output is almost all match
bytes in deep self-referential chains.  Here the match tokens are rebuilt
from the per-byte pointers as merged uniform-distance run records ``(pos,
d, len)`` (adjacent matches with one distance merge safely: forward copy
depends only on each byte's ``(j, d)``), and each stream's records run in
stream order, which is the reference's forward copy with no chains to
chase.

:func:`seqcopy_expand` launches the CUDA kernel (``csrc/seqcopy.cu``) for
tensors on a CUDA device and runs :func:`seqcopy_reference` for tensors on
the CPU.
"""

from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["build_records", "seqcopy_expand", "seqcopy_cuda",
           "seqcopy_reference", "RECORDS_SMEM_CAP"]

# the TPU kernel holds its records in scalar-prefetch memory (~1 MB): 3
# int32 per record.  The routing in CheckpointInflator.run keeps the cap for
# parity and reads it from this module at call time.
RECORDS_SMEM_CAP = 1 << 16


def build_records(ptr: torch.Tensor, B: int, Opad: int, cap: int):
    """Merged uniform-distance run records from per-byte pointers.

    ``ptr``: flat ``(N,)`` with ``ptr[j] = j - d`` for match bytes and
    ``j`` for literals (the first ``B·Opad`` entries are stream bytes).
    Returns ``(starts (B+1,) int32, recs (cap·3,) int32 [stream-local pos,
    d, len], ovf)``: the first ``cap`` records in stream order, maximal
    same-``d`` runs that never cross a stream's start, padded with ``(0, 1,
    0)``; ``starts`` clipped to ``cap``; ``ovf`` (a bool) when the batch has
    more than ``cap`` records.  The TPU version's gather-free compaction
    (``_compact_mask_positions``) is ``nonzero`` here.
    """
    N0 = B * Opad
    dev = ptr.device
    j = torch.arange(N0, device=dev)
    d = (j - ptr[:N0].long()).reshape(B, Opad)
    is_m = d > 0
    z = torch.zeros((B, 1), dtype=d.dtype, device=dev)
    f = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    prev_d = torch.cat([z, d[:, :-1]], 1)
    prev_m = torch.cat([f, is_m[:, :-1]], 1)
    next_d = torch.cat([d[:, 1:], z], 1)
    next_m = torch.cat([is_m[:, 1:], f], 1)
    start_b = is_m & (~prev_m | (d != prev_d))
    end_b = is_m & (~next_m | (d != next_d))
    spos = torch.nonzero(start_b.reshape(-1)).reshape(-1)
    epos = torch.nonzero(end_b.reshape(-1)).reshape(-1)
    total = spos.numel()
    n = min(total, cap)
    recs = torch.zeros((cap, 3), dtype=torch.int32, device=dev)
    recs[:, 1] = 1
    sp, ep = spos[:n], epos[:n]
    recs[:n, 0] = (sp % Opad).to(torch.int32)
    recs[:n, 1] = d.reshape(-1)[sp].to(torch.int32)
    recs[:n, 2] = (ep - sp + 1).to(torch.int32)
    per_stream = start_b.sum(1)
    starts = torch.cat([torch.zeros(1, dtype=per_stream.dtype, device=dev),
                        torch.cumsum(per_stream, 0)])
    starts = starts.clamp(max=cap).to(torch.int32)
    return starts, recs.reshape(-1), total > cap


def _shape(starts, recs, lit):
    if lit.dim() != 2:
        raise ValueError(f"lit must be (B, Opad), got {tuple(lit.shape)}")
    B = lit.shape[0]
    if starts.shape != (B + 1,):
        raise ValueError(f"starts must be (B+1,) = ({B + 1},), got "
                         f"{tuple(starts.shape)}")
    if recs.numel() % 3:
        raise ValueError("recs must hold (pos, d, len) triples")
    return recs.reshape(-1, 3)


def seqcopy_expand(starts: torch.Tensor, recs: torch.Tensor,
                   lit: torch.Tensor) -> torch.Tensor:
    """Run each stream's records in order over its literal-placed bytes.

    ``starts (B+1,)`` int32 record ranges, ``recs (cap·3,)`` or ``(cap,
    3)`` int32, ``lit (B, Opad)`` uint8 (match bytes arbitrary).  Returns
    the expanded ``(B, Opad)`` uint8 on the inputs' device."""
    if lit.device.type == "cpu":
        return seqcopy_reference(starts, recs, lit)
    return seqcopy_cuda(starts, recs, lit)


def seqcopy_cuda(starts: torch.Tensor, recs: torch.Tensor,
                 lit: torch.Tensor) -> torch.Tensor:
    """Launch the K2 CUDA kernel (``csrc/seqcopy.cu``)."""
    recs = _shape(starts, recs, lit)
    _kernels.require(starts, "starts", torch.int32, 1)
    _kernels.require(recs, "recs", torch.int32, 2)
    _kernels.require(lit, "lit", torch.uint8, 2)
    B, Opad = lit.shape
    out = torch.empty_like(lit)
    _kernels.KERNELS["seqcopy"].launch(
        starts.data_ptr(), recs.data_ptr(), lit.data_ptr(), out.data_ptr(),
        B, Opad, recs.shape[0], _kernels.stream_of(lit))
    return out


def seqcopy_reference(starts: torch.Tensor, recs: torch.Tensor,
                      lit: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: for each record rank ``r``, every stream that has
    an ``r``-th record runs it at once, all its bytes by the closed form
    ``out[pos + i] = out[pos - d + i % d]`` (the sources ``[pos - d, pos)``
    are final before the record starts, so the gather can precede the
    scatter).  Out-of-row writes are dropped, sources before byte 0 read 0
    and records with ``d < 1`` do nothing, as in the kernel."""
    recs = _shape(starts, recs, lit).long()
    B, Opad = lit.shape
    dev = lit.device
    out = lit.clone()
    flat = out.reshape(-1)
    nrec = recs.shape[0]
    st = starts.long()
    rs = st[:-1].clamp(0, nrec)
    count = torch.maximum(st[1:].clamp(0, nrec), rs) - rs
    for r in range(int(count.max()) if B else 0):
        bs = torch.nonzero(count > r).reshape(-1)
        pos, d, ln = recs[rs[bs] + r].unbind(1)
        q0 = pos.clamp(min=0)
        q1 = torch.minimum(pos + ln, torch.full_like(pos, Opad))
        n = torch.where(d >= 1, (q1 - q0).clamp(min=0), 0)
        k = torch.repeat_interleave(torch.arange(bs.numel(), device=dev), n)
        if k.numel() == 0:
            continue
        first = torch.cumsum(n, 0) - n
        q = q0[k] + torch.arange(k.numel(), device=dev) - first[k]
        i = q - pos[k]
        s = pos[k] - d[k] + i % d[k]
        row = bs[k] * Opad
        vals = torch.where(s >= 0, flat[row + s.clamp(min=0)], 0)
        flat[row + q] = vals.to(torch.uint8)
    return out
