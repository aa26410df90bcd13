"""Encode-side filter select (plain PyTorch).

Counterpart of ``filter_select`` and ``filter_select_batch`` in
``swift_png_tpu/ops/filter.py``: every scanline gets the five PNG filters
(None, Sub, Up, Average, Paeth), each predicting from the raw row above,
and keeps the one whose bytes, read as signed, have the least sum of
magnitudes.  Rows are independent, so a whole batch is one pass.  Ties go
to the lowest filter index: ``torch.argmin`` returns the first minimum on
the CPU and on CUDA alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["filter_select", "filter_select_batch"]


def filter_select_batch(rows: torch.Tensor, delay: int) -> torch.Tensor:
    """``(B, H, pitch)`` uint8 raw scanlines → ``(B, H, 1 + pitch)`` uint8
    ``[filter byte, filtered bytes…]`` per row, on the input's device."""
    cur = rows.to(torch.int16)
    prev = F.pad(cur, (0, 0, 1, 0))[:, :-1]          # raw row above, 0 at top
    a = F.pad(cur, (delay, 0))[..., : cur.shape[-1]]
    c = F.pad(prev, (delay, 0))[..., : cur.shape[-1]]
    pa = (prev - c).abs()
    pb = (a - c).abs()
    pc = (a + prev - 2 * c).abs()
    paeth = torch.where((pa <= pb) & (pa <= pc), a,
                        torch.where(pb <= pc, prev, c))
    cand = torch.stack([cur, cur - a, cur - prev, cur - ((a + prev) >> 1),
                        cur - paeth]) & 0xFF              # (5, B, H, pitch)
    as_i8 = torch.where(cand > 127, cand - 256, cand)
    scores = as_i8.abs().sum(-1, dtype=torch.int32)      # (5, B, H)
    best = torch.argmin(scores, dim=0)                   # first minimum
    chosen = torch.gather(cand, 0, best[None, ..., None].expand(
        1, *cand.shape[1:]))[0]
    return torch.cat([best[..., None], chosen], dim=-1).to(torch.uint8)


def filter_select(rows: torch.Tensor, delay: int) -> torch.Tensor:
    """One image: ``(H, pitch)`` → ``(H, 1 + pitch)``."""
    return filter_select_batch(rows[None], delay)[0]
