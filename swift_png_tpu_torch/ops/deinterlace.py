"""Adam7 deinterlace for a batch of same-shape images.

Counterpart of ``swift_png_tpu/ops/deinterlace.py``.  The inflated
interlaced stream holds each pass's filtered scanlines back to back; each
pass defilters on its own and its samples land in the full ``(H, W, C)``
grid with one strided copy.  The JAX version runs one image per call under
``vmap``; here each pass's rows of all B images go through one
:func:`~swift_png_tpu_torch.ops.unfilter.defilter_batch` call (K3 on a CUDA
device).
"""

from __future__ import annotations

import torch

from .._host.png.decoder import ADAM7
from .convolve import samples_from_rows
from .unfilter import defilter_batch

__all__ = ["ADAM7", "pass_geometry", "deinterlace_samples"]


def pass_geometry(size: tuple[int, int], volume: int):
    """Layout of the interlaced stream: per non-empty pass, ``(z, sub_x,
    sub_y, pitch, byte_offset)``, and the stream's total length."""
    W, H = size
    out = []
    offset = 0
    for z, ((bx, by), (sx, sy)) in enumerate(ADAM7):
        sub_x = (W + sx - bx - 1) // sx
        sub_y = (H + sy - by - 1) // sy
        if sub_x <= 0 or sub_y <= 0:
            continue
        pitch = (sub_x * volume + 7) >> 3
        out.append((z, sub_x, sub_y, pitch, offset))
        offset += sub_y * (pitch + 1)
    return out, offset


def deinterlace_samples(flat: torch.Tensor, *, size: tuple[int, int],
                        depth: int, channels: int) -> torch.Tensor:
    """``(B, ≥ total)`` uint8 interlaced filtered streams → ``(B, H, W,
    channels)`` int32 raw (unscaled) samples, on the input's device."""
    W, H = size
    volume = depth * channels
    delay = (volume + 7) >> 3
    passes, _ = pass_geometry(size, volume)
    B = flat.shape[0]
    grid = torch.zeros((B, H, W, channels), dtype=torch.int32,
                       device=flat.device)
    for z, sub_x, sub_y, pitch, offset in passes:
        (bx, by), (sx, sy) = ADAM7[z]
        rows = flat[:, offset: offset + sub_y * (pitch + 1)].reshape(
            B, sub_y, pitch + 1).contiguous()
        data = defilter_batch(rows, delay)
        grid[:, by::sy, bx::sx] = samples_from_rows(data, depth, channels,
                                                    sub_x)
    return grid
