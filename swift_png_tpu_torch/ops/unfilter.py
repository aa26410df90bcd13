"""PNG scanline defilter (K3) and its plain version.

Counterpart of ``swift_png_tpu/ops/unfilter.py::defilter_batch`` and the
Pallas kernel ``swift_png_tpu/ops/unfilter_pallas.py``.  Byte ``(y, i)``
depends on ``a = (y, i-delay)``, ``b = (y-1, i)`` and ``c = (y-1,
i-delay)``; grouping bytes into pixel groups ``g = i // delay``, cells on
one anti-diagonal ``d = y + g`` are independent.  Filter types None, Sub,
Up, Average and Paeth; types 5…255 predict 0.

:func:`defilter_batch` launches the CUDA kernel (``csrc/defilter.cu``) for
a tensor on a CUDA device and runs :func:`defilter_reference` for a tensor
on the CPU.
"""

from __future__ import annotations

import torch

from .. import _kernels

__all__ = ["defilter_batch", "defilter_cuda", "defilter_reference"]


def _shape(filtered: torch.Tensor, delay: int):
    if filtered.dim() != 3:
        raise ValueError(f"filtered must be (B, H, 1+pitch), got "
                         f"{tuple(filtered.shape)}")
    B, H, pitch1 = filtered.shape
    pitch = pitch1 - 1
    if not 1 <= delay <= 8 or pitch % delay:
        raise ValueError(f"pitch {pitch} needs a delay in 1..8 dividing it, "
                         f"got {delay}")
    return B, H, pitch


def defilter_batch(filtered: torch.Tensor, delay: int) -> torch.Tensor:
    """``(B, H, 1+pitch)`` uint8 filtered scanlines → ``(B, H, pitch)``
    uint8 on the input's device."""
    if filtered.device.type == "cpu":
        return defilter_reference(filtered, delay)
    return defilter_cuda(filtered, delay)


def defilter_cuda(filtered: torch.Tensor, delay: int) -> torch.Tensor:
    """Launch the K3 CUDA kernel (``csrc/defilter.cu``)."""
    B, H, pitch = _shape(filtered, delay)
    _kernels.require(filtered, "filtered", torch.uint8, 3)
    out = torch.empty((B, H, pitch), dtype=torch.uint8,
                      device=filtered.device)
    _kernels.KERNELS["defilter"].launch(
        filtered.data_ptr(), out.data_ptr(), B, H, pitch, delay,
        _kernels.stream_of(filtered))
    return out


def defilter_reference(filtered: torch.Tensor, delay: int) -> torch.Tensor:
    """Plain PyTorch defilter: the same wavefront, one anti-diagonal per
    step, vectorized over images, rows and the pixel's bytes."""
    B, H, pitch = _shape(filtered, delay)
    G = pitch // delay
    dev = filtered.device
    x = filtered[:, :, 1:].reshape(B, H, G, delay).long()
    ft = filtered[:, :, 0].long()
    # one zero row above and one zero pixel group to the left
    o = torch.zeros((B, H + 1, G + 1, delay), dtype=torch.long, device=dev)
    for d in range(H + G - 1):
        y = torch.arange(max(0, d - G + 1), min(H, d + 1), device=dev)
        g = d - y
        a = o[:, y + 1, g]
        b = o[:, y, g + 1]
        c = o[:, y, g]
        pa = (b - c).abs()
        pb = (a - c).abs()
        pc = (a + b - 2 * c).abs()
        paeth = torch.where((pa <= pb) & (pa <= pc), a,
                            torch.where(pb <= pc, b, c))
        f = ft[:, y][:, :, None]
        pred = torch.where(f == 1, a, 0)
        pred = torch.where(f == 2, b, pred)
        pred = torch.where(f == 3, (a + b) >> 1, pred)
        pred = torch.where(f == 4, paeth, pred)
        o[:, y + 1, g + 1] = (x[:, y, g] + pred) & 0xFF
    return o[:, 1:, 1:].reshape(B, H, pitch).to(torch.uint8)
