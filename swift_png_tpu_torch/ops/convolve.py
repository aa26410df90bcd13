"""Pixel convolve: defiltered scanlines → RGBA or VA (plain PyTorch).

Counterpart of ``samples_from_rows``, ``rescale``, ``samples_to_rgba``,
``samples_to_va`` and ``unpack_rgba`` in ``swift_png_tpu/ops/convolve.py``:
big-endian 16-bit atoms, MSB-first sub-byte samples, exact depth rescale,
per-image palette dereference and chroma keys; ``pack_rows``, the
encoder's way back from samples to scanline bytes; and the exact integer
``premultiply`` and ``straighten``.  The sample functions take a leading
batch axis (the JAX versions are per image and vmapped by their caller);
``premultiply`` and ``straighten`` work elementwise on any shape.
``is_bgr`` reads the iOS (CgBI) byte order, bgr8 and bgra8.  Each runs on
the device of its input tensors.
"""

from __future__ import annotations

import torch

__all__ = ["samples_from_rows", "rescale", "samples_to_rgba",
           "samples_to_va", "unpack_rgba", "pack_rows", "premultiply",
           "straighten"]


def quantum(source_depth: int, dest_bits: int) -> int:
    return ((1 << dest_bits) - 1) // ((1 << source_depth) - 1)


_BGRA = [2, 1, 0, 3]


def _dtype(bits: int) -> torch.dtype:
    return torch.uint8 if bits == 8 else torch.uint16


def samples_from_rows(rows: torch.Tensor, depth: int, channels: int,
                      width: int) -> torch.Tensor:
    """``(B, H, pitch)`` uint8 rows → ``(B, H, width, channels)`` int32 raw
    samples."""
    B, H = rows.shape[:2]
    if depth == 16:
        atoms = rows.reshape(B, H, -1, 2).to(torch.int32)
        samples = (atoms[..., 0] << 8) | atoms[..., 1]
        return samples[:, :, : width * channels].reshape(B, H, width,
                                                         channels)
    if depth == 8:
        return rows[:, :, : width * channels].reshape(
            B, H, width, channels).to(torch.int32)
    # sub-byte: MSB-first within each byte; single-channel formats
    per = 8 // depth
    i = torch.arange(width, device=rows.device)
    byte = rows[:, :, i // per].to(torch.int32)
    shift = ((per - 1 - (i % per)) * depth).to(torch.int32)
    samples = (byte >> shift) & ((1 << depth) - 1)
    return samples.reshape(B, H, width, 1)


def rescale(samples: torch.Tensor, source_depth: int,
            dest_bits: int) -> torch.Tensor:
    """Exact depth rescale to ``dest_bits`` (8 → uint8, 16 → uint16)."""
    if dest_bits == source_depth:
        return samples.to(_dtype(dest_bits))
    if dest_bits > source_depth:
        return (samples * quantum(source_depth, dest_bits)).to(
            _dtype(dest_bits))
    return (samples >> (source_depth - dest_bits)).to(_dtype(dest_bits))


def samples_to_rgba(raw: torch.Tensor, *, depth: int, channels: int,
                    is_bgr: bool = False, is_indexed: bool = False,
                    has_key: bool = False,
                    palette: torch.Tensor | None = None,
                    key: torch.Tensor | None = None,
                    bits: int = 8) -> torch.Tensor:
    """Raw samples ``(B, H, W, C)`` int32 → ``(B, H, W, 4)`` RGBA at
    ``bits``.  ``palette``: ``(B, n, 4)`` 8-bit entries with alpha folded
    in; ``key``: ``(B, channels)`` raw-depth chroma keys (−1 never
    matches), compared in the file's channel order."""
    tmax = (1 << bits) - 1
    B, H, W = raw.shape[:3]
    if is_indexed:
        idx = raw[..., 0].reshape(B, H * W, 1).long().expand(-1, -1, 4)
        gathered = palette.to(torch.int32).gather(1, idx)
        return rescale(gathered.reshape(B, H, W, 4), 8, bits)
    scaled = rescale(raw, depth, bits).to(torch.int32)
    opaque = torch.full((B, H, W), tmax, dtype=torch.int32,
                        device=raw.device)
    if channels == 1:
        v = scaled[..., 0]
        alpha = opaque
        if has_key:
            alpha = torch.where(raw[..., 0] == key[:, 0, None, None], 0,
                                tmax)
        out = torch.stack([v, v, v, alpha], dim=-1)
    elif channels == 2:
        v = scaled[..., 0]
        out = torch.stack([v, v, v, scaled[..., 1]], dim=-1)
    elif channels == 3:
        alpha = opaque
        if has_key:
            hit = (raw == key[:, None, None, :]).all(-1)
            alpha = torch.where(hit, 0, tmax)
        rgb = scaled.flip(-1) if is_bgr else scaled
        out = torch.cat([rgb, alpha[..., None]], dim=-1)
    else:
        out = scaled[..., _BGRA] if is_bgr else scaled
    return out.to(_dtype(bits))


def samples_to_va(raw: torch.Tensor, *, depth: int, channels: int,
                  is_bgr: bool = False, is_indexed: bool = False,
                  has_key: bool = False,
                  palette: torch.Tensor | None = None,
                  key: torch.Tensor | None = None,
                  bits: int = 8) -> torch.Tensor:
    """Raw samples ``(B, H, W, C)`` int32 → ``(B, H, W, 2)`` value–alpha at
    ``bits``: the colour kinds give their r channel as the value, palettes
    their (r, alpha) entries.  ``palette`` and ``key`` as in
    :func:`samples_to_rgba`."""
    tmax = (1 << bits) - 1
    B, H, W = raw.shape[:3]
    if is_indexed:
        idx = raw[..., 0].reshape(B, H * W, 1).long().expand(-1, -1, 2)
        gathered = palette[..., [0, 3]].to(torch.int32).gather(1, idx)
        return rescale(gathered.reshape(B, H, W, 2), 8, bits)
    scaled = rescale(raw, depth, bits).to(torch.int32)
    opaque = torch.full((B, H, W), tmax, dtype=torch.int32,
                        device=raw.device)
    if channels == 1:
        v = scaled[..., 0]
        alpha = opaque
        if has_key:
            alpha = torch.where(raw[..., 0] == key[:, 0, None, None], 0,
                                tmax)
    elif channels == 2:
        v, alpha = scaled[..., 0], scaled[..., 1]
    elif channels == 3:
        v = scaled[..., 2] if is_bgr else scaled[..., 0]
        alpha = opaque
        if has_key:
            hit = (raw == key[:, None, None, :]).all(-1)
            alpha = torch.where(hit, 0, tmax)
    else:
        v = scaled[..., 2] if is_bgr else scaled[..., 0]
        alpha = scaled[..., 3]
    return torch.stack([v, alpha], dim=-1).to(_dtype(bits))


def premultiply(color: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Exact integer premultiply of uint8 or uint16 samples:
    ``(color·alpha + max//2) // max``."""
    tmax = 255 if color.dtype == torch.uint8 else 65535
    product = color.to(torch.int64) * alpha.to(torch.int64) + (tmax >> 1)
    return (product // tmax).to(color.dtype)


def straighten(premultiplied: torch.Tensor,
               alpha: torch.Tensor) -> torch.Tensor:
    """Exact integer straighten of uint8 or uint16 samples:
    ``(max·color + alpha//2) // alpha``, the input where alpha is 0."""
    tmax = 255 if premultiplied.dtype == torch.uint8 else 65535
    a = alpha.to(torch.int64)
    c = premultiplied.to(torch.int64)
    out = (tmax * c + (a >> 1)) // a.clamp(min=1)
    return torch.where(a == 0, c, out).to(premultiplied.dtype)


def pack_rows(samples: torch.Tensor, depth: int, channels: int,
              width: int) -> torch.Tensor:
    """Raw samples ``(B, H, width, channels)`` int32 → scanline bytes
    ``(B, H, pitch)`` uint8: big-endian 16-bit samples, MSB-first sub-byte
    samples (the inverse of :func:`samples_from_rows`)."""
    B, H = samples.shape[:2]
    if depth == 16:
        flat = samples.reshape(B, H, -1)
        return torch.stack([(flat >> 8) & 0xFF, flat & 0xFF], dim=-1
                           ).reshape(B, H, -1).to(torch.uint8)
    if depth == 8:
        return samples.reshape(B, H, -1).to(torch.uint8)
    per = 8 // depth
    pitch = (width * depth + 7) >> 3
    i = torch.arange(width, device=samples.device)
    shift = ((per - 1 - (i % per)) * depth).to(torch.int32)
    contrib = (samples[..., 0] & ((1 << depth) - 1)) << shift
    # the shifted samples of one byte are bit-disjoint: their sum is the OR
    out = torch.zeros((B, H, pitch), dtype=torch.int32,
                      device=samples.device)
    out.index_add_(2, i // per, contrib.to(torch.int32))
    return out.to(torch.uint8)


def unpack_rgba(rows: torch.Tensor, *, depth: int, channels: int,
                width: int, is_bgr: bool = False, is_indexed: bool = False,
                has_key: bool = False, palette: torch.Tensor | None = None,
                key: torch.Tensor | None = None,
                bits: int = 8) -> torch.Tensor:
    """Defiltered rows ``(B, H, pitch)`` → ``(B, H, width, 4)`` RGBA."""
    if (depth == 8 and bits == 8 and channels == 4 and not is_indexed
            and not has_key):
        # rgba8/bgra8: a reshape, and a channel swizzle for bgra8
        B, H = rows.shape[:2]
        px = rows[:, :, : width * 4].reshape(B, H, width, 4)
        return px[..., _BGRA] if is_bgr else px
    raw = samples_from_rows(rows, depth, channels, width)
    return samples_to_rgba(raw, depth=depth, channels=channels,
                           is_bgr=is_bgr, is_indexed=is_indexed,
                           has_key=has_key, palette=palette, key=key,
                           bits=bits)
