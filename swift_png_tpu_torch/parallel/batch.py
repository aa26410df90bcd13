"""Batched indexed PNG decode on the GPU.

Counterpart of ``decode_indexed``, ``decode_stage`` and
``_palette_key_arrays`` in ``swift_png_tpu/parallel/batch.py``: lex each
PNG, read its ``spIx`` checkpoint chunk, inflate the whole batch with the
checkpoint-parallel kernel, then defilter (K3) and convolve to RGBA.
"""

from __future__ import annotations

import numpy as np
import torch

from .._host.lz77.index import CheckpointIndex
from .._host.png import chunk as chunks
from .._host.png import parsing
from .._kernels import resolve_device
from ..ops import convolve
from ..ops.inflate_checkpoint import CheckpointInflator
from ..ops.unfilter import defilter_batch

__all__ = ["decode_indexed", "decode_stage", "parse_indexed"]


def decode_stage(filtered: torch.Tensor, *, delay: int, depth: int,
                 channels: int, width: int, is_indexed: bool = False,
                 has_key: bool = False, palette: torch.Tensor | None = None,
                 key: torch.Tensor | None = None,
                 bits: int = 8) -> torch.Tensor:
    """``(B, H, 1+pitch)`` filtered scanlines → ``(B, H, W, 4)`` RGBA on
    the input's device.  ``palette``/``key`` are per image: ``(B, 256, 4)``
    and ``(B, channels)`` (a key of −1 never matches)."""
    rows = defilter_batch(filtered, delay)
    return convolve.unpack_rgba(rows, depth=depth, channels=channels,
                                width=width, is_indexed=is_indexed,
                                has_key=has_key, palette=palette, key=key,
                                bits=bits)


def _palette_key_arrays(pixel, palettes, transparencies):
    """Per-image palette / chroma-key arrays (numpy): ``(pal (B, 256, 4) |
    None, key (B, channels) | None)``.  Palettes carry tRNS alpha (255
    default); a key of −1 never matches any raw sample."""
    B = len(transparencies)
    if pixel.is_indexed:
        pals = np.zeros((B, 256, 4), np.int32)
        for b, (palette, transparency) in enumerate(
                zip(palettes, transparencies)):
            alphas = list(transparency.value) if transparency else []
            for i, (r, g, bb) in enumerate(palette.entries):
                pals[b, i] = (r, g, bb,
                              alphas[i] if i < len(alphas) else 255)
        return pals, None
    if any(t is not None for t in transparencies):
        keys = np.full((B, pixel.channels), -1, np.int32)
        for b, transparency in enumerate(transparencies):
            if transparency is None:
                continue
            if transparency.case == "v":
                keys[b, 0] = transparency.value
            else:
                keys[b] = transparency.value
        return None, keys
    return None, None


def parse_indexed(pngs: list[bytes]):
    """Lex a batch of PNGs for indexed decode.

    Returns ``(bodies, indexes, header, palettes, transparencies)`` — the
    raw-DEFLATE bodies, their checkpoint indexes and the first header — or
    ``None`` when any file is outside the fast path: no index, interlaced,
    iOS/CgBI, an indexed image without a palette, or mixed shapes.
    """
    bodies, indexes, headers, pals, keys = [], [], [], [], []
    for data in pngs:
        src = chunks.ByteSource(data)
        src.signature()
        type_, payload = src.chunk()
        if type_ != chunks.IHDR:
            return None  # CgBI (iOS stream framing) or malformed order
        header = parsing.Header.parse(payload)
        idats, ix, palette, transparency = [], None, None, None
        while type_ != chunks.IEND:
            type_, payload = src.chunk()
            if type_ == chunks.IDAT:
                idats.append(payload)
            elif type_ == chunks.spIx:
                try:
                    ix = CheckpointIndex.parse(payload)
                except ValueError:
                    ix = None  # unknown version/shape: general path
            elif type_ == chunks.PLTE:
                palette = parsing.Palette.parse(payload, header.pixel)
            elif type_ == chunks.tRNS:
                transparency = parsing.Transparency.parse(
                    payload, header.pixel, palette)
        if ix is None or header.interlaced:
            return None
        if header.pixel.is_indexed and palette is None:
            return None
        bodies.append(b"".join(idats)[2:-4])
        indexes.append(ix)
        headers.append(header)
        pals.append(palette)
        keys.append(transparency)
    if (len({ix.out_size for ix in indexes}) != 1
            or len({ix.ob for ix in indexes}) != 1):
        return None  # mixed shapes: bucket upstream
    h0 = headers[0]
    if any(h.pixel.name != h0.pixel.name or h.size != h0.size
           for h in headers):
        return None
    return bodies, indexes, h0, pals, keys


def decode_indexed(pngs: list[bytes], bits: int = 8, device=None):
    """Batched indexed decode: ``(B, H, W, 4)`` pixels on the device, at
    ``bits`` = 8 (uint8) or 16 (uint16), or ``None`` when any file is
    outside the fast path (see :func:`parse_indexed`).

    ``device``: ``cuda`` unless the caller names another; ``"cpu"`` runs
    the plain PyTorch versions of the kernels.  With no device named and
    no GPU present this raises.  Serves every non-interlaced standard
    format: gray/rgb/alpha at 1–16 bits, palette with per-image PLTE/tRNS,
    and chroma keys.
    """
    dev = resolve_device(device)
    parsed = parse_indexed(pngs)
    if parsed is None:
        return None
    bodies, indexes, h0, pals, keys = parsed
    out, _ = CheckpointInflator(dev).run(bodies, indexes)
    W, H = h0.size
    pixel = h0.pixel
    pal, key = _palette_key_arrays(pixel, pals, keys)
    return decode_stage(
        out.reshape(len(pngs), H, 1 + ((W * pixel.volume + 7) >> 3)),
        delay=(pixel.volume + 7) >> 3, depth=pixel.depth,
        channels=pixel.channels, width=W, is_indexed=pixel.is_indexed,
        palette=None if pal is None else torch.from_numpy(pal).to(dev),
        has_key=key is not None,
        key=None if key is None else torch.from_numpy(key).to(dev),
        bits=bits)
