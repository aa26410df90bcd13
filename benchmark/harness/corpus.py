"""Inputs of a run: images from a content recipe and the seed, and PNG files
written as the configuration's writer settings say.

The filter and the container writer are a frozen copy of the recipes of
``chip_smoke.py`` (``filter_minsum``, ``png_chunk``, ``plain_png``): the
benchmark keeps its own so that no later change to the smoke script moves
the yardstick.  Only 8-bit RGBA, non-interlaced, is
written here; a configuration asking for anything else is refused.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SIGNATURE = bytes([137, 80, 78, 71, 13, 10, 26, 10])
STRATEGIES = {"default": zlib.Z_DEFAULT_STRATEGY, "filtered": zlib.Z_FILTERED}


def threads() -> int:
    """Worker threads for making inputs: the host's cores, at most 8."""
    return max(1, min(8, os.cpu_count() or 1))


def make_images(recipe, seed: int, batch: int, height: int,
                width: int) -> np.ndarray:
    """``(batch, height, width, 4)`` uint8 images, image ``b`` from
    ``recipe.image(seed, b, height, width)`` (``seed`` is the run's, any
    non-negative whole number, also past 32 bits)."""
    with ThreadPoolExecutor(threads()) as pool:
        imgs = list(pool.map(
            lambda b: recipe.image(seed, b, height, width), range(batch)))
    out = np.stack(imgs)
    if out.shape != (batch, height, width, 4) or out.dtype != np.uint8:
        raise ValueError(f"recipe gave {out.shape} {out.dtype}, not "
                         f"{(batch, height, width, 4)} uint8")
    return out


def filter_candidates(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The five PNG filter residuals (None, Sub, Up, Average, Paeth) of raw
    ``(..., H, pitch)`` rows: ``(5, ..., H, pitch)`` uint8."""
    raw = rows.astype(np.int16)
    up = np.zeros_like(raw)
    up[..., 1:, :] = raw[..., :-1, :]
    left = np.zeros_like(raw)
    left[..., bpp:] = raw[..., :-bpp]
    ul = np.zeros_like(raw)
    ul[..., bpp:] = up[..., :-bpp]
    pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    return np.stack([(raw - pred) & 255 for pred in
                     (0, left, up, (left + up) >> 1, paeth)]).astype(np.uint8)


def filter_minsum(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG-filter ``(H, pitch)`` rows, each with the type (lowest on a tie)
    whose residual bytes, read as signed, have the least sum of magnitudes
    (libpng's adaptive heuristic, PNG specification 12.8)."""
    res = filter_candidates(rows, bpp)
    score = np.abs(res.view(np.int8).astype(np.int32)).sum(2)
    ft = score.argmin(0)
    h = rows.shape[0]
    return np.hstack([ft[:, None].astype(np.uint8), res[ft, np.arange(h)]])


FILTERS = {"minsum": filter_minsum}


def png_chunk(kind: bytes, data: bytes) -> bytes:
    return (len(data).to_bytes(4, "big") + kind + data
            + zlib.crc32(kind + data).to_bytes(4, "big"))


def ihdr(width: int, height: int) -> bytes:
    """The IHDR payload of an 8-bit RGBA non-interlaced image."""
    return (width.to_bytes(4, "big") + height.to_bytes(4, "big")
            + bytes([8, 6, 0, 0, 0]))


def write_png(pixels: np.ndarray, writer: dict) -> bytes:
    """One ``(H, W, 4)`` uint8 image as a PNG the way ``writer`` says:
    ``filter``, ``zlib_level``, ``zlib_strategy``, ``zlib_window_bits``,
    ``zlib_mem_level`` and ``idat_bytes`` (IDAT chunk size)."""
    h, w = pixels.shape[:2]
    filtered = FILTERS[writer["filter"]](pixels.reshape(h, w * 4), 4)
    comp = zlib.compressobj(writer["zlib_level"], zlib.DEFLATED,
                            writer["zlib_window_bits"],
                            writer["zlib_mem_level"],
                            STRATEGIES[writer["zlib_strategy"]])
    stream = comp.compress(filtered.tobytes()) + comp.flush()
    step = writer["idat_bytes"]
    out = [SIGNATURE, png_chunk(b"IHDR", ihdr(w, h))]
    out += [png_chunk(b"IDAT", stream[o:o + step])
            for o in range(0, len(stream), step)]
    out.append(png_chunk(b"IEND", b""))
    return b"".join(out)


def check_config(cfg: dict) -> None:
    if (cfg["bit_depth"], cfg["color_type"], cfg["interlaced"]) != (8, 6,
                                                                    False):
        raise ValueError(f"{cfg['name']}: the corpus writes 8-bit RGBA, "
                         "non-interlaced images only")
    if cfg["writer"]["filter"] not in FILTERS:
        raise ValueError(f"{cfg['name']}: unknown filter "
                         f"{cfg['writer']['filter']!r}")


def make_files(pixels: np.ndarray, writer: dict) -> list[bytes]:
    """Each image of ``pixels`` written by :func:`write_png`, on threads
    (numpy and zlib release the interpreter lock)."""
    with ThreadPoolExecutor(threads()) as pool:
        return list(pool.map(lambda px: write_png(px, writer), pixels))
