"""Helpers that the entries in ``benchmark/ops`` share."""

from __future__ import annotations

import numpy as np

from .reference import chunks


def png_facts(files: list[bytes]) -> dict:
    """``file_bytes`` and ``stream_bytes`` (the zlib stream of the IDAT
    chunks) of each file."""
    streams = [sum(len(p) for k, p in chunks(f) if k == b"IDAT")
               for f in files]
    return {"file_bytes": [len(f) for f in files], "stream_bytes": streams}


def synchronize(result) -> None:
    """Wait for the device work behind ``result`` (a tensor) to end."""
    import torch
    if isinstance(result, torch.Tensor) and result.device.type == "cuda":
        torch.cuda.synchronize(result.device)


def decoded_check(kept, pixels: np.ndarray) -> dict:
    """Bytes of the kept calls' pixels that differ from the source."""
    from .reference import mismatched_bytes
    return {"pixel_bytes_wrong": sum(mismatched_bytes(r, pixels)
                                     for r in kept)}


def to_host(result):
    return result.cpu().numpy() if hasattr(result, "cpu") else result
