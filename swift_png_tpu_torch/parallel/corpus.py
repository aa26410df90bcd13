"""Corpus bucketing and sharding for mixed image collections.

Counterpart of ``swift_png_tpu/parallel/corpus.py``.  A batch holds
images of one size and pixel format, so a mixed corpus is grouped into
buckets by a header-only probe, each bucket decodes in batches, and the
results come back in input order.  A job of several processes deals the
buckets out round-robin (:func:`shard_buckets`); the processes of one
mesh take the images axis within a batch (:class:`CorpusDecoder` with a
mesh).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from .._host.png import chunk as chunks
from .._host.png import parsing
from .._host.png.format import COMMON, IOS

__all__ = ["ImageProbe", "probe", "bucket", "shard_buckets",
           "CorpusDecoder"]


@dataclass(frozen=True)
class ImageProbe:
    """What a header-only probe reads (chunks lexed, nothing inflated)."""

    size: tuple[int, int]
    pixel_name: str
    interlaced: bool
    standard: str

    @property
    def bucket_key(self):
        return (self.size, self.pixel_name, self.interlaced, self.standard)


def probe(data: bytes) -> ImageProbe:
    """Size, pixel format, interlacing and standard (iOS when a CgBI chunk
    comes first) of one PNG, from its first chunks."""
    stream = chunks.ByteSource(data)
    stream.signature()
    type_, payload = stream.chunk()
    standard = COMMON
    if type_ == chunks.CgBI:
        standard = IOS
        type_, payload = stream.chunk()
    header = parsing.Header.parse(payload, standard)
    return ImageProbe(header.size, header.pixel.name, header.interlaced,
                      standard)


def bucket(datas: list[bytes]) -> dict:
    """Group PNG byte strings by ``(size, format, interlaced, standard)``:
    ``{bucket_key: [(input index, bytes), …]}``, keys in order of first
    appearance."""
    out: dict = defaultdict(list)
    for i, data in enumerate(datas):
        out[probe(data).bucket_key].append((i, data))
    return dict(out)


def shard_buckets(buckets: dict, process_index: int, process_count: int):
    """This process's buckets: the keys sorted by ``repr`` and dealt
    round-robin over ``process_count`` processes, the same on every
    process."""
    keys = sorted(buckets.keys(), key=repr)
    return {k: buckets[k] for i, k in enumerate(keys)
            if i % process_count == process_index}


class CorpusDecoder:
    """Decode a mixed corpus: bucket, decode each bucket in batches of
    ``batch_size`` through :class:`~swift_png_tpu_torch.parallel.batch.
    BatchCodec` (on ``device``, or sharded over ``mesh``), and return the
    pixels in input order."""

    def __init__(self, mesh=None, batch_size: int = 8, device=None):
        from .batch import BatchCodec

        self.codec = BatchCodec(device, mesh=mesh)
        self.batch_size = batch_size

    def decode(self, datas: list[bytes], bits: int = 8) -> list[np.ndarray]:
        """``(H, W, 4)`` RGBA pixels of each PNG at ``bits`` = 8 or 16."""
        results: list = [None] * len(datas)
        for items in bucket(datas).values():
            for i in range(0, len(items), self.batch_size):
                part = items[i:i + self.batch_size]
                pixels = self.codec.decode([d for _, d in part], bits=bits)
                for row, (j, _) in enumerate(part):
                    results[j] = pixels[row]
        return results
