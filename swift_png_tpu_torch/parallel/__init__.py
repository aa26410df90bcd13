"""Batched decode and encode entry points of the port, and its scale-out
layer on ``torch.distributed``.

Counterpart of ``swift_png_tpu/parallel``.  The parallel axes:

* **images**: independent images of a batch, one block a process of the
  mesh (``BatchCodec(mesh=…)``);
* **rows**: row shards of the filter select, with a one-row halo from the
  shard above (:func:`filter_select_sharded`);
* **segments**: independent blocks of one deflate stream
  (:func:`~.blocks.deflate_segmented`);
* **buckets**: shape buckets of a mixed corpus dealt out to processes
  (:mod:`.corpus`).

Checksums of shards combine associatively (:mod:`.distributed`).
"""

from .batch import (BatchCodec, decode_stage, encode_stage,
                    filter_select_sharded)
from .blocks import deflate_segmented, segment_tokens
from .corpus import CorpusDecoder, bucket, probe, shard_buckets
from .distributed import (combine_adler_shards, combine_crc_shards,
                          global_mesh, initialize)
from .dryrun import dryrun_multichip

__all__ = ["BatchCodec", "decode_stage", "encode_stage",
           "filter_select_sharded", "deflate_segmented", "segment_tokens",
           "CorpusDecoder", "bucket", "probe", "shard_buckets",
           "combine_adler_shards", "combine_crc_shards", "global_mesh",
           "initialize", "dryrun_multichip"]
