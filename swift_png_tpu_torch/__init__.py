"""swift_png_tpu_torch — the PyTorch/CUDA port of swift_png_tpu.

A package beside the JAX one: it imports ``torch`` and numpy, never
``jax`` and nothing of ``swift_png_tpu``.  Its entry points run on ``cuda``
unless the caller names another device; on a CUDA device the hand-written
kernels in ``csrc/`` run, on the CPU their plain PyTorch versions.

It does everything the JAX package does: batched decode of any
same-shape PNGs (interlaced and iOS files too), :meth:`BatchCodec.decode`;
batched decode of indexed PNGs (files carrying an ``spIx`` checkpoint
chunk), :func:`decode_indexed`; batched inflate of complete zlib streams,
``ops.inflate_checkpoint.CheckpointInflator.inflate_zlib_batch``; batched
encode of every kind the JAX package writes (palettes, Adam7, metadata
chunks, shared trees, every level), :meth:`BatchCodec.encode`; the
scale-out layer, :mod:`.parallel`; and on the host the single-image and
streaming API (:mod:`.png`: ``Image``, ``Context``), the sequential codec
with gzip (:mod:`.lz77`), the colour targets (:mod:`.models`), metadata
dumps (:mod:`.inspection`) and the command line, ``python -m
swift_png_tpu_torch``.
"""

from .parallel.batch import BatchCodec, decode_indexed

__all__ = ["BatchCodec", "decode_indexed"]
