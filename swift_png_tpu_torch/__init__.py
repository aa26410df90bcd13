"""swift_png_tpu_torch — the PyTorch/CUDA port of swift_png_tpu.

A package beside the JAX one: it imports ``torch`` and numpy, never
``jax`` and nothing of ``swift_png_tpu``.  Its entry points run on ``cuda``
unless the caller names another device; on a CUDA device the hand-written
kernels in ``csrc/`` run, on the CPU their plain PyTorch versions.

Served so far: batched decode of indexed PNGs (files carrying an ``spIx``
checkpoint chunk), :func:`decode_indexed`.
"""

from .parallel.batch import decode_indexed

__all__ = ["decode_indexed"]
