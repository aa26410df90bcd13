"""The JAX package's examples (``examples/``), run against the port: one
module each, with the same name and ``main`` (``batch_decode_tpu`` is
:mod:`.batch_decode_cuda`, on a ``torch.distributed`` mesh).  Each runs
as ``python -m swift_png_tpu_torch.examples.<name> [arguments]``.  The
two device examples, :mod:`.indexed_decode` and :mod:`.batch_decode_cuda`,
run on ``cuda`` unless the caller passes ``device="cpu"``."""
