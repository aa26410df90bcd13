"""PNG host layer: chunk lexing and writing, the IHDR/PLTE/tRNS models and
the IHDR-only pre-IDAT writer (copies of the parts of ``swift_png_tpu/png``
that indexed decode and the batched encoder read)."""
