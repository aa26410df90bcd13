"""PNG host layer: chunk lexing and the IHDR/PLTE/tRNS models (copies of
the parts of ``swift_png_tpu/png`` that indexed decode reads)."""
