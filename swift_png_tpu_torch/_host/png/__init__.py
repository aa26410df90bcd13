"""PNG host layer: chunk lexing and writing, the colour formats and
layout, every chunk model, the ``Metadata`` of the ancillary chunks and
the pre-IDAT writer (copies of the parts of ``swift_png_tpu/png`` that
batched decode and encode read)."""
