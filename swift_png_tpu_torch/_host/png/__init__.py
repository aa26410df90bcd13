"""PNG host layer: chunk lexing and writing, the colour formats and
layout, every chunk model, the ``Metadata`` of the ancillary chunks, the
single-image ``Image`` with the pre-IDAT writer, the streaming
``Context``, the scanline ``Decoder`` and ``Encoder`` and the file
streams (copies of ``swift_png_tpu/png``)."""
