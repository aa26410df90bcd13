"""DEFLATE host layer: constants, errors, canonical Huffman tables, the
checkpoint index walker and the encoder's host parts (copies of
``swift_png_tpu/lz77``)."""
