"""DEFLATE host layer: constants, errors, canonical Huffman tables and the
checkpoint index walker (copies of ``swift_png_tpu/lz77``)."""
