"""DEFLATE host layer: constants, errors, canonical Huffman tables, the
checkpoint index walker, the host inflator and the host deflator (copies
of ``swift_png_tpu/lz77``)."""
