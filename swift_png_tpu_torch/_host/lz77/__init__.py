"""DEFLATE host layer: constants, errors, canonical Huffman tables, the
checkpoint index walker, the host inflators (zlib, iOS, gzip), the host
and native deflaters and gzip (copies of ``swift_png_tpu/lz77``)."""
