"""Host layers the port needs, as its own copies.

The JAX package's ``lz77/`` and ``png/`` layers are plain Python, but the
port imports nothing of ``swift_png_tpu``: these modules copy the parts of
them that indexed decode reads (the index walker and its Huffman tables,
PNG chunk lexing and the IHDR/PLTE/tRNS models).
"""
