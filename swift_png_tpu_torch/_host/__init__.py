"""Host layers the port needs, as its own copies.

The JAX package's ``lz77/`` and ``png/`` layers are plain Python, but the
port imports nothing of ``swift_png_tpu``: these modules copy the parts of
them that indexed decode and the level 8–13 encoder read (the index walker
and its Huffman tables, package-merge, the ``Depths`` cost model and block
serialization, PNG chunk lexing and writing, and the IHDR/PLTE/tRNS
models).
"""
