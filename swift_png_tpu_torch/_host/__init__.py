"""Host layers the port needs, as its own copies.

The JAX package's ``lz77/`` and ``png/`` layers are plain Python, but the
port imports nothing of ``swift_png_tpu``: these modules copy the parts of
them that batched decode and encode read (the index walker and its Huffman
tables, package-merge, the host inflator and deflator, the ``Depths`` cost
model and block serialization, PNG chunk lexing and writing, the colour
formats and layout, every chunk model and ``Metadata``), and the native
host library with its ctypes bindings.
"""
