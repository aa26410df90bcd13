"""The port's host layer, as its own copies.

The JAX package's ``lz77/``, ``png/`` and ``models/`` layers are plain
Python, but the port imports nothing of ``swift_png_tpu``: these modules
copy the whole host layer (the index walker and its Huffman tables,
package-merge, the host inflators, deflaters and gzip, the ``Depths``
cost model and block serialization, PNG chunk lexing and writing, the
colour formats and layout, every chunk model and ``Metadata``, the
single-image ``Image``, the streaming ``Context``, the scanline
``Decoder`` and ``Encoder``, file streams and the colour targets), and
the native host library with its ctypes bindings.  The public packages
``swift_png_tpu_torch.png``, ``.lz77`` and ``.models`` re-export them
under the JAX package's names.
"""
