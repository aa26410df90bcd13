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
``swift_png_tpu_torch.png``, ``.lz77``, ``.models``, ``.utils`` and the
top-level package serve them under the JAX package's module paths
(:func:`publish`).
"""

import sys


def publish(package: str, *modules) -> None:
    """Serve each of ``modules`` under ``<package>.<its last name>`` as
    well: the same module object under both paths, so a dotted import, an
    ``isinstance`` check and a monkeypatch all see one copy of the code
    and of its state."""
    for module in modules:
        sys.modules[f"{package}.{module.__name__.rpartition('.')[2]}"] = module
