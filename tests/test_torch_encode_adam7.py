"""Adam7 in the batched encode: ``BatchCodec("cpu").encode(...,
interlaced=True)`` against the JAX ``BatchCodec().encode`` on the same
seeded inputs, byte for byte — rgba8 and v4 at 33×17 through the host
``Deflator`` (level 6) and the device parse (level 9, which the JAX
package hands the full width's pitch), images so small that passes are
empty, indexed8 with ``index=True`` (no ``spIx`` for interlaced images),
rgba16, and a bgra8 image with every chunk model.  Read back as
``tests/test_torch_encode_general.py`` does, whose helpers and fixtures
these cases share."""

import pytest

import conftest  # noqa: F401

from swift_png_tpu.parallel.batch import BatchCodec as JaxBatchCodec
from swift_png_tpu.png import parsing as jparsing
from swift_png_tpu.png.metadata import Metadata as JaxMetadata
from swift_png_tpu_torch import BatchCodec
from swift_png_tpu_torch._host.png import chunk as tchunk
from swift_png_tpu_torch._host.png import parsing as tparsing
from swift_png_tpu_torch._host.png.metadata import Metadata
from test_torch_encode_general import (  # noqa: F401  (fixtures)
    _check, _chunks, _metadata, _palette, _pixels, _small_engine, native)


@pytest.mark.parametrize("level", [6, 9])
@pytest.mark.parametrize("kind", ["rgba8", "v4"])
def test_adam7_matches_jax(kind, level, native):
    px = _pixels(kind, 2, 17, 33, level)
    got = _check(px, kind, level=level, interlaced=True)
    assert _chunks(got[0])[0][1][12] == 1       # IHDR: interlaced


@pytest.mark.parametrize("size", [(1, 1), (3, 2), (5, 5), (9, 4)])
def test_adam7_small_images_with_empty_passes_match_jax(size, native):
    W, H = size
    _check(_pixels("rgb8", 2, H, W, W * H), "rgb8", level=6,
           interlaced=True)


@pytest.mark.parametrize("native", ["off", "on"], indirect=True)
@pytest.mark.parametrize("level", [6, 9])
def test_adam7_indexed_with_index_writes_no_spix(level, native):
    px = _pixels("indexed8", 2, 10, 21, 6)
    got = _check(px, "indexed8", level=level, palette=_palette(256, 6),
                 interlaced=True, index=True)
    assert all(tchunk.spIx not in [k for k, _ in _chunks(g)] for g in got)


def test_adam7_rgba16_matches_jax(native):
    _check(_pixels("rgba16", 2, 9, 10, 16), "rgba16", level=6, bits=16,
           interlaced=True)


def test_metadata_on_an_adam7_bgra8_image_matches_jax(native):
    px = _pixels("bgra8", 2, 17, 33, 1)
    got = BatchCodec("cpu").encode(
        px, kind="bgra8", level=6, interlaced=True,
        metadata=_metadata(tparsing, Metadata, 3))
    want = JaxBatchCodec().encode(
        px, kind="bgra8", level=6, interlaced=True,
        metadata=_metadata(jparsing, JaxMetadata, 3))
    assert got == want
