"""The rest of the batched encode: ``BatchCodec("cpu").encode`` against the
JAX ``BatchCodec().encode`` on the same seeded inputs, byte for byte —
sub-byte gray and indexed kinds at odd widths, shared and per-image
palettes with alpha, Adam7, bgr8/bgra8 (written as iOS files over a zlib
stream, as the JAX package writes them), metadata with every chunk model,
``index=True`` with Adam7 (no ``spIx``), shared trees and the levels the
host ``Deflator`` serves.  Both packages' native libraries are switched
off, except in the cases marked ``on``, where both are on.  The Adam7
cases are in ``tests/test_torch_encode_adam7.py``.  Every
output is read back: through the port's ``BatchCodec("cpu").decode`` to
the expected pixels, or, for the iOS kinds (whose CgBI chunk announces
raw DEFLATE over a zlib stream), through ``zlib`` to the port's filtered
bytes.  The chunk models' bytes and parses are held against the JAX
package's too."""

import zlib

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import swift_png_tpu.native as jax_native
import swift_png_tpu_torch._host.native as torch_native
from swift_png_tpu.png import errors as jerrors
from swift_png_tpu.png import parsing as jparsing
from swift_png_tpu.png.metadata import Metadata as JaxMetadata
from swift_png_tpu.parallel.batch import BatchCodec as JaxBatchCodec
from swift_png_tpu_torch import BatchCodec
from swift_png_tpu_torch._host.png import chunk as tchunk
from swift_png_tpu_torch._host.png import errors as terrors
from swift_png_tpu_torch._host.png import parsing as tparsing
from swift_png_tpu_torch._host.png.format import Format, Layout
from swift_png_tpu_torch._host.png.metadata import Metadata
from swift_png_tpu_torch.ops.inflate_fused import InflateFused
from swift_png_tpu_torch.parallel import batch as port_batch
from swift_png_tpu_torch.parallel.batch import filter_batch

CPU = torch.device("cpu")

_DEPTH = {"v1": 1, "v2": 2, "v4": 4, "v8": 8, "v16": 16, "va8": 8,
          "rgb8": 8, "rgba8": 8, "rgba16": 16, "bgr8": 8, "bgra8": 8,
          "indexed1": 1, "indexed2": 2, "indexed4": 4, "indexed8": 8}
_CHANNELS = {"v": 1, "va": 2, "rgb": 3, "rgba": 4, "bgr": 3, "bgra": 4,
             "indexed": 1}


@pytest.fixture(autouse=True)
def _small_engine():
    """One torch thread (the suite runs files side by side); the CPU fused
    inflate of the read-backs at a 4 KB window and 1,024 ranks
    (``tests/test_torch_decode_general.py`` holds it at both)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = dict(port_batch._FUSED)
    port_batch._FUSED[CPU] = InflateFused(win_bytes=1 << 12, t_max=1 << 10,
                                          device=CPU)
    yield
    port_batch._FUSED.clear()
    port_batch._FUSED.update(saved)
    torch.set_num_threads(threads)


@pytest.fixture(params=["off"])
def native(request, monkeypatch):
    if request.param == "off":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(torch_native, "available", lambda: False)
    elif not (jax_native.available() and torch_native.available()):
        pytest.fail(f"a native library did not load: "
                    f"{torch_native.last_error()}")
    return request.param


def _channels(kind):
    return _CHANNELS[kind.rstrip("0123456789")]


def _pixels(kind, B, H, W, seed):
    """Seeded samples in the kind's depth; ``(B, H, W)`` for one
    channel."""
    rng = np.random.default_rng(seed)
    depth = _DEPTH[kind]
    c = _channels(kind)
    shape = (B, H, W) if c == 1 else (B, H, W, c)
    px = rng.integers(0, 1 << depth, shape)
    px[-1] = px[-1] >> max(depth // 2, 1) << max(depth // 2, 1)  # smoother
    return px.astype(np.uint16 if depth == 16 else np.uint8)


def _palette(n, seed, alpha=True):
    rng = np.random.default_rng(seed)
    return tuple((int(r), int(g), int(b),
                  int(a) if alpha and i % 3 else 255)
                 for i, (r, g, b, a) in enumerate(
                     rng.integers(0, 256, (n, 4))))


def _expected_rgba(px, kind, palettes):
    """The RGBA a decode of ``px`` gives: 8 bits a sample, 16 for
    16-bit kinds (exact rescale ``v · (2^bits − 1) / (2^depth − 1)``)."""
    depth = _DEPTH[kind]
    bits = 16 if depth == 16 else 8
    top = (1 << bits) - 1
    x = px.astype(np.int64)
    if kind.startswith("indexed"):
        return np.stack([np.asarray(p, np.int64)[i]
                         for i, p in zip(x, palettes)])
    if x.ndim == 3:
        x = x[..., None]
    x = x * (top // ((1 << depth) - 1))
    opaque = np.full(x.shape[:3] + (1,), top)
    c = x.shape[-1]
    if c == 1:
        return np.concatenate([x, x, x, opaque], -1)
    if c == 2:
        return np.concatenate([x[..., :1]] * 3 + [x[..., 1:]], -1)
    if c == 3:
        return np.concatenate([x, opaque], -1)
    return x


def _chunks(png):
    src = tchunk.ByteSource(png)
    src.signature()
    out = []
    while not out or out[-1][0] != tchunk.IEND:
        out.append(src.chunk())
    return out


def _check(px, kind="rgba8", read_back=True, **kw):
    """Port bytes == JAX bytes; then the read-back."""
    got = BatchCodec("cpu").encode(px, kind=kind, **kw)
    want = JaxBatchCodec().encode(px, kind=kind, **kw)
    assert got == want
    palettes = kw.get("palettes") or [kw.get("palette")] * len(got)
    if kind in ("bgr8", "bgra8"):
        # CgBI first: the decoder reads raw DEFLATE, the stream is zlib
        samples = torch.from_numpy(px.astype(np.int32))
        flat = filter_batch(samples, 8, _channels(kind),
                            kw.get("interlaced", False)).numpy()
        for i, png in enumerate(got):
            chunks = _chunks(png)
            assert chunks[0][0] == tchunk.CgBI
            idat = b"".join(p for k, p in chunks if k == tchunk.IDAT)
            assert zlib.decompress(idat) == flat[i].tobytes()
    elif read_back:
        bits = 16 if _DEPTH[kind] == 16 else 8
        out = BatchCodec("cpu").decode(got, bits=bits)
        np.testing.assert_array_equal(out, _expected_rgba(px, kind,
                                                          palettes))
    return got


# ---- kinds, palettes and levels ---------------------------------------------

_KIND_LEVELS = ([(k, 6) for k in ("v1", "v2", "v4", "indexed1", "indexed2",
                                   "indexed4", "indexed8")]
                + [(k, 9) for k in ("v4", "indexed8")]
                + [(k, 1) for k in ("v1", "v2", "indexed1", "indexed2",
                                    "indexed4")])


@pytest.mark.parametrize("kind,level", _KIND_LEVELS)
def test_sub_byte_and_indexed_kinds_match_jax(kind, level, native):
    px = _pixels(kind, 2, 7, 13, len(kind))
    pal = (_palette(1 << min(_DEPTH[kind], 8), 3)
           if kind.startswith("indexed") else None)
    got = _check(px, kind, level=level, palette=pal)
    kinds = [k for k, _ in _chunks(got[0])]
    if pal is not None:
        assert kinds[1:4] == [tchunk.PLTE, tchunk.tRNS, tchunk.IDAT]


@pytest.mark.parametrize("level", [4, 6])
def test_per_image_palettes_with_alpha_match_jax(level, native):
    px = _pixels("indexed8", 2, 9, 11, 8)
    pals = [_palette(256, 1), _palette(256, 2, alpha=False)]
    got = _check(px, "indexed8", level=level, palettes=pals)
    # the opaque palette writes no tRNS
    assert tchunk.tRNS not in [k for k, _ in _chunks(got[1])]
    assert tchunk.tRNS in [k for k, _ in _chunks(got[0])]


def test_palette_with_trailing_opaque_entries_trims_trns(native):
    pal = ((1, 2, 3, 7), (4, 5, 6, 255), (7, 8, 9, 0)) + ((0, 0, 0, 255),) * 5
    layout = Layout(Format("indexed4", pal))
    assert layout.transparency.value == [7, 255, 0]
    px = np.random.default_rng(4).integers(0, 8, (2, 5, 7)).astype(np.uint8)
    _check(px, "indexed4", level=6, palette=pal)


def test_suggested_palette_of_an_rgb_image_matches_jax(native):
    px = _pixels("rgb8", 2, 6, 9, 5)
    pal = tuple((i, 2 * i, 3 * i) for i in range(40))
    got = _check(px, "rgb8", level=6, palette=pal)
    assert [k for k, _ in _chunks(got[0])][1] == tchunk.PLTE


@pytest.mark.parametrize("level", [0, 1, 4, 6, 7])
def test_host_deflator_levels_match_jax(level, native):
    """Without the native library, levels <= 7 run the host Deflator."""
    _check(_pixels("rgba8", 2, 12, 17, level), "rgba8", level=level)


@pytest.mark.parametrize("native", ["off", "on"], indirect=True)
@pytest.mark.parametrize("level", [6, 9])
def test_levels_match_jax_with_native_on_and_off(level, native):
    px = _pixels("va8", 2, 17, 33, level)
    _check(px, "va8", level=level, index=True)


# ---- the inputs refused before ----------------------------------------------

@pytest.mark.parametrize("kw", [dict(kind="indexed8"), dict(level=6),
                                dict(interlaced=True),
                                dict(shared_trees=True),
                                dict(palette=((1, 2, 3),))],
                         ids=["indexed", "level6", "interlaced", "shared",
                              "palette"])
def test_formerly_refused_inputs_match_jax(kw, native):
    """The inputs the port refused before it served these options: the
    same bytes as the JAX package (or, for an indexed kind without a
    palette, the same error case).  Zero images, as then, but two of them
    at the Adam7 tests' 33×17, so that the JAX side reuses their
    compiled shapes."""
    px = np.zeros((2, 17, 33, 4), np.uint8)
    if kw.get("kind") == "indexed8":
        with pytest.raises(terrors.ParsingError) as mine:
            BatchCodec("cpu").encode(px, **kw)
        with pytest.raises(jerrors.ParsingError) as theirs:
            JaxBatchCodec().encode(px, **kw)
        assert mine.value.case == theirs.value.case
        return
    _check(px, **kw)


# ---- iOS kinds --------------------------------------------------------------

@pytest.mark.parametrize("kind,level,interlaced", [
    ("bgra8", 1, False), ("bgra8", 6, False), ("bgr8", 6, False),
    ("bgr8", 1, False), ("bgra8", 6, True)])
def test_bgr_kinds_match_jax(kind, level, interlaced, native):
    px = _pixels(kind, 2, 17, 33, level)   # the Adam7 tests' shape
    got = _check(px, kind, level=level, interlaced=interlaced)
    assert _chunks(got[0])[0] == (tchunk.CgBI, bytes(
        [48, 0, 32, 2 if kind == "bgra8" else 6]))


# ---- metadata ---------------------------------------------------------------

def _metadata(P, M, seed=0):
    """Every chunk model, built from one of the two packages' modules."""
    return M(
        time=P.TimeModified(2024, 2, 29, 23, 59, 60 - seed),
        chromaticity=P.Chromaticity((31270, 32900), (64000, 33000),
                                    (30000, 60000), (15000, 6000)),
        color_profile=P.ColorProfile("profile", bytes(range(100)) * 2),
        color_rendering=P.ColorRendering(seed % 4),
        gamma=P.Gamma(45455 + seed),
        histogram=P.Histogram([i * 3 + seed for i in range(40)]),
        physical_dimensions=P.PhysicalDimensions((2835, 3780), "meter"),
        significant_bits=P.SignificantBits("rgb", (5, 6, 5)),
        suggested_palettes=[
            P.SuggestedPalette("eight", 8, [((1, 2, 3, 4), 9),
                                            ((5, 6, 7, 8), 2)]),
            P.SuggestedPalette("sixteen", 16, [((1000, 2, 3, 65535), 3)])],
        text=[P.Text(True, ("Title", "Titel"), "de", "über alles " * 9),
              P.Text(False, ("Author", ""), "", "someone"),
              P.Text(True, ("Comment", ""), "en-US", "x" * (seed + 1))],
        application=[("prVt", bytes([seed, 1, 2]))])


@pytest.mark.parametrize("per_image", [False, True],
                         ids=["shared", "per_image"])
def test_metadata_with_every_chunk_model_matches_jax(per_image, native):
    px = _pixels("indexed8", 2, 6, 7, 9)
    if per_image:
        kw_t = [_metadata(tparsing, Metadata, s) for s in range(2)]
        kw_j = [_metadata(jparsing, JaxMetadata, s) for s in range(2)]
    else:
        kw_t = _metadata(tparsing, Metadata)
        kw_j = _metadata(jparsing, JaxMetadata)
    pal = _palette(40, 7)
    got = BatchCodec("cpu").encode(px % 40, kind="indexed8", level=6,
                                   palette=pal, metadata=kw_t)
    want = JaxBatchCodec().encode(px % 40, kind="indexed8", level=6,
                                  palette=pal, metadata=kw_j)
    assert got == want
    kinds = [k for k, _ in _chunks(got[1])]
    assert kinds[:8] == ["IHDR", "cHRM", "gAMA", "sRGB", "iCCP", "sBIT",
                         "PLTE", "tRNS"]
    assert kinds[8:12] == ["hIST", "pHYs", "tIME", "iTXt"]
    out = BatchCodec("cpu").decode(got)
    np.testing.assert_array_equal(out, _expected_rgba(px % 40, "indexed8",
                                                      [pal, pal]))


_MODELS = {
    "Palette": lambda P: P.Palette([(1, 2, 3), (4, 5, 6)]),
    "Transparency": lambda P: P.Transparency("rgb", (1, 300, 65535)),
    "Background": lambda P: P.Background("rgb", (7, 8, 9)),
    "Histogram": lambda P: P.Histogram([1, 2]),
    "Gamma": lambda P: P.Gamma(100000),
    "Chromaticity": lambda P: P.Chromaticity((1, 2), (3, 4), (5, 6),
                                             (7, 8)),
    "ColorRendering": lambda P: P.ColorRendering(2),
    "ColorProfile": lambda P: P.ColorProfile("icc", b"\x00\x01" * 20),
    "SignificantBits": lambda P: P.SignificantBits("rgb", (5, 6, 5)),
    "PhysicalDimensions": lambda P: P.PhysicalDimensions((1, 2), "none"),
    "TimeModified": lambda P: P.TimeModified(1999, 12, 31, 23, 59, 59),
    "SuggestedPalette": lambda P: P.SuggestedPalette(
        "s", 16, [((1, 2, 3, 4), 5)]),
    "Text": lambda P: P.Text(True, ("Key", "Schlüssel"), "de-CH", "wert"),
}


def _parse(P, name, data):
    pixel = P.recognize_pixel((16, 2))
    if name in ("Transparency", "Background"):
        return getattr(P, name).parse(data, pixel, None)
    if name == "Palette":
        return P.Palette.parse(data, P.recognize_pixel((8, 3)))
    if name == "Histogram":
        return P.Histogram.parse(data, P.Palette([(0, 0, 0)] * 2))
    if name == "SignificantBits":
        return P.SignificantBits.parse(data, pixel)
    if name == "Text":
        return P.Text.parse(data, unicode=True)
    return getattr(P, name).parse(data)


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_chunk_models_serialize_and_parse_as_jax(name):
    got = _MODELS[name](tparsing).serialized
    assert got == _MODELS[name](jparsing).serialized
    mine, theirs = _parse(tparsing, name, got), _parse(jparsing, name, got)
    assert mine.__dict__ == theirs.__dict__
    assert mine == _MODELS[name](tparsing)


@pytest.mark.parametrize("data,case", [
    (b"k\x00\x05", "invalidColorProfileCompressionMethodCode"),
    (b"k\x00\x00\x78\x9c\x03", "incompleteColorProfileCompressedDatastream"),
    (b"\x00\x00", "invalidColorProfileName")])
def test_color_profile_parse_errors_match_jax(data, case):
    with pytest.raises(terrors.ParsingError) as mine:
        tparsing.ColorProfile.parse(data)
    with pytest.raises(jerrors.ParsingError) as theirs:
        jparsing.ColorProfile.parse(data)
    assert mine.value.case == theirs.value.case == case


# ---- shared trees and argument errors ---------------------------------------

@pytest.mark.parametrize("kind,level", [("rgba8", 6), ("indexed4", 3)])
def test_shared_trees_encode_matches_jax(kind, level, native):
    px = _pixels(kind, 3, 20, 31, level)
    pal = _palette(16, 2) if kind == "indexed4" else None
    _check(px, kind, level=level, shared_trees=True, palette=pal)


@pytest.mark.parametrize("kw,exc", [
    (dict(kind="indexed8"), "invalidPaletteCount"),
    (dict(kind="indexed1", palette=_palette(3, 1)), "invalidPaletteCount"),
    (dict(kind="rgb8"), ValueError),
    (dict(kind="rgba8", palettes=[None]), ValueError)])
def test_encode_argument_errors_match_jax(kw, exc):
    px = np.zeros((2, 3, 3, 4), np.uint8)
    if kw["kind"].startswith("indexed"):
        px = px[..., 0]
    if isinstance(exc, str):
        with pytest.raises(terrors.ParsingError) as mine:
            BatchCodec("cpu").encode(px, **kw)
        with pytest.raises(jerrors.ParsingError) as theirs:
            JaxBatchCodec().encode(px, **kw)
        assert mine.value.case == theirs.value.case == exc
    else:
        with pytest.raises(exc):
            BatchCodec("cpu").encode(px, **kw)
        with pytest.raises(exc):
            JaxBatchCodec().encode(px, **kw)
