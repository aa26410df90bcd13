"""The port's single-image API (``swift_png_tpu_torch.png.Image``) against
the JAX package's ``swift_png_tpu.png.Image`` on the same seeded pixels:
``compress_bytes`` byte for byte for every colour kind, plain and Adam7,
at the Python engine's levels 0, 6 and 9 and the native engine's 9 and 13,
with ``index=True``; ``decompress_bytes`` pixels through every colour
target, the layout and the metadata; ``pack`` and ``unpack`` with a custom
indexer and deindexer; ``FileSource`` and ``FileDestination``.  Both
packages' native libraries are off unless a case says ``on``, where both
are on.  Images stay at 32×32 or less: the pure-Python inflater and
deflater carry most cases."""

import numpy as np
import pytest

import conftest  # noqa: F401

import swift_png_tpu.native as jax_native
import swift_png_tpu_torch._host.native as torch_native
from swift_png_tpu import models as jmodels
from swift_png_tpu import png as jpng
from swift_png_tpu.png import parsing as jparsing
from swift_png_tpu_torch import models as tmodels
from swift_png_tpu_torch import png as tpng
from swift_png_tpu_torch.png import parsing as tparsing

KINDS = ["v1", "v2", "v4", "v8", "v16", "va8", "va16", "rgb8", "rgb16",
         "rgba8", "rgba16", "indexed1", "indexed2", "indexed4", "indexed8",
         "bgr8", "bgra8"]
SIZES = [(1, 1), (13, 7), (32, 32)]


@pytest.fixture(params=["off", "on"])
def native(request, monkeypatch):
    """Both packages' native libraries on or off together."""
    if request.param == "off":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(torch_native, "available", lambda: False)
    elif not (jax_native.available() and torch_native.available()):
        pytest.fail("a native library did not build")
    return request.param


@pytest.fixture
def native_off(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(torch_native, "available", lambda: False)


def _depth(kind):
    return int("".join(c for c in kind if c.isdigit()))


def _palette(n, seed):
    """``n`` distinct RGBA entries, the first three translucent."""
    rng = np.random.default_rng(seed)
    rgb = rng.permutation(1 << 12)[:n]
    alpha = [0, 90, 200][:n] + [255] * max(0, n - 3)
    return tuple((int(c >> 8) * 17, int(c >> 4 & 15) * 17, int(c & 15) * 17,
                  alpha[i]) for i, c in enumerate(rgb))


def _case(kind, w, h, seed, extras=False):
    """``(pixels, format fields)``: pixels ``(h, w, 4)`` (uint16 for the
    16-bit kinds) that the kind holds exactly.  ``extras`` adds a bKGD
    fill, a chroma key and a suggested PLTE where the kind takes them."""
    rng = np.random.default_rng(seed)
    depth = _depth(kind)
    if kind.startswith("indexed"):
        pal = _palette(1 << depth, seed)
        idx = rng.integers(0, len(pal), (h, w))
        px = np.array(pal, np.uint8)[idx]
        return px, dict(palette=pal, fill=1 if extras else None, key=None)
    wide = depth == 16
    dtype, top = (np.uint16, 65535) if wide else (np.uint8, 255)
    px = rng.integers(0, top + 1, (h, w, 4)).astype(dtype)
    fields = dict(palette=(), fill=None, key=None)
    if kind[0] == "v":
        s = rng.integers(0, 1 << depth, (h, w))
        v = (s * (top // ((1 << depth) - 1))).astype(dtype)
        px[..., 0] = px[..., 1] = px[..., 2] = v
        if kind.startswith("v") and not kind.startswith("va"):
            px[..., 3] = top
            if extras:
                fields.update(fill=int(s[0, 0]), key=int(s[-1, -1]))
    elif kind in ("rgb8", "rgb16", "bgr8"):
        px[..., 3] = top
        if extras:
            key = tuple(int(x) for x in px[-1, -1, :3])
            fields.update(fill=(1, 2, 3), key=key,
                          palette=tuple(p[:3] for p in _palette(5, seed)))
    elif extras:
        fields.update(fill=(7, 8, 9))
    return px, fields


def _layouts(kind, fields, interlaced):
    return (jpng.Layout(jpng.Format(kind, **fields), interlaced),
            tpng.Layout(tpng.Format(kind, **fields), interlaced))


def _images(kind, w, h, seed, interlaced=False, extras=False):
    px, fields = _case(kind, w, h, seed, extras)
    jl, tl = _layouts(kind, fields, interlaced)
    return px, jpng.Image.pack(px, jl), tpng.Image.pack(px, tl)


def _layout_fields(layout):
    f = layout.format
    return (f.kind, f.palette, f.fill, f.key, layout.interlaced)


def _targets(m):
    return [m.RGBA.of8, m.RGBA.of16, m.V.of8, m.V.of16, m.VA.of8, m.VA.of16]


def _same_decode(blob):
    """Both packages decode ``blob`` to the same storage, pixels in every
    target, layout and metadata; returns the port's image."""
    j = jpng.Image.decompress_bytes(blob)
    t = tpng.Image.decompress_bytes(blob)
    assert t.size == j.size
    assert _layout_fields(t.layout) == _layout_fields(j.layout)
    assert repr(t.metadata) == repr(j.metadata)
    assert np.array_equal(t.storage, j.storage)
    for jt, tt in zip(_targets(jmodels), _targets(tmodels)):
        a, b = j.unpack(jt), t.unpack(tt)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return t


@pytest.mark.parametrize("interlaced", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
@pytest.mark.parametrize("kind", KINDS)
def test_compress_bytes_matches_jax_every_kind(kind, size, interlaced,
                                               native):
    w, h = size
    px, jimg, timg = _images(kind, w, h, KINDS.index(kind) * 7 + w,
                             interlaced)
    blob = timg.compress_bytes(level=6)
    assert blob == jimg.compress_bytes(level=6)
    t = _same_decode(blob)
    got = t.unpack_rgba16() if px.dtype == np.uint16 else t.unpack_rgba8()
    assert np.array_equal(got, px)


@pytest.mark.parametrize("kind", ["v8", "rgb8", "rgb16", "indexed4", "va8",
                                  "bgr8"])
def test_compress_bytes_with_fill_key_and_palette(kind, native_off):
    px, jimg, timg = _images(kind, 13, 7, 3, extras=True)
    blob = timg.compress_bytes(level=6)
    assert blob == jimg.compress_bytes(level=6)
    _same_decode(blob)


@pytest.mark.parametrize("level", [0, 6, 9])
@pytest.mark.parametrize("kind,interlaced", [("rgba8", False),
                                             ("rgb16", True),
                                             ("indexed2", False)])
def test_python_engine_levels(kind, interlaced, level, native_off):
    _, jimg, timg = _images(kind, 13, 7, level, interlaced)
    blob = timg.compress_bytes(level=level, engine="python", hint=64)
    assert blob == jimg.compress_bytes(level=level, engine="python", hint=64)
    _same_decode(blob)


@pytest.mark.parametrize("level", [9, 13])
@pytest.mark.parametrize("kind,interlaced", [("rgba8", False),
                                             ("va16", True), ("v4", False),
                                             ("bgra8", False)])
def test_native_engine_levels(kind, interlaced, level):
    if not (jax_native.available() and torch_native.available()):
        pytest.fail("a native library did not build")
    _, jimg, timg = _images(kind, 32, 32, level, interlaced)
    for engine in ("native", "auto"):
        blob = timg.compress_bytes(level=level, engine=engine, hint=1000)
        assert blob == jimg.compress_bytes(level=level, engine=engine,
                                           hint=1000)
    _same_decode(blob)


@pytest.mark.parametrize("interlaced", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ob", [64, 256])
def test_index_chunk_matches_jax(ob, interlaced, native):
    _, jimg, timg = _images("rgba8", 32, 32, ob, interlaced)
    blob = timg.compress_bytes(level=6, index=True, index_ob=ob)
    assert blob == jimg.compress_bytes(level=6, index=True, index_ob=ob)
    # the single-image encoder indexes the Adam7 stream too (the batched
    # encoder does not)
    assert b"spIx" in blob
    _same_decode(blob)


def _metadata(P, M, seed=0):
    """Every chunk model, built from one of the two packages' modules."""
    return M(
        time=P.TimeModified(2024, 2, 29, 23, 59, 60 - seed),
        chromaticity=P.Chromaticity((31270, 32900), (64000, 33000),
                                    (30000, 60000), (15000, 6000)),
        color_profile=P.ColorProfile("profile", bytes(range(100)) * 2),
        color_rendering=P.ColorRendering(seed % 4),
        gamma=P.Gamma(45455 + seed),
        histogram=P.Histogram([i * 3 + seed for i in range(16)]),
        physical_dimensions=P.PhysicalDimensions((2835, 3780), "meter"),
        significant_bits=P.SignificantBits("rgb", (5, 6, 5)),
        suggested_palettes=[
            P.SuggestedPalette("eight", 8, [((1, 2, 3, 4), 9),
                                            ((5, 6, 7, 8), 2)])],
        text=[P.Text(True, ("Title", "Titel"), "de", "über alles " * 9),
              P.Text(False, ("Author", ""), "", "someone")],
        application=[("prVt", bytes([seed, 1, 2]))])


def test_metadata_round_trip_matches_jax(native):
    px, fields = _case("indexed4", 13, 7, 11)
    jl, tl = _layouts("indexed4", fields, False)
    jimg = jpng.Image.pack(px, jl, _metadata(jparsing, jpng.Metadata))
    timg = tpng.Image.pack(px, tl, _metadata(tparsing, tpng.Metadata))
    blob = timg.compress_bytes(level=6)
    assert blob == jimg.compress_bytes(level=6)
    t = _same_decode(blob)
    assert t.metadata.gamma.value == 45455
    assert [x.keyword[0] for x in t.metadata.text] == ["Title", "Author"]


def test_pack_and_unpack_with_custom_indexer_and_deindexer(native_off):
    pal = _palette(16, 4)
    rng = np.random.default_rng(4)
    px = np.array(pal, np.uint8)[rng.integers(0, 16, (7, 13))]

    def indexer(palette):
        table = {tuple(e): i for i, e in enumerate(palette)}
        return lambda agg: np.array([15 - table[tuple(int(v) for v in a)]
                                     for a in agg], np.uint8)

    def deindexer(palette):
        return [(a, b, c, 255) for (a, b, c, _) in palette[::-1]]

    imgs = []
    for P, M in ((jpng, jmodels), (tpng, tmodels)):
        layout = P.Layout(P.Format("indexed4", pal))
        img = P.Image.pack(px, layout, indexer=indexer)
        imgs.append((img, img.unpack(M.RGBA.of8, deindexer=deindexer),
                     img.unpack(M.VA.of16, deindexer=lambda p: [
                         (e[1], e[3]) for e in p])))
    (j, ju, jva), (t, tu, tva) = imgs
    assert np.array_equal(t.storage, j.storage)
    assert np.array_equal(tu, ju) and np.array_equal(tva, jva)
    assert np.array_equal(tu[..., :3], px[..., :3])
    assert t.compress_bytes(level=6) == j.compress_bytes(level=6)


def test_pack_through_other_targets(native_off):
    rng = np.random.default_rng(9)
    v = rng.integers(0, 1 << 16, (7, 13)).astype(np.uint16)
    va = rng.integers(0, 256, (7, 13, 2)).astype(np.uint8)
    for kind in ("v16", "rgb8", "rgba16", "va8", "indexed8"):
        fields = dict(palette=tuple((i, i, i, 255) for i in range(256))
                      if kind == "indexed8" else ())
        jl, tl = _layouts(kind, fields, False)
        for pixels, jt, tt in ((v, jmodels.V.of16, tmodels.V.of16),
                               (va, jmodels.VA.of8, tmodels.VA.of8)):
            j = jpng.Image.pack(pixels, jl, target=jt)
            t = tpng.Image.pack(pixels, tl, target=tt)
            assert np.array_equal(t.storage, j.storage)


def test_file_source_and_destination(tmp_path, native_off):
    _, jimg, timg = _images("rgba8", 13, 7, 2, True)
    path = str(tmp_path / "t.png")
    dst = tpng.FileDestination(path)
    timg.compress(dst, level=6)
    dst.close()
    blob = open(path, "rb").read()
    assert blob == jimg.compress_bytes(level=6)
    src = tpng.FileSource(path)
    assert src.count == len(blob)
    got = tpng.Image.decompress(src)
    assert np.array_equal(got.storage, timg.storage)
    timg.compress_path(str(tmp_path / "u.png"), level=6)
    back = tpng.Image.decompress_path(str(tmp_path / "u.png"))
    assert np.array_equal(back.unpack_rgba8(), timg.unpack_rgba8())


def test_bind_storage_and_its_refusals():
    pal = _palette(4, 1)
    px = np.array(pal, np.uint8)[np.zeros((2, 3), int)]
    img = tpng.Image.pack(px, tpng.Layout(tpng.Format("indexed2", pal)))
    other = tuple(reversed(pal))
    bound = img.bind_storage(tpng.Layout(tpng.Format("indexed2", other)))
    assert bound.storage is img.storage
    with pytest.raises(ValueError, match="must match"):
        img.bind_storage(tpng.Layout(tpng.Format("indexed4", pal)))
    with pytest.raises(ValueError, match="palette counts"):
        img.bind_storage(tpng.Layout(tpng.Format("indexed2", pal[:3])))
