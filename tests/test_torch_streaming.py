"""The port's streaming decode (``swift_png_tpu_torch.png.Context``)
against the JAX package's ``Context`` on the same files: IDAT data fed in
pieces of 1, 7 and 4,096 bytes, with and without ``overdraw``, reaches the
same storage after every piece as the JAX context does, and the same image
as one push and as ``Image.decompress_bytes``.  Malformed files built here
raise the same error class, ``case`` and details from both packages, in
``Image.decompress_bytes`` and, for the image-data errors, at the same
piece of a stream."""

import zlib

import numpy as np
import pytest

import conftest  # noqa: F401

import swift_png_tpu.native as jax_native
import swift_png_tpu_torch._host.native as torch_native
from swift_png_tpu import png as jpng
from swift_png_tpu.png import parsing as jparsing
from swift_png_tpu_torch import png as tpng
from swift_png_tpu_torch.png import parsing as tparsing

SIG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(autouse=True, params=["off", "on"])
def native(request, monkeypatch):
    """Both packages' native libraries on or off together."""
    if request.param == "off":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(torch_native, "available", lambda: False)
    return request.param


def _chunk(kind: str, data: bytes = b"") -> bytes:
    name = kind.encode()
    return (len(data).to_bytes(4, "big") + name + data
            + zlib.crc32(name + data).to_bytes(4, "big"))


def _ihdr(w, h, depth=8, color=6, interlace=0):
    return _chunk("IHDR", w.to_bytes(4, "big") + h.to_bytes(4, "big")
                  + bytes([depth, color, 0, 0, interlace]))


def _lex(blob):
    src = tpng.ByteSource(blob)
    src.signature()
    out = []
    while not out or out[-1][0] != "IEND":
        out.append(src.chunk())
    return out


def _file(kind, interlaced, seed):
    """A 32×32 PNG of ``kind`` in IDAT chunks of 100 bytes, with tIME,
    tEXt and an application chunk after the IDAT run."""
    rng = np.random.default_rng(seed)
    if kind == "indexed4":
        pal = tuple((i * 16, 255 - i * 16, i * 7, 255 if i > 2 else i * 60)
                    for i in range(16))
        px = np.array(pal, np.uint8)[rng.integers(0, 16, (32, 32))]
        fmt = tpng.Format(kind, pal)
    elif kind == "rgba16":
        px = rng.integers(0, 1 << 16, (32, 32, 4)).astype(np.uint16)
        fmt = tpng.Format(kind)
    else:
        px = rng.integers(0, 256, (32, 32, 4)).astype(np.uint8)
        px[..., 3] = 255
        fmt = tpng.Format(kind)
    blob = tpng.Image.pack(px, tpng.Layout(fmt, interlaced)).compress_bytes(
        level=6, hint=100)
    chunks = _lex(blob)
    tail = [("tIME", bytes([7, 232, 2, 29, 23, 59, 59])),
            ("tEXt", b"Comment\x00streamed"), ("prVt", b"\x01\x02")]
    return chunks[:-1] + tail + chunks[-1:]


def _context(P, parsing, chunks):
    header = palette = None
    state = {"background": None, "transparency": None}
    metadata = P.Metadata()
    for t, payload in chunks:
        if t == "IHDR":
            header = parsing.Header.parse(payload, P.COMMON)
        elif t == "PLTE":
            palette = parsing.Palette.parse(payload, header.pixel)
        elif t == "IDAT":
            break
        else:
            metadata.push_ancillary(t, payload, header.pixel, palette, state)
    return P.Context(P.COMMON, header, palette, state["background"],
                     state["transparency"], metadata)


def _stream(chunks, piece, overdraw):
    """Feed both contexts the IDAT bytes in ``piece``-byte pieces; the two
    storages must agree after every piece.  Returns the port's context."""
    j = _context(jpng, jparsing, chunks)
    t = _context(tpng, tparsing, chunks)
    data = b"".join(p for k, p in chunks if k == "IDAT")
    for at in range(0, len(data), piece):
        j.push_data(data[at:at + piece], overdraw=overdraw)
        t.push_data(data[at:at + piece], overdraw=overdraw)
        assert np.array_equal(t.image.storage, j.image.storage), at
        assert t.decoder.continue_ == j.decoder.continue_
    after = [c for c in chunks[chunks.index(next(c for c in chunks
                                                 if c[0] == "IDAT")):]
             if c[0] != "IDAT"]
    for k, p in after:
        j.push_ancillary(k, p)
        t.push_ancillary(k, p)
    assert repr(t.image.metadata) == repr(j.image.metadata)
    return t


@pytest.mark.parametrize("overdraw", [False, True], ids=["plain", "overdraw"])
@pytest.mark.parametrize("piece", [1, 7, 4096])
@pytest.mark.parametrize("kind,interlaced", [("rgba8", True),
                                             ("indexed4", False),
                                             ("rgba16", True),
                                             ("rgb8", False)])
def test_context_in_pieces_matches_jax_and_one_push(kind, interlaced, piece,
                                                    overdraw):
    chunks = _file(kind, interlaced, piece)
    t = _stream(chunks, piece, overdraw)
    blob = SIG + b"".join(_chunk(k, p) for k, p in chunks)
    whole = tpng.Image.decompress_bytes(blob)
    assert np.array_equal(t.image.storage, whole.storage)
    assert repr(t.image.metadata) == repr(whole.metadata)
    assert [x.content for x in whole.metadata.text] == ["streamed"]
    assert whole.metadata.application == [("prVt", b"\x01\x02")]


def test_overdraw_fills_adam7_blocks_before_the_last_pass():
    chunks = _file("rgba8", True, 1)
    t = _context(tpng, tparsing, chunks)
    data = b"".join(p for k, p in chunks if k == "IDAT")
    t.push_data(data[:48], overdraw=True)
    px = t.image.unpack_rgba8()
    assert (px[0:8, 0:8] == px[0, 0]).all()
    assert (px[0:8, 8:16] == px[0, 8]).all()


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return (type(e).__name__, getattr(e, "case", None),
                getattr(e, "details", None), str(e))
    return None


def _rgb_idat(w=4, h=3, extra=b""):
    raw = b"".join(b"\x00" + bytes(range(3 * w)) for _ in range(h)) + extra
    return _chunk("IDAT", zlib.compress(raw))


def _indexed_idat():
    return _chunk("IDAT", zlib.compress(b"\x00\x01\x23" * 2))


_PLTE = _chunk("PLTE", bytes(range(12)))


def _malformed():
    ihdr = _ihdr(4, 3, 8, 2)
    idat = _rgb_idat()
    full = zlib.compress(b"".join(b"\x00" + bytes(12) for _ in range(3)))
    return {
        "duplicate_ihdr": ihdr + ihdr + idat,
        "plte_after_bkgd": ihdr + _chunk("bKGD", bytes(6)) + _PLTE + idat,
        "plte_after_trns": ihdr + _chunk("tRNS", bytes(6)) + _PLTE + idat,
        "duplicate_plte": ihdr + _PLTE + _PLTE + idat,
        "duplicate_bkgd": ihdr + _chunk("bKGD", bytes(6)) * 2 + idat,
        "duplicate_trns": ihdr + _chunk("tRNS", bytes(6)) * 2 + idat,
        "duplicate_gama": ihdr + _chunk("gAMA", bytes(4)) * 2 + idat,
        "gama_after_plte": ihdr + _PLTE + _chunk("gAMA", bytes(4)) + idat,
        "hist_without_plte": ihdr + _chunk("hIST", bytes(8)) + idat,
        "iend_before_idat": ihdr,
        "missing_plte": _ihdr(4, 3, 4, 3) + _indexed_idat(),
        "no_ihdr": _chunk("gAMA", bytes(4)) + ihdr + idat,
        "truncated_idat": ihdr + _chunk("IDAT", full[: len(full) // 2]),
        "extra_image_data": ihdr + _rgb_idat(extra=b"\x00" * 5),
        "extra_compressed_data": ihdr + idat + _chunk("IDAT", b"\x00\x00"),
        "plte_after_idat": ihdr + idat + _PLTE,
        "duplicate_time": ihdr + idat + _chunk("tIME", bytes([7, 232, 1, 1,
                                                              0, 0, 0])) * 2,
        "bad_checksum": ihdr + _chunk("IDAT", full[:-1] + bytes(
            [full[-1] ^ 1])),
    }


@pytest.mark.parametrize("name", sorted(_malformed()))
def test_malformed_files_raise_as_jax(name):
    blob = SIG + _malformed()[name] + _chunk("IEND")
    want = _raised(lambda: jpng.Image.decompress_bytes(blob))
    assert want is not None
    assert _raised(lambda: tpng.Image.decompress_bytes(blob)) == want


@pytest.mark.parametrize("piece", [1, 7, 4096])
@pytest.mark.parametrize("name", ["truncated_idat", "extra_image_data",
                                  "extra_compressed_data", "bad_checksum"])
def test_image_data_errors_raise_at_the_same_piece(name, piece):
    chunks = _lex(SIG + _malformed()[name] + _chunk("IEND"))
    outcomes = []
    for P, parsing in ((jpng, jparsing), (tpng, tparsing)):
        ctx = _context(P, parsing, chunks)
        steps = []
        for k, p in chunks[1:]:
            if k == "IDAT":
                for at in range(0, len(p), piece):
                    steps.append(lambda d=p[at:at + piece]:
                                 ctx.push_data(d))
            else:
                steps.append(lambda k=k, p=p: ctx.push_ancillary(k, p))
        for i, step in enumerate(steps):
            err = _raised(step)
            if err is not None:
                outcomes.append((i, err))
                break
        else:
            outcomes.append(None)
    assert outcomes[0] is not None
    assert outcomes[1] == outcomes[0]


def test_critical_chunk_among_the_ancillary_ones_is_refused():
    """A CgBI chunk after IHDR reaches ``push_ancillary``: the port raises
    ``ValueError`` there (the JAX package trips an ``assert``)."""
    blob = SIG + _ihdr(4, 3, 8, 2) + _chunk("CgBI", bytes([48, 0, 32, 6]))
    with pytest.raises(ValueError, match="not an ancillary chunk"):
        tpng.Image.decompress_bytes(blob + _rgb_idat() + _chunk("IEND"))
