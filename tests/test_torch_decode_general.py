"""The port's general batch decode, ``BatchCodec(device="cpu").decode`` and
``decode_filtered``, against the JAX package's ``BatchCodec().decode`` on
the same PNG bytes: exact pixel equality for every standard kind at
``bits`` 8 and 16, non-interlaced and Adam7 at odd sizes (some passes
empty), chroma keys, per-image palettes, iOS (CgBI) files and multi-IDAT
files written with stdlib ``zlib``; with the fused inflate and with the
host inflator.

The inputs are made here, with the JAX package's PNG writer or with
``chip_smoke.py``'s PNG writers and stdlib ``zlib``.  The JAX side decodes
with its host inflator (its fused inflate would compile one program per
stream size; ``tests/test_torch_inflate_fused.py`` holds the two fused
engines against each other) and runs once per case in a module fixture.
The port's CPU engine starts at a small window and rank budget here; it
grows them as the default engine would, and two cases run the default.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import conftest  # noqa: F401

from swift_png_tpu import png
from swift_png_tpu.parallel.batch import BatchCodec as JaxBatchCodec
from swift_png_tpu.png.format import Format, Layout
from swift_png_tpu_torch import BatchCodec
from swift_png_tpu_torch._host.png import parsing
from swift_png_tpu_torch._host.png.format import IOS
from swift_png_tpu_torch.ops.inflate_fused import InflateFused
from swift_png_tpu_torch.parallel import batch as port_batch

SIZES = [(1, 1), (3, 5), (9, 17), (33, 31)]   # (W, H)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _small_engine(request):
    """One torch thread; the CPU fused engine at a 4 KB window and 1,024
    ranks (``test_default_engine`` keeps the default)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = dict(port_batch._FUSED)
    if request.function.__name__ != "test_default_engine":
        port_batch._FUSED[CPU] = InflateFused(win_bytes=1 << 12,
                                              t_max=1 << 10, device=CPU)
    yield
    port_batch._FUSED.clear()
    port_batch._FUSED.update(saved)
    torch.set_num_threads(n)


def _palette(rng, n):
    alphas = [0, 64, 128] + [255] * (n - 3) if n >= 4 else [255] * n
    rgb = rng.integers(0, 256, (n, 3))
    return tuple((int(r), int(g), int(b), int(a))
                 for (r, g, b), a in zip(rgb, alphas))


def _image(kind, size, seed):
    """``(pixels, Format)`` of one test image: RGBA pixels the format holds
    exactly (uint16 for 16-bit kinds)."""
    W, H = size
    rng = np.random.default_rng(seed)
    key = None
    if kind.startswith("indexed"):
        n = {"indexed1": 2, "indexed2": 4, "indexed4": 16,
             "indexed8": 40}[kind]
        pal = _palette(rng, n)
        idx = rng.integers(0, n, H * W)
        px = np.array([pal[i] for i in idx], np.uint8).reshape(H, W, 4)
        return px, Format(kind, pal)
    base = kind.split("_")[0]
    top = 65535 if base.endswith("16") else 255
    dtype = np.uint16 if top == 65535 else np.uint8
    px = rng.integers(0, top + 1, (H, W, 4)).astype(dtype)
    depth = {"v1": 1, "v2": 2, "v4": 4, "v8": 8, "v16": 16}.get(base)
    if depth is not None:
        # gray samples the depth holds exactly
        v = rng.integers(0, 1 << depth, (H, W)) * (top // ((1 << depth) - 1))
        px = np.stack([v, v, v, np.full_like(v, top)], -1).astype(dtype)
    elif base in ("va8", "va16"):
        px[..., 1] = px[..., 2] = px[..., 0]
    elif base in ("rgb8", "rgb16", "bgr8"):
        px[..., 3] = top
    if kind.endswith("_key") and seed % 2 == 0:
        # the keyed color occurs; odd images carry no key (−1 in the batch)
        px[::2, ::3, :3] = px[0, 0, :3]
        key = int(px[0, 0, 0]) if base.startswith("v") else tuple(
            int(c) for c in px[0, 0, :3])
    return px, Format(base, (), key=key)


KINDS = ["v1", "v2", "v4", "v8", "v16", "va8", "va16", "rgb8", "rgb16",
         "rgba8", "rgba16", "indexed1", "indexed2", "indexed4", "indexed8",
         "v8_key", "rgb8_key", "rgb16_key", "bgr8", "bgra8"]
CASES = [(kind, inter, bits) for kind in KINDS
         for inter in (False, True) for bits in (8, 16)]


# kinds of one depth and channel count share their sizes, so that the JAX
# side compiles one program for them
_LAYOUT = {"v1": 0, "indexed1": 0, "v2": 1, "indexed2": 1, "v4": 2,
           "indexed4": 2, "v8": 3, "indexed8": 3, "v8_key": 3, "v16": 4,
           "va8": 5, "va16": 6, "rgb8": 7, "rgb8_key": 7, "bgr8": 7,
           "rgb16": 8, "rgb16_key": 8, "rgba8": 9, "bgra8": 9, "rgba16": 10}


def _size(kind, inter):
    """Plain images take the four sizes in turn.  Adam7 ones take 33×31
    (rgba8, bgra8) and 9×17 (rgb8, bgr8), where the JAX side compiles for
    seconds, and 1×1 or 3×5 otherwise."""
    c = _LAYOUT[kind]
    if not inter:
        return SIZES[c % len(SIZES)]
    return {9: (33, 31), 7: (9, 17)}.get(c, SIZES[c % 2])


def _pngs(kind, inter, n=2):
    out = []
    for seed in range(n):
        px, fmt = _image(kind, _size(kind, inter), seed)
        out.append(png.Image.pack(px, Layout(fmt, inter)).compress_bytes(
            level=6))
    return out


PNGS = {(kind, inter): _pngs(kind, inter) for kind in KINDS
        for inter in (False, True)}


@pytest.fixture(scope="module")
def jax_decoded():
    codec = JaxBatchCodec()
    return {case: np.asarray(codec.decode(PNGS[case[:2]], bits=case[2],
                                          device_inflate=False))
            for case in CASES}


def _ids(cases):
    return [f"{k}-{'adam7' if i else 'plain'}-{b}" for k, i, b in cases]


@pytest.mark.parametrize("kind,inter,bits", CASES, ids=_ids(CASES))
def test_decode_matches_jax(kind, inter, bits, jax_decoded):
    want = jax_decoded[(kind, inter, bits)]
    codec = BatchCodec(device="cpu")
    got = codec.decode(PNGS[(kind, inter)], bits=bits)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    host = codec.decode(PNGS[(kind, inter)], bits=bits,
                        device_inflate=False)
    assert np.array_equal(host, want)
    if bits == 8:   # and both hold the source pixels
        for b in range(2):
            src = png.Image.decompress_bytes(PNGS[(kind, inter)][b])
            assert np.array_equal(got[b], src.unpack_rgba8())


BUILT = [(config, hint) for config in chip_smoke.GD_CONFIGS
         for hint in (7, 1 << 15)]


@pytest.mark.parametrize("config,hint", BUILT,
                         ids=[f"{c}-idat{h}" for c, h in BUILT])
def test_zlib_built_pngs_match_jax_and_source(config, hint):
    """``chip_smoke.py``'s ``general_png`` (stdlib zlib; Adam7 passes, CgBI,
    many IDAT chunks): the port, the JAX package and the source pixels
    agree."""
    rng = np.random.default_rng(7)
    px = rng.integers(0, 256, (2, 17, 9, 4), dtype=np.uint8)
    pngs = [chip_smoke.general_png(p, config, hint) for p in px]
    got = BatchCodec(device="cpu").decode(pngs)
    assert np.array_equal(got, px)
    want = np.asarray(JaxBatchCodec().decode(pngs, device_inflate=False))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind,inter", [("rgba8", True), ("bgra8", False)])
def test_default_engine(kind, inter, jax_decoded):
    """The default 128 KB window and 32,768 ranks on the CPU."""
    got = BatchCodec(device="cpu").decode(PNGS[(kind, inter)])
    assert np.array_equal(got, jax_decoded[(kind, inter, 8)])


@pytest.mark.parametrize("inter", [False, True])
def test_decode_filtered_matches_jax(inter):
    pngs = PNGS[("rgb16", inter)]
    want, winfo = JaxBatchCodec().decode_filtered(pngs, device_inflate=False)
    for device_inflate in (True, False):
        got, info = BatchCodec(device="cpu").decode_filtered(
            pngs, device_inflate=device_inflate)
        assert isinstance(got, np.ndarray)
        assert np.array_equal(got, np.asarray(want))
        assert (info["size"], info["pixel"].name, info["standard"],
                info["interlaced"]) == (winfo["size"], winfo["pixel"].name,
                                        winfo["standard"],
                                        winfo["interlaced"])


@pytest.mark.parametrize("device_inflate", [True, False])
def test_keep_on_device(device_inflate, jax_decoded):
    codec = BatchCodec(device="cpu")
    pngs = PNGS[("bgra8", True)]
    flat, info = codec.decode_filtered(pngs, device_inflate,
                                       keep_on_device=True)
    assert isinstance(flat, torch.Tensor) and flat.device == CPU
    assert info["standard"] == IOS and info["interlaced"]
    got = codec.decode(pngs, bits=16, device_inflate=device_inflate,
                       keep_on_device=True)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint16
    assert np.array_equal(got.numpy(), jax_decoded[("bgra8", True, 16)])


def test_mixed_shapes_raise():
    pngs = [PNGS[("rgba8", False)][0], PNGS[("rgba8", True)][0]]
    with pytest.raises(ValueError):
        JaxBatchCodec().decode(pngs, device_inflate=False)
    with pytest.raises(ValueError):
        BatchCodec(device="cpu").decode(pngs)
    pngs = [PNGS[("rgba8", False)][0], PNGS[("rgb8", False)][0]]
    with pytest.raises(ValueError):
        BatchCodec(device="cpu").decode(pngs, device_inflate=False)


def test_ios_header_allows_only_rgb8_and_rgba8():
    from swift_png_tpu.png import parsing as jax_parsing
    from swift_png_tpu_torch._host.png.errors import ParsingError

    for code, ok in (((8, 2), True), ((8, 6), True), ((16, 6), False),
                     ((8, 0), False), ((8, 3), False)):
        data = (b"\x00\x00\x00\x04\x00\x00\x00\x03" + bytes(code)
                + b"\x00\x00\x00")
        want = jax_parsing.Header.parse(data, "ios") if ok else None
        if ok:
            got = parsing.Header.parse(data, IOS)
            assert (got.size, got.pixel.name) == (want.size, want.pixel.name)
            continue
        with pytest.raises(ParsingError) as e:
            parsing.Header.parse(data, IOS)
        assert e.value.case == "invalidHeaderPixelFormat"
        with pytest.raises(Exception) as je:
            jax_parsing.Header.parse(data, "ios")
        assert je.value.case == e.value.case
        assert parsing.Header.parse(data).pixel.code == code   # common
