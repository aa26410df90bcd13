"""The port's colour targets (``swift_png_tpu_torch.models``) against the
JAX package's ``swift_png_tpu.models``: ``premultiply`` and ``straighten``
exhaustive over 8 bits and sampled over 16 bits; ``RGBA``, ``V`` and
``VA`` ``unpack`` and ``pack`` at 8 and 16 bits for every colour kind,
chroma keys and palettes included; ``premultiplied`` and ``straightened``.
Then the device twins in ``swift_png_tpu_torch.ops.convolve``
(``premultiply``, ``straighten``, ``samples_to_va``) against
``swift_png_tpu.ops.convolve`` on the CPU."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

from swift_png_tpu import models as jmodels
from swift_png_tpu.ops import convolve as jconvolve
from swift_png_tpu.png.format import Format as JFormat
from swift_png_tpu_torch import models as tmodels
from swift_png_tpu_torch.ops import convolve as tconvolve
from swift_png_tpu_torch.png import Format as TFormat

KINDS = ["v1", "v2", "v4", "v8", "v16", "va8", "va16", "rgb8", "rgb16",
         "rgba8", "rgba16", "indexed1", "indexed2", "indexed4", "indexed8",
         "bgr8", "bgra8"]
CHANNELS = {"v": 1, "va": 2, "rgb": 3, "bgr": 3, "rgba": 4, "bgra": 4,
            "indexed": 1}


def _depth(kind):
    return int("".join(c for c in kind if c.isdigit()))


def _channels(kind):
    return CHANNELS[kind.rstrip("0123456789")]


def _all_pairs(dtype):
    """Every (color, alpha) pair over 8 bits; 2^16 seeded pairs over 16
    bits, with the ends of the range."""
    if dtype == np.uint8:
        c, a = np.meshgrid(np.arange(256), np.arange(256))
        return c.ravel().astype(np.uint8), a.ravel().astype(np.uint8)
    rng = np.random.default_rng(16)
    c = rng.integers(0, 1 << 16, 1 << 16).astype(np.uint16)
    a = rng.integers(0, 1 << 16, 1 << 16).astype(np.uint16)
    c[:4], a[:4] = (0, 65535, 65535, 1), (0, 65535, 0, 1)
    return c, a


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_premultiply_and_straighten_match_jax(dtype):
    c, a = _all_pairs(dtype)
    for fn in ("premultiply", "straighten"):
        want = getattr(jmodels, fn)(c, a)
        got = getattr(tmodels, fn)(c, a)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn


def _format(P, kind, seed, key=False):
    rng = np.random.default_rng(seed)
    if kind.startswith("indexed"):
        n = 1 << _depth(kind)
        pal = tuple(tuple(int(x) for x in e)
                    for e in rng.integers(0, 256, (n, 4)))
        return P(kind, pal)
    if not key or kind.startswith(("va", "rgba", "bgra")):
        return P(kind)
    top = (1 << _depth(kind)) - 1
    if _channels(kind) == 1:
        return P(kind, (), None, int(rng.integers(0, top + 1)))
    return P(kind, (), None, tuple(int(x) for x in
                                   rng.integers(0, top + 1, 3)))


def _storage(kind, w, h, fmt, seed):
    """Storage bytes of a ``w × h`` image of ``kind`` (one sample a byte
    for sub-byte kinds, big-endian pairs for 16 bits); some pixels carry
    the chroma key."""
    rng = np.random.default_rng(seed)
    depth, ch = _depth(kind), _channels(kind)
    n = w * h
    if kind.startswith("indexed"):
        return rng.integers(0, len(fmt.palette), n).astype(np.uint8)
    s = rng.integers(0, 1 << depth, (n, ch))
    if fmt.key is not None:
        s[::3] = fmt.key
    if depth == 16:
        out = np.empty(n * ch * 2, np.uint8)
        out[0::2], out[1::2] = s.ravel() >> 8, s.ravel() & 0xFF
        return out
    return s.ravel().astype(np.uint8)


def _targets(m):
    return {"RGBA8": m.RGBA.of8, "RGBA16": m.RGBA.of16, "V8": m.V.of8,
            "V16": m.V.of16, "VA8": m.VA.of8, "VA16": m.VA.of16}


@pytest.mark.parametrize("key", [False, True], ids=["plain", "key"])
@pytest.mark.parametrize("kind", KINDS)
def test_unpack_every_target_matches_jax(kind, key):
    jf = _format(JFormat, kind, 3, key)
    tf = _format(TFormat, kind, 3, key)
    storage = _storage(kind, 9, 5, tf, 4)
    for name, jt in _targets(jmodels).items():
        tt = _targets(tmodels)[name]
        want = jt.unpack(storage.copy(), jf, (9, 5))
        got = tt.unpack(storage.copy(), tf, (9, 5))
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("kind", KINDS)
def test_pack_every_target_matches_jax(kind):
    jf = _format(JFormat, kind, 5)
    tf = _format(TFormat, kind, 5)
    rng = np.random.default_rng(6)
    for name, jt in _targets(jmodels).items():
        tt = _targets(tmodels)[name]
        ch = {"RGBA": 4, "VA": 2, "V": 1}[name.rstrip("0123456789")]
        top = (1 << int(name[-2:] if name.endswith("16") else 8)) - 1
        dtype = np.uint16 if top > 255 else np.uint8
        if kind.startswith("indexed") and name.startswith("RGBA"):
            # half exact palette entries, half misses (index 0)
            pal = np.array(tf.palette, dtype) * (top // 255)
            px = pal[rng.integers(0, len(pal), 45)]
            px[::2] = rng.integers(0, top + 1, (23, 4))
        else:
            px = rng.integers(0, top + 1, (45, ch)).astype(dtype)
        want = jt.pack(px.copy(), jf)
        got = tt.pack(px.copy(), tf)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("bits", [8, 16])
def test_premultiplied_and_straightened_match_jax(bits):
    dtype = np.uint8 if bits == 8 else np.uint16
    rng = np.random.default_rng(bits)
    px = rng.integers(0, 1 << bits, (7, 9, 4)).astype(dtype)
    jt = jmodels.RGBA.of8 if bits == 8 else jmodels.RGBA.of16
    tt = tmodels.RGBA.of8 if bits == 8 else tmodels.RGBA.of16
    for as_bits in (None, 8):
        assert np.array_equal(tt.premultiplied(px, as_bits),
                              jt.premultiplied(px, as_bits))
    assert np.array_equal(tt.straightened(px), jt.straightened(px))


# ---- the device twins (ops/convolve.py), on the CPU ------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_device_premultiply_straighten_match_jax(dtype):
    c, a = _all_pairs(dtype)
    c, a = c.reshape(-1, 4, 4), a.reshape(-1, 4, 4)
    tc, ta = torch.from_numpy(c.astype(np.int64)), torch.from_numpy(
        a.astype(np.int64))
    tdt = torch.uint8 if dtype == np.uint8 else torch.uint16
    for fn in ("premultiply", "straighten"):
        want = np.asarray(getattr(jconvolve, fn)(c, a))
        got = getattr(tconvolve, fn)(tc.to(tdt), ta.to(tdt))
        assert got.dtype == tdt
        assert np.array_equal(got.to(torch.int64).numpy(), want), fn


def _va_case(depth, channels, seed, key, indexed):
    rng = np.random.default_rng(seed)
    W, H = 7, 5
    top = (1 << depth) - 1
    pal = rng.integers(0, 256, (2, 1 << min(depth, 8), 4)).astype(np.int32)
    raw = rng.integers(0, top + 1, (2, H, W, channels)).astype(np.int32)
    if indexed:
        raw = rng.integers(0, pal.shape[1], (2, H, W, 1)).astype(np.int32)
    keys = rng.integers(0, top + 1, (2, channels)).astype(np.int32)
    if key:
        raw[:, ::2, ::3] = keys[:, None, None, :]
    return raw, pal, keys


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize(
    "kind,depth,channels,has_key",
    [("v8", 8, 1, False), ("va8", 8, 2, False), ("rgb8", 8, 3, False),
     ("rgba16", 16, 4, False), ("bgra8", 8, 4, False), ("v2", 2, 1, False),
     ("v16", 16, 1, False), ("bgr8", 8, 3, False), ("rgb16", 16, 3, False),
     ("va16", 16, 2, False), ("indexed4", 4, 1, False),
     ("indexed8", 8, 1, False), ("v8", 8, 1, True), ("v2", 2, 1, True),
     ("v16", 16, 1, True), ("rgb8", 8, 3, True), ("rgb16", 16, 3, True),
     ("bgr8", 8, 3, True)],
    ids=lambda v: {True: "key", False: "plain"}.get(v) if isinstance(
        v, bool) else None)
def test_device_samples_to_va_matches_jax(kind, depth, channels, has_key,
                                          bits):
    indexed = kind.startswith("indexed")
    raw, pal, keys = _va_case(depth, channels, bits + depth, has_key,
                              indexed)
    is_bgr = kind.startswith("bgr")
    got = tconvolve.samples_to_va(
        torch.from_numpy(raw), depth=depth, channels=channels, is_bgr=is_bgr,
        is_indexed=indexed, has_key=has_key,
        palette=torch.from_numpy(pal) if indexed else None,
        key=torch.from_numpy(keys) if has_key else None, bits=bits)
    assert got.dtype == (torch.uint8 if bits == 8 else torch.uint16)
    for b in range(2):
        want = np.asarray(jconvolve.samples_to_va(
            raw[b], depth=depth, channels=channels, is_bgr=is_bgr,
            is_indexed=indexed, has_key=has_key,
            palette=pal[b] if indexed else None,
            key=keys[b] if has_key else None, bits=bits))
        assert np.array_equal(got[b].to(torch.int64).numpy(), want)
