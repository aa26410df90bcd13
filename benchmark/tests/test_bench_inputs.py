"""The recipes and files are fixed by the seed, and the files are what
their configuration's writer says."""

import json
import zlib

import numpy as np
import pytest

from conftest import ROOT
from harness import corpus, reference

SEEDS = [0, 7, 2**31 + 5, 2**40 + 3]
CONFIGS = [c["name"]
           for c in json.load(open(ROOT / "BENCHMARK.json"))["configs"]]


def files_of(spec, config, seed, b=3, h=10, w=14):
    cfg = spec.config(config)
    px = corpus.make_images(spec.content(cfg["content"]), seed, b, h, w)
    return px, corpus.make_files(px, cfg["writer"])


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(spec, config, seed):
    a = files_of(spec, config, seed)
    b = files_of(spec, config, seed)
    assert np.array_equal(a[0], b[0])
    assert a[1] == b[1]


@pytest.mark.parametrize("config", CONFIGS)
def test_images_distinct_within_and_across_seeds(spec, config):
    px, _ = files_of(spec, config, 2**31 + 1, b=8)
    assert len({p.tobytes() for p in px}) == 8
    other, _ = files_of(spec, config, 2**31 + 2, b=8)
    assert not np.array_equal(px, other)


@pytest.mark.parametrize("config", CONFIGS)
def test_files_read_back_to_the_pixels(spec, config):
    px, files = files_of(spec, config, 12345)
    for p, f in zip(px, files):
        parts = reference.chunks(f)
        assert [k for k, _ in parts][0] == b"IHDR"
        assert parts[-1][0] == b"IEND"
        idat = [body for k, body in parts if k == b"IDAT"]
        assert all(len(body) <= 8192 for body in idat)
        raw = zlib.decompress(b"".join(idat))
        rows = np.frombuffer(raw, np.uint8).reshape(p.shape[0], -1)
        got = reference.unfilter(rows, 4).reshape(p.shape)
        assert np.array_equal(got, p)


def test_writer_settings_are_libpngs(spec):
    for name in CONFIGS:
        w = spec.config(name)["writer"]
        assert (w["zlib_level"], w["zlib_strategy"], w["filter"],
                w["idat_bytes"]) == (6, "filtered", "minsum", 8192)


def test_minsum_picks_the_least_signed_sum():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (9, 24), dtype=np.uint8)
    out = corpus.filter_minsum(rows, 4)
    cands = corpus.filter_candidates(rows, 4)
    for y in range(9):
        sums = [np.abs(c[y].view(np.int8).astype(int)).sum() for c in cands]
        assert out[y, 0] == int(np.argmin(sums))
        assert np.array_equal(out[y, 1:], cands[out[y, 0], y])


def test_photo_file_size_near_the_issue(spec):
    px, files = files_of(spec, "photo512_rgba8", 99, b=1, h=128, w=128)
    ratio = len(files[0]) / px[0].size
    assert 0.6 < ratio < 0.8
