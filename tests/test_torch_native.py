"""The port's native host library against the JAX package's, with both
libraries on: the checkpoint-index walk (``build_index``), the decode host
tier of ``CheckpointInflator.run`` (``host`` and ``mixed`` plans beside the
device plans), the encoder's sampled statistics and strict size policy
(``deflate_device_optimal_batch``) and ``BatchCodec.encode``'s native
routes.  The two libraries are built from the same C++ sources into two
files and load side by side in one process.  Everything compares exactly.
All data comes from seeds."""

import ctypes
import zlib

import numpy as np
import pytest

import conftest  # noqa: F401

import chip_smoke
import swift_png_tpu.native as jax_native
import swift_png_tpu.ops.deflate_optimal as jdo
import swift_png_tpu.ops.inflate_checkpoint as jic
import swift_png_tpu.ops.inflate_seqcopy as jsq
from swift_png_tpu.lz77 import index as jindex
from swift_png_tpu.lz77.errors import LZ77Error as JaxLZ77Error
from swift_png_tpu.parallel.batch import BatchCodec as JaxBatchCodec
from swift_png_tpu_torch import BatchCodec
from swift_png_tpu_torch._host import native as torch_native
from swift_png_tpu_torch._host.lz77 import index as tindex
from swift_png_tpu_torch._host.lz77.errors import LZ77Error
from swift_png_tpu_torch.ops import deflate_optimal as tdo
import swift_png_tpu_torch.ops.inflate_checkpoint as tic
import swift_png_tpu_torch.ops.inflate_seqcopy as tsq
from test_index_widening import _stored_chain_stream
from test_torch_encode import payload
from test_torch_host import _streams as host_streams
from test_torch_host import assert_same_index

OB = 256
SIDE = 64            # host-tier test streams hold SIDE × SIDE rgba8 rows


@pytest.fixture(autouse=True)
def _both_native():
    if not (jax_native.available() and torch_native.available()):
        pytest.fail(f"a native library did not load: "
                    f"{torch_native.last_error()}")


def test_both_libraries_load_each_from_its_own_path():
    assert torch_native._lib._name == torch_native._LIB_PATH
    assert jax_native._lib._name == jax_native._LIB_PATH
    assert torch_native._LIB_PATH != jax_native._LIB_PATH
    # RTLD_LOCAL: each handle resolves the symbols of its own file
    addr = lambda lib: ctypes.cast(lib.spt_adler32, ctypes.c_void_p).value
    assert addr(torch_native._lib) != addr(jax_native._lib)
    with open("/proc/self/maps") as maps:
        mapped = maps.read()
    assert torch_native._LIB_PATH in mapped and jax_native._LIB_PATH in mapped
    data = bytes(range(256)) * 40
    assert torch_native.adler32(data) == jax_native.adler32(data) \
        == zlib.adler32(data)


# ---- build_index ------------------------------------------------------------

def _text_payload(n=40000, seed=6):
    """Compressible text of seeded words (the shape of the README payload
    of ``tests/test_index_widening.py``'s empty-dynamic recipe)."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
             for k in rng.integers(2, 9, 300)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 300, n // 3))
    return (text * 2)[:n]


def _empty_dyn_stream(n=40000, chunk=2000):
    pay = _text_payload(n)
    co = zlib.compressobj(6)
    out = b""
    for i in range(0, n, chunk):
        out += co.compress(pay[i:i + chunk])
        out += co.flush(zlib.Z_FULL_FLUSH)
    out += co.flush()
    return pay, out


def _index_cases():
    cases = [(name, data, stream) for name, data, stream in host_streams()]
    for markers in (1, 2, 3):
        cases.append((f"stored_chain{markers}",
                      *_stored_chain_stream(markers=markers)))
    for chunk in (100, 200):
        cases.append((f"stored_chain_multigap{chunk}",
                      *_stored_chain_stream(n=20000, chunk=chunk)))
    cases.append(("empty_dynamic", *_empty_dyn_stream()))
    return cases


@pytest.mark.parametrize("name,data,stream", _index_cases(),
                         ids=[c[0] for c in _index_cases()])
def test_build_index_matches_jax_with_both_libraries(name, data, stream):
    body = stream[2:-4]
    want = jindex.build_index(body, len(data), OB)
    got = tindex.build_index(body, len(data), OB)
    assert want is not None and got is not None
    assert_same_index(got, want)
    assert got.serialize() == want.serialize()
    raw = torch_native.build_index(body, len(data), OB)
    if name.startswith("stored_chain_multigap"):
        # two gaps in a unit: the native walk hands the stream back to the
        # Python walk, which records the extra gaps
        assert raw == "host-retry" and got.extra_gaps
    else:
        assert isinstance(raw, tuple)
    assert got.serialize() == tindex._build_index_host(
        body, len(data), OB).serialize()


def _malformed(kind):
    data = _text_payload(20000, seed=7)
    body = bytearray(zlib.compress(data, 6)[2:-4])
    if kind == "block_type":
        body[0] |= 0b110                 # BTYPE 3
    elif kind == "truncated":
        body = body[: len(body) // 2]
    else:                                # code-length code lengths all 7
        body[1] = 0xFF
        body[2] = 0xFF
    return bytes(body), len(data)


@pytest.mark.parametrize("kind", ["block_type", "truncated", "code_lengths"])
def test_build_index_malformed_raises_like_jax(kind):
    body, n = _malformed(kind)
    with pytest.raises(JaxLZ77Error) as jerr:
        jindex.build_index(body, n, OB)
    with pytest.raises(LZ77Error) as terr:
        tindex.build_index(body, n, OB)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert terr.value.case == jerr.value.case


# ---- the decode host tier ---------------------------------------------------

def _tier_batch(kind):
    """``(rows, zlib streams)`` of four SIDE × SIDE streams: ``mixed``
    (``chip_smoke``'s host-tier recipe), ``host`` (its noisy streams
    alone), ``records`` (minimum-sum smooth rows) or ``sweeps`` (smooth
    rows filtered ``y % 5``)."""
    rows, streams, noisy, nstreams = chip_smoke.host_tier_inputs(4, SIDE,
                                                                 SIDE)
    if kind == "mixed":
        return rows, streams
    if kind == "host":
        return noisy, nstreams
    filt = chip_smoke.filter_minsum if kind == "records" else \
        chip_smoke.filter_rows
    rows = [filt(chip_smoke.smooth_image(i, SIDE, SIDE).reshape(
        SIDE, 4 * SIDE), 4).tobytes() for i in range(4)]
    return rows, [zlib.compress(r, 6) for r in rows]


@pytest.mark.parametrize("kind,tier", [("host", "host"), ("mixed", "mixed"),
                                       ("sweeps", "device"),
                                       ("records", "device")])
def test_run_tiers_match_jax_with_both_libraries(kind, tier, monkeypatch):
    # a records cap that the SIDE-sized noisy streams overflow (4 × ~520
    # estimated runs) and the records streams do not (4 × ~100)
    for mod in (jsq, tsq):
        monkeypatch.setattr(mod, "RECORDS_SMEM_CAP", 1024)
    rows, streams = _tier_batch(kind)
    n = len(rows[0])
    bodies = [s[2:-4] for s in streams]
    jeng = jic.CheckpointInflator(ob=OB, backend="xla")
    jout, jadler = jeng.run(bodies, [jindex.build_index(b, n, OB)
                                     for b in bodies], keep_on_device=False)
    teng = tic.CheckpointInflator("cpu")
    tout, tadler = teng.run(bodies, [tindex.build_index(b, n, OB)
                                     for b in bodies])
    plan = teng.last_plan
    # the JAX version's device plan also names its expansion buffers
    assert plan == {k: jeng.last_plan[k] for k in plan}
    assert plan["tier"] == tier
    if tier == "mixed":
        assert plan["hostset"] == [0, 2]
    if kind in ("sweeps", "records"):
        assert (plan["sweep_k"] is not None) == (kind == "sweeps")
        assert (plan["records_cap"] is not None) == (kind == "records")
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tadler, np.asarray(jadler))
    assert tout.numpy().tobytes() == b"".join(rows)
    assert tadler.tolist() == [zlib.adler32(r) for r in rows]


def test_inflate_zlib_batch_host_tier_matches_zlib(monkeypatch):
    monkeypatch.setattr(tsq, "RECORDS_SMEM_CAP", 1024)
    rows, streams = _tier_batch("mixed")
    teng = tic.CheckpointInflator("cpu", ob=OB)
    out = teng.inflate_zlib_batch(streams, len(rows[0]))
    assert out.numpy().tobytes() == b"".join(rows)
    assert teng.last_plan == dict(tier="mixed", hostset=[0, 2])


# ---- the encode tier --------------------------------------------------------

def test_sample_stats_and_walk_match_jax():
    data = payload("rows", 70_000)
    assert _same_stats(tdo._sample_stats(data), jdo._sample_stats(data))
    body = torch_native.deflate(data[: 1 << 16], 4, "ios")
    assert _same_stats(tdo._walk_stats(body, 8), jdo._walk_stats(body, 8))
    assert tdo._sample_stats(data[:4095]) == ([], None, None)


def _same_stats(a, b):
    return (a[0] == b[0] and np.array_equal(a[1], b[1])
            and np.array_equal(a[2], b[2]))


@pytest.mark.parametrize("policy", ["device", "strict"])
def test_deflate_batch_matches_jax_with_both_libraries(policy):
    datas = [payload("rows", 6_000)]
    got = tdo.deflate_device_optimal_batch(datas, level=9, pitch=200,
                                           device="cpu", size_policy=policy)
    want = jdo.deflate_device_optimal_batch(datas, level=9, pitch=200,
                                            size_policy=policy)
    assert got == want
    assert zlib.decompress(got[0]) == datas[0]
    if policy == "strict":
        # the native probe of this image beats the device parse
        assert got[0] == torch_native.deflate(datas[0], 9, "zlib")


def test_strict_estimate_matches_jax_on_a_large_image():
    px = chip_smoke.bench_image(1, 200, 200)
    data = chip_smoke.filter_rows(px.reshape(200, 800), 4).tobytes()
    assert len(data) > tdo._STRICT_FULL_N
    got = tdo._strict_estimate(data, 9)
    assert got[0] == "bpb" and got == jdo._strict_estimate(data, 9)


def _pixels(seed):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (2, 24, 32, 4))
    px[1] = px[1] // 16 * 16
    return px.astype(np.uint8)


@pytest.mark.parametrize("index", [False, True], ids=["plain", "index"])
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7, 9])
def test_batch_encode_native_routes_match_jax(level, index):
    # levels <= 7 on any device, and level 9 on a CPU device, take the
    # native deflate in both packages
    px = _pixels(level)
    got = BatchCodec("cpu").encode(px, level=level, kind="rgba8",
                                   index=index)
    assert got == JaxBatchCodec().encode(px, level=level, kind="rgba8",
                                         index=index)

