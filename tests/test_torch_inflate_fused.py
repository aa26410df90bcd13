"""The port's general inflate (``swift_png_tpu_torch/ops/inflate_fused.py``:
the position-parallel decode as torch ops, here on the CPU) against the
JAX package's ``inflate_fused`` on the same padded input: output bytes,
status flags, end bit and Adler-32, on valid streams and on seeded
corruptions.  ``InflateFused.inflate``, ``InflateFusedBatch.inflate_batch``
and the host ``Inflator`` against theirs: the same bytes, or the same
error class and case.  Every comparison is exact.

Streams share a few signatures (output size, padded length, window, rank
budget), so the JAX side compiles a few programs and runs once per module.
"""

import gzip
import zlib

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

from swift_png_tpu.lz77 import Inflator as JaxInflator
from swift_png_tpu.ops import inflate_fused as J
from swift_png_tpu_torch._host.lz77.inflate import Inflator
from swift_png_tpu_torch._host.bits import BitWriter, reverse_bits
from swift_png_tpu_torch.ops import inflate_fused as P

# (out_size, padded length, window bytes, rank budget) per signature
SIGS = {"A": (6000, 1 << 14, 1 << 13, 1 << 13),
        "S": (5, 1 << 12, 1 << 10, 1 << 10),
        "B": (70000, 1 << 17, 1 << 15, 1 << 14)}
MAX_BLOCKS = 1 << 14


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(n, seed, alphabet=16):
    """Runs and short random strings over a small alphabet."""
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < n:
        if rng.random() < 0.5:
            parts.append(bytes(rng.integers(0, alphabet, rng.integers(1, 64),
                                            dtype=np.uint8)))
        else:
            parts.append(bytes([int(rng.integers(0, alphabet))])
                         * int(rng.integers(3, 200)))
    return b"".join(parts)[:n]


def _random(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _flushed(segments, level=6, strategy=zlib.Z_DEFAULT_STRATEGY):
    """One zlib stream, a full flush after each segment: a block (or a
    stored block, for incompressible data) per segment, and an empty stored
    block after each flush."""
    co = zlib.compressobj(level, zlib.DEFLATED, 15, 8, strategy)
    out = b""
    for s in segments:
        out += co.compress(s) + co.flush(zlib.Z_FULL_FLUSH)
    return out + co.flush()


def _repeat16_after_zero_run() -> bytes:
    """A zlib stream whose code-length code repeats (16) right after a
    zero run (17): zlib repeats 0 there (``tests/test_ops_inflate_fused.py``
    ``test_repeat16_after_zero_run``).  Inflates to 5 zero bytes."""
    out = BitWriter()
    out.write_bytes(bytes([0x78, 0x9C]))
    out.write(1, 1)   # final
    out.write(2, 2)   # dynamic
    out.write(0, 5)   # HLIT - 257
    out.write(0, 5)   # HDIST - 1
    out.write(18 - 4, 4)
    order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1]
    meta_len = {0: 3, 1: 3, 16: 2, 17: 2, 18: 2}
    for s in order:
        out.write(meta_len.get(s, 0), 3)
    code = {16: (0b00, 2), 17: (0b01, 2), 18: (0b10, 2),
            0: (0b110, 3), 1: (0b111, 3)}

    def meta(sym, extra=None, ebits=0):
        c, ln = code[sym]
        out.write(reverse_bits(c, ln), ln)
        if extra is not None:
            out.write(extra, ebits)

    meta(1)
    meta(18, 138 - 11, 7)
    meta(18, 105 - 11, 7)
    meta(17, 6 - 3, 3)
    meta(16, 3 - 3, 2)
    meta(17, 3 - 3, 3)
    meta(1)
    meta(0)
    for _ in range(5):
        out.write(0, 1)
    out.write(1, 1)   # EOB
    out.pad_to_byte()
    return bytes(out.drain()) + zlib.adler32(b"\x00" * 5).to_bytes(4, "big")


def _hlit_overflow() -> bytes:
    """A raw block with hlit = 287, over RFC 1951's 286, and a meta code of
    19 one-bit lengths (``test_hlit_overflow_rejected``)."""
    bw = BitWriter()
    bw.write(1, 1)
    bw.write(2, 2)
    bw.write(30, 5)   # hlit = 287
    bw.write(0, 5)    # hdist = 1
    bw.write(15, 4)   # hclen = 19
    for _ in range(19):
        bw.write(1, 3)
    bw.pad_to_byte()
    return bytes(bw.drain()) + b"\x00" * 64


def _stored_header(body: bytes, length: int) -> int:
    """Byte offset of the stored block header (LEN, NLEN) for ``length``."""
    pat = length.to_bytes(2, "little") + (length ^ 0xFFFF).to_bytes(
        2, "little")
    at = body.find(pat)
    assert at > 0
    return at


MULTI = ([_sample(12000, 20 + i) for i in range(3)] + [_random(8000, 30)]
         + [_sample(13000, 40 + i) for i in range(2)])
MULTI_BODY = _flushed(MULTI)[2:]


def _streams():
    """name → (signature, padded input)."""
    raw = {}
    for level in (0, 1, 6, 9):
        raw[f"smooth_l{level}"] = ("A", zlib.compress(
            _sample(6000, level), level)[2:])
        raw[f"random_l{level}"] = ("A", zlib.compress(
            _random(6000, level), level)[2:])
    raw["fixed"] = ("A", _flushed([_sample(6000, 7)],
                                  strategy=zlib.Z_FIXED)[2:])
    raw["deep_chain"] = ("A", zlib.compress(
        b"a" * 5000 + b"bc" * 300 + b"a" * 400, 9)[2:])
    raw["stored_mixed"] = ("A", _flushed(
        [_sample(2000, 8), _random(2000, 9), _sample(2000, 10)])[2:])
    raw["repeat16"] = ("S", _repeat16_after_zero_run()[2:])
    raw["hlit_overflow"] = ("S", _hlit_overflow())
    raw["multi"] = ("B", MULTI_BODY)
    raw["deep_chain_70k"] = ("B", zlib.compress(
        b"a" * 60000 + b"bc" * 4000 + b"a" * 2000, 9)[2:])
    out = {}
    for name, (sig, body) in raw.items():
        D = np.zeros(SIGS[sig][1], np.uint8)
        D[:len(body)] = np.frombuffer(body, np.uint8)
        out[name] = (sig, D)
    # corruptions of the multi-block stream
    rng = np.random.default_rng(12)
    body = np.frombuffer(MULTI_BODY, np.uint8)
    n = SIGS["B"][1]
    for i in range(16):
        D = np.zeros(n, np.uint8)
        D[:body.size] = body
        bit = int(rng.integers(0, 8 * body.size))
        D[bit >> 3] ^= 1 << (bit & 7)
        out[f"flip{i}"] = ("B", D)
    for i in range(8):
        D = np.zeros(n, np.uint8)
        cut = int(rng.integers(1, body.size))
        D[:cut] = body[:cut]
        out[f"truncate{i}"] = ("B", D)
    # a stored length pushed forward: the stream's end bit jumps into the
    # zero padding, or into a random tail put in its place
    at = _stored_header(MULTI_BODY, 8000)
    for i, length in enumerate((0xFFFF, 0xC000, 0x9000, 0x8001)):
        for tail in (False, True):
            D = np.zeros(n, np.uint8)
            D[:body.size] = body
            if tail:
                D[body.size:] = rng.integers(0, 256, n - body.size)
            D[at:at + 4] = np.frombuffer(
                length.to_bytes(2, "little")
                + (length ^ 0xFFFF).to_bytes(2, "little"), np.uint8)
            out[f"stored_push{i}{'_tail' if tail else ''}"] = ("B", D)
    for i in range(4):
        D = np.zeros(n, np.uint8)
        D[:body.size] = body
        D[:] = np.where(np.arange(n) >= body.size,
                        rng.integers(0, 256, n), D)
        bit = int(rng.integers(0, 8 * body.size))
        D[bit >> 3] ^= 1 << (bit & 7)
        out[f"flip_tail{i}"] = ("B", D)
    for i in range(6):   # in the first block's code-length tables
        D = np.zeros(n, np.uint8)
        D[:body.size] = body
        bit = int(rng.integers(3, 8 * 60))
        D[bit >> 3] ^= 1 << (bit & 7)
        out[f"flip_table{i}"] = ("B", D)
    # in the small signature a pushed stored length lands past the end of
    # the input: the header comes from the clamped last word of a random
    # tail, and a Huffman block there starts its windows at clamped offsets
    _, small = out["stored_mixed"]
    sbody = small[:np.flatnonzero(small)[-1] + 1]
    at = _stored_header(sbody.tobytes(), 2000)
    n = SIGS["A"][1]
    for i in range(8):
        D = rng.integers(0, 256, n).astype(np.uint8)
        D[:sbody.size] = sbody
        length = int(rng.integers(0x8000, 0x10000))
        D[at:at + 4] = np.frombuffer(
            length.to_bytes(2, "little")
            + (length ^ 0xFFFF).to_bytes(2, "little"), np.uint8)
        D[-4:] = rng.integers(0, 256, 4)
        out[f"stored_push_end{i}"] = ("A", D)
    return out


STREAMS = _streams()
N_CORRUPT = sum(1 for k in STREAMS if k.startswith(
    ("flip", "truncate", "stored_push")))


def _kw(sig):
    out_size, _, win, t_max = SIGS[sig]
    return dict(out_size=out_size, win_words=win, t_max=t_max,
                max_blocks=MAX_BLOCKS, tok_cap=out_size + 1)


@pytest.fixture(scope="module")
def jax_results():
    res = {}
    for name, (sig, D) in STREAMS.items():
        out, status, end_bit, adler = J.inflate_fused(jnp.asarray(D),
                                                      **_kw(sig))
        res[name] = (np.asarray(out)[:SIGS[sig][0]], int(status),
                     int(end_bit), int(adler))
    return res


def test_corruption_count():
    assert N_CORRUPT >= 32


@pytest.mark.parametrize("name", list(STREAMS))
def test_inflate_fused_matches_jax(name, jax_results):
    sig, D = STREAMS[name]
    out, status, end_bit, adler = P.inflate_fused(torch.from_numpy(D),
                                                  **_kw(sig))
    j_out, j_status, j_end, j_adler = jax_results[name]
    assert (status, end_bit, adler) == (j_status, j_end, j_adler)
    assert out.shape[0] % 32768 == 0
    assert np.array_equal(out[:SIGS[sig][0]].numpy(), j_out)
    if name in ("smooth_l6", "multi", "repeat16", "stored_mixed", "fixed"):
        assert status == 0    # the valid streams decode


def test_batch_matches_jax(jax_results):
    """A lockstep batch of valid and corrupt streams of one signature: JAX's
    ``vmap`` and the port's lockstep loop, row by row."""
    names = ["multi", "flip0", "truncate1", "stored_push0_tail",
             "deep_chain_70k", "flip_tail2"]
    Ds = np.stack([STREAMS[n][1] for n in names])
    j = J.inflate_fused_batch(jnp.asarray(Ds), **_kw("B"))
    out, status, end_bit, adler = P.inflate_fused_batch(
        torch.from_numpy(Ds), **_kw("B"))
    O = SIGS["B"][0]
    assert np.array_equal(status, np.asarray(j[1]))
    assert np.array_equal(end_bit, np.asarray(j[2]))
    assert np.array_equal(adler, np.asarray(j[3]).astype(np.int64))
    assert np.array_equal(out[:, :O].numpy(), np.asarray(j[0])[:, :O])
    for i, n in enumerate(names):   # each row as the stream alone
        assert (int(status[i]), int(end_bit[i]), int(adler[i])) == \
            jax_results[n][1:]


def _outcome(fn):
    """The bytes ``fn`` returns, or its error's class name and case."""
    try:
        out = fn()
    except Exception as e:   # noqa: BLE001 — compared by class and case
        return type(e).__name__, getattr(e, "case", str(e))
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    return bytes(np.asarray(out))


JAX_ENGINE = J.InflateFused(win_bytes=1 << 14, t_max=1 << 12)
ENGINE = P.InflateFused(win_bytes=1 << 14, t_max=1 << 12, device="cpu")
DATA = _sample(12000, 11)
ZL = zlib.compress(DATA, 6)
GZ = gzip.compress(DATA, 7, mtime=0)


def _flip(data: bytes, at: int, mask: int = 0xFF) -> bytes:
    b = bytearray(data)
    b[at] ^= mask
    return bytes(b)


INFLATE_CASES = {
    "zlib": (ZL, len(DATA), "zlib"),
    "ios": (ZL[2:-4], len(DATA), "ios"),
    "gzip": (GZ, len(DATA), "gzip"),
    "gzip_name": (gzip.compress(DATA, 5)[:3] + b"\x08"
                  + gzip.compress(DATA, 5)[4:10] + b"name\x00"
                  + gzip.compress(DATA, 5)[10:], len(DATA), "gzip"),
    "zlib_bad_adler": (_flip(ZL, len(ZL) - 1), len(DATA), "zlib"),
    "gzip_bad_crc": (_flip(GZ, len(GZ) - 5), len(DATA), "gzip"),
    "gzip_bad_isize": (_flip(GZ, len(GZ) - 1), len(DATA), "gzip"),
    "zlib_short": (b"\x78", 0, "zlib"),
    "zlib_empty": (b"", 0, "zlib"),
    "zlib_method": (b"\x77" + ZL[1:], len(DATA), "zlib"),
    "zlib_check_bits": (ZL[:1] + bytes([ZL[1] ^ 1]) + ZL[2:], len(DATA),
                        "zlib"),
    "zlib_dictionary": (b"\x78\xbb" + ZL[2:], len(DATA), "zlib"),
    "gzip_sigil": (b"\x1f\x8c" + GZ[2:], len(DATA), "gzip"),
    "gzip_method": (GZ[:2] + b"\x07" + GZ[3:], len(DATA), "gzip"),
    "gzip_flag_bits": (GZ[:3] + b"\x20" + GZ[4:], len(DATA), "gzip"),
    "gzip_hcrc": (GZ[:3] + b"\x02" + GZ[4:], len(DATA), "gzip"),
    "zlib_wrong_size": (ZL, len(DATA) - 1, "zlib"),
    "unknown_format": (ZL, len(DATA), "lz4"),
}


@pytest.mark.parametrize("case", list(INFLATE_CASES))
def test_inflate_matches_jax(case):
    data, size, fmt = INFLATE_CASES[case]
    want = _outcome(lambda: JAX_ENGINE.inflate(data, size, fmt))
    got = _outcome(lambda: ENGINE.inflate(data, size, fmt))
    assert got == want
    if case in ("zlib", "ios", "gzip", "gzip_name"):
        assert got == DATA


def test_inflate_keep_on_device():
    out = ENGINE.inflate(ZL, len(DATA), "zlib", keep_on_device=True)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert bytes(out.numpy()) == DATA


def test_budget_retry_matches_jax():
    """A block larger than the first window: both grow window and rank
    budget ×4 until it fits."""
    data = _random(40000, 5)
    comp = zlib.compress(data, 1)
    want = J.InflateFused(win_bytes=1 << 13, t_max=1 << 11).inflate(
        comp, len(data), "zlib")
    got = P.InflateFused(win_bytes=1 << 13, t_max=1 << 11,
                         device="cpu").inflate(comp, len(data), "zlib")
    assert bytes(got) == bytes(np.asarray(want)) == data


RUN_BODIES = {f"stored_mixed_flip{i}": i for i in range(8)}


@pytest.mark.parametrize("name", list(RUN_BODIES))
def test_run_error_taxonomy_matches_jax(name):
    """``run`` on corrupt bodies: the same bytes or the same error case."""
    body = _flushed([_sample(2000, 8), _random(2000, 9),
                     _sample(2000, 10)])[2:]
    rng = np.random.default_rng(100 + RUN_BODIES[name])
    bit = int(rng.integers(0, 8 * len(body)))
    body = _flip(body, bit >> 3, 1 << (bit & 7))
    jeng = J.InflateFused(win_bytes=1 << 13, t_max=1 << 13)
    peng = P.InflateFused(win_bytes=1 << 13, t_max=1 << 13, device="cpu")
    want = _outcome(lambda: jeng.run(body, 6000)[0][:6000])
    got = _outcome(lambda: peng.run(body, 6000)[0][:6000])
    assert got == want


def test_hlit_overflow_raises_like_jax():
    body = _hlit_overflow()
    want = _outcome(lambda: J.InflateFused().run(body, 4))
    got = _outcome(lambda: P.InflateFused(device="cpu").run(body, 4))
    assert got == want and got[0] == "DecompressionError"


@pytest.mark.parametrize("fmt", ["zlib", "ios"])
def test_inflate_batch_matches_jax(fmt):
    datas = [zlib.compress(_sample(9000, 60 + i), 6) for i in range(3)]
    if fmt == "ios":
        datas = [d[2:-4] for d in datas]
    want = J.InflateFusedBatch(win_bytes=1 << 14, t_max=1 << 12
                               ).inflate_batch(datas, 9000, fmt,
                                               keep_on_device=False)
    eng = P.InflateFusedBatch(win_bytes=1 << 14, t_max=1 << 12,
                              device="cpu")
    got = eng.inflate_batch(datas, 9000, fmt)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (3, 9000)
    assert np.array_equal(got.numpy(), np.asarray(want))
    for i in range(3):
        assert bytes(got[i].numpy()) == _sample(9000, 60 + i)


def test_inflate_batch_errors_match_jax():
    datas = [zlib.compress(_sample(9000, 60 + i), 6) for i in range(3)]
    bad_adler = datas[:2] + [_flip(datas[2], len(datas[2]) - 1)]
    bad_code = datas[:2] + [_flip(datas[2], 40)]
    for batch in (bad_adler, bad_code):
        want = _outcome(lambda: J.InflateFusedBatch(
            win_bytes=1 << 14, t_max=1 << 12).inflate_batch(batch, 9000))
        got = _outcome(lambda: P.InflateFusedBatch(
            win_bytes=1 << 14, t_max=1 << 12,
            device="cpu").inflate_batch(batch, 9000))
        assert got == want and got[0] == "DecompressionError"


HOST_CASES = [n for n in STREAMS if n != "hlit_overflow"]


def _host_outcome(cls, name):
    sig, D = STREAMS[name]
    out_size = SIGS[sig][0]
    data = bytes(D)
    fmt = "ios"
    if name == "repeat16":
        data, fmt = _repeat16_after_zero_run(), "zlib"

    def go():
        inf = cls(fmt)
        inf.push(data)
        return inf.pull(out_size), inf.terminal
    try:
        return go()
    except Exception as e:   # noqa: BLE001 — compared by class and case
        return type(e).__name__, getattr(e, "case", str(e))


@pytest.mark.parametrize("name", HOST_CASES)
def test_host_inflator_matches_jax_package(name):
    """The copied host ``Inflator`` against the JAX package's, on the same
    streams (valid and corrupt, zero-padded, read as ``ios``)."""
    assert _host_outcome(Inflator, name) == _host_outcome(JaxInflator, name)
