"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; run them
on the card with ``python -m pytest --noconftest tests/test_torch_cuda.py``
(the suite's conftest pins JAX to the CPU, and the card's machine has no
JAX)."""

import zlib

import numpy as np
import pytest
import torch

from swift_png_tpu_torch import _kernels, decode_indexed
from swift_png_tpu_torch._host.lz77.index import build_index
from swift_png_tpu_torch.ops.inflate_checkpoint import CheckpointInflator
from swift_png_tpu_torch.ops.inflate_seqcopy import (seqcopy_cuda,
                                                     seqcopy_reference)
from swift_png_tpu_torch.ops.inflate_stamp import (decode_stamp_cuda,
                                                   decode_stamp_reference)
from swift_png_tpu_torch.ops.unfilter import defilter_cuda, defilter_reference

pytestmark = pytest.mark.cuda
OB = 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(kind):
    rng = np.random.default_rng(2)
    if kind == "literal":
        y = (np.sin(np.arange(40_000) / 9.0) * 50 + 128).astype(np.int64)
        data = np.clip(y + rng.integers(-6, 7, y.size), 0, 255).astype(
            np.uint8).tobytes()
        return data, zlib.compress(data, 6)
    if kind == "stored":
        data = rng.integers(0, 256, 90_000, dtype=np.uint8).tobytes()
        return data, zlib.compress(data, 0)
    data = (rng.integers(0, 8, 150_000) * 31 % 251).astype(
        np.uint8).tobytes()
    return data, zlib.compress(data, 6)      # multiblock (stdlib blocks)


@pytest.mark.parametrize("kind,ob", [("literal", 256), ("literal", 1024),
                                     ("stored", 256), ("multiblock", 256)])
def test_decode_stamp_kernel_matches_plain(cuda, kind, ob):
    data, stream = _stream(kind)
    ix = build_index(stream[2:-4], len(data), ob)
    prep = CheckpointInflator(cuda).prepare([stream[2:-4]] * 3, [ix] * 3)
    args = (prep["spans"], prep["meta"], prep["tabs"], prep["symtab"],
            prep["kbound"])
    got = decode_stamp_cuda(*args, ob=ob)
    torch.cuda.synchronize()
    want = decode_stamp_reference(*args, ob=ob)
    owned = torch.arange(ob, device=cuda) < prep["meta"][:, 2:3]
    assert torch.equal(got[0][owned], want[0][owned])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    out, adler = CheckpointInflator(cuda).run([stream[2:-4]], [ix])
    assert out[0].cpu().numpy().tobytes() == data
    assert int(adler[0]) == zlib.adler32(data)


@pytest.mark.parametrize("delay", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("height", [5, 1100])
def test_defilter_kernel_matches_plain(cuda, delay, height):
    rng = np.random.default_rng(delay)
    f = rng.integers(0, 256, (2, height, 1 + 12 * delay), dtype=np.uint8)
    f[:, :, 0] = rng.integers(0, 8, (2, height))
    f = torch.from_numpy(f).to(cuda)
    got = defilter_cuda(f, delay)
    torch.cuda.synchronize()
    assert torch.equal(got, defilter_reference(f, delay))


def _png(W, H, stream, index_blob):
    """An rgba8 PNG with one IDAT and an ``spIx`` chunk."""
    def chunk(kind, data):
        return (len(data).to_bytes(4, "big") + kind + data
                + zlib.crc32(kind + data).to_bytes(4, "big"))

    return (bytes([137, 80, 78, 71, 13, 10, 26, 10])
            + chunk(b"IHDR", W.to_bytes(4, "big") + H.to_bytes(4, "big")
                    + bytes([8, 6, 0, 0, 0]))
            + chunk(b"IDAT", stream) + chunk(b"spIx", index_blob)
            + chunk(b"IEND", b""))


def test_decode_indexed_on_card_counts_launches(cuda):
    rng = np.random.default_rng(0)
    H, W = 64, 48
    px = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    rows = np.hstack([np.zeros((H, 1), np.uint8), px.reshape(H, W * 4)])
    s = zlib.compress(rows.tobytes(), 6)
    ix = build_index(s[2:-4], rows.size, OB)

    blob = _png(W, H, s, ix.serialize())
    _kernels.reset_launches()
    out = decode_indexed([blob, blob])
    assert out.device.type == "cuda"
    assert _kernels.launch_counts() == {"decode_stamp": 1, "defilter": 1,
                                        "seqcopy": 0}
    assert torch.equal(out.cpu(), torch.from_numpy(np.stack([px, px])))


def _k2_case(B, n_recs, Rp, rng, smooth):
    """Records after ``tools/exp_seqcopy.py`` ``_make_case``."""
    lit = rng.integers(0, 256, (B, Rp * 128), dtype=np.uint8)
    recs, starts = [], [0]
    for _ in range(B):
        pos = 300
        for _ in range(n_recs):
            if smooth:
                d, ln = int(rng.choice([1, 2, 4, 8])), int(rng.integers(64,
                                                                         258))
            else:
                d = int(rng.integers(1, min(pos, 32768)))
                ln = int(rng.integers(3, 259))
            if pos + ln >= (Rp - 17) * 128:
                break
            recs.append((pos, d, ln))
            pos += ln + int(rng.integers(1, 40))
        starts.append(len(recs))
    return lit, np.asarray(recs, np.int32), np.asarray(starts, np.int32)


@pytest.mark.parametrize("smooth", [False, True], ids=["random_d", "smooth"])
def test_seqcopy_kernel_matches_plain(cuda, smooth):
    lit, recs, starts = _k2_case(3, 300, 700, np.random.default_rng(5),
                                 smooth)
    args = [torch.from_numpy(x).to(cuda) for x in (starts, recs, lit)]
    got = seqcopy_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, seqcopy_reference(*args))


def test_seqcopy_kernel_keeps_hostile_records_in_their_row(cuda):
    lit = torch.arange(2 * 301, device=cuda).to(torch.uint8).reshape(2, 301)
    recs = torch.tensor([[-5, 3, 20], [290, 2, 50], [10, 0, 5],
                         [5, 20, 10], [0, 1, 0]], dtype=torch.int32,
                        device=cuda)
    starts = torch.tensor([0, 3, 5], dtype=torch.int32, device=cuda)
    got = seqcopy_cuda(starts, recs, lit)
    torch.cuda.synchronize()
    assert torch.equal(got, seqcopy_reference(starts, recs, lit))


def test_decode_indexed_records_mode_on_card(cuda):
    H = W = 128
    y, x = np.mgrid[0:H, 0:W]
    pngs, images = [], []
    for i in range(3):
        px = np.stack([(x // 8 + y // 8 + i) % 256, x // 4 % 256,
                       y // 4 % 256, np.full_like(x, 255)],
                      axis=-1).astype(np.uint8)
        # Up on every row: smooth content becomes a few long matches
        raw = px.reshape(H, W * 4).astype(np.int32)
        up = np.vstack([np.zeros((1, W * 4), np.int32), raw[:-1]])
        rows = np.hstack([np.full((H, 1), 2, np.uint8),
                          ((raw - up) & 255).astype(np.uint8)])
        s = zlib.compress(rows.tobytes(), 6)
        ix = build_index(s[2:-4], rows.size, OB)
        pngs.append(_png(W, H, s, ix.serialize()))
        images.append(px)
    _kernels.reset_launches()
    out = decode_indexed(pngs)
    assert _kernels.launch_counts() == {"decode_stamp": 1, "defilter": 1,
                                        "seqcopy": 1}
    assert torch.equal(out.cpu(), torch.from_numpy(np.stack(images)))
