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


def test_decode_indexed_on_card_counts_launches(cuda):
    rng = np.random.default_rng(0)
    H, W = 64, 48
    px = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    rows = np.hstack([np.zeros((H, 1), np.uint8), px.reshape(H, W * 4)])
    s = zlib.compress(rows.tobytes(), 6)
    ix = build_index(s[2:-4], rows.size, OB)

    def chunk(kind, data):
        return (len(data).to_bytes(4, "big") + kind + data
                + zlib.crc32(kind + data).to_bytes(4, "big"))

    blob = (bytes([137, 80, 78, 71, 13, 10, 26, 10])
            + chunk(b"IHDR", W.to_bytes(4, "big") + H.to_bytes(4, "big")
                    + bytes([8, 6, 0, 0, 0]))
            + chunk(b"IDAT", s) + chunk(b"spIx", ix.serialize())
            + chunk(b"IEND", b""))
    _kernels.reset_launches()
    out = decode_indexed([blob, blob])
    assert out.device.type == "cuda"
    assert _kernels.launch_counts() == {"decode_stamp": 1, "defilter": 1}
    assert torch.equal(out.cpu(), torch.from_numpy(np.stack([px, px])))
