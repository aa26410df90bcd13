"""K3 (wavefront defilter): the port's plain PyTorch version against the
JAX package's Pallas kernel in interpret mode and its XLA scan, on the
same filtered bytes.  uint8 outputs compare exactly."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax.numpy as jnp

from swift_png_tpu.ops.unfilter import defilter_batch as jax_defilter_batch
from swift_png_tpu.ops.unfilter_pallas import defilter_pallas
from swift_png_tpu_torch.ops.unfilter import defilter_batch, defilter_reference


def _filtered(delay, B=2, H=9, groups=7, seed=0):
    rng = np.random.default_rng(seed + delay)
    f = rng.integers(0, 256, (B, H, 1 + groups * delay), dtype=np.uint8)
    f[:, :, 0] = rng.integers(0, 8, (B, H))   # types 5..7 predict 0
    f[0, :8, 0] = np.arange(min(H, 8))        # every type at least once
    return f


@pytest.mark.parametrize("delay", [1, 2, 3, 4, 6, 8])
def test_defilter_reference_matches_pallas_and_scan(delay):
    f = _filtered(delay)
    got = defilter_batch(torch.from_numpy(f), delay)
    assert got.dtype == torch.uint8 and got.shape == (2, 9, 7 * delay)
    want_scan = np.asarray(jax_defilter_batch(jnp.asarray(f), delay))
    np.testing.assert_array_equal(got.numpy(), want_scan)
    for b in range(f.shape[0]):
        want = np.asarray(defilter_pallas(jnp.asarray(f[b]), delay,
                                          interpret=True))
        np.testing.assert_array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("shape", [(1, 1, 5), (3, 1, 1), (1, 40, 1)])
def test_defilter_reference_thin_shapes(shape):
    """One row, one pixel group, one column: the wavefront's edges."""
    B, H, groups = shape
    delay = 3
    f = _filtered(delay, B=B, H=H, groups=groups, seed=7)
    got = defilter_reference(torch.from_numpy(f), delay)
    want = np.asarray(jax_defilter_batch(jnp.asarray(f), delay))
    np.testing.assert_array_equal(got.numpy(), want)


def test_defilter_rejects_bad_delay():
    f = torch.zeros((1, 2, 1 + 10), dtype=torch.uint8)
    with pytest.raises(ValueError):
        defilter_batch(f, 4)      # 10 % 4 != 0
    with pytest.raises(ValueError):
        defilter_batch(torch.zeros((1, 2, 1 + 18), dtype=torch.uint8), 9)


# Shapes that K3's memory path branches on: pitches that are not multiples
# of 4 or 16, one pixel group, heights at a warp's edges and past one
# 1,024-row chunk, a base pointer off 16-byte alignment.
ODD_PITCH = {1: 97, 2: 98, 3: 99, 4: 100, 6: 102, 8: 104}
ODD_SHAPES = ([(d, ODD_PITCH[d], h) for d in ODD_PITCH
               for h in (1, 31, 33, 1100)]
              + [(d, d, 33) for d in ODD_PITCH])


def _odd_case(delay, pitch, height, seed=11):
    """Filtered scanlines at a base offset of 1..15 bytes, every filter type
    (0..4 and one of 5..255) on at least one row: six images when there is
    one row."""
    B = 6 if height == 1 else 2
    rng = np.random.default_rng(seed + 7 * delay + height)
    f = rng.integers(0, 256, (B, height, 1 + pitch), dtype=np.uint8)
    kind = (np.arange(B)[:, None] + np.arange(height)[None, :]) % 6
    f[:, :, 0] = np.where(kind == 5, rng.integers(5, 256, kind.shape), kind)
    off = 1 + (delay + height) % 15
    flat = torch.zeros(f.size + 16, dtype=torch.uint8)
    t = flat[off:off + f.size].view(f.shape)
    t.copy_(torch.from_numpy(f))
    return f, t


@pytest.mark.parametrize("delay,pitch,height", ODD_SHAPES)
def test_defilter_reference_odd_shapes(delay, pitch, height):
    f, t = _odd_case(delay, pitch, height)
    got = defilter_batch(t, delay)
    assert got.shape == (f.shape[0], height, pitch)
    want = np.asarray(jax_defilter_batch(jnp.asarray(f), delay))
    np.testing.assert_array_equal(got.numpy(), want)
    if height == 1 or pitch == delay:      # the smallest cases
        for b in range(f.shape[0]):
            want = np.asarray(defilter_pallas(jnp.asarray(f[b]), delay,
                                              interpret=True))
            np.testing.assert_array_equal(got[b].numpy(), want)
