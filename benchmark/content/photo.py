"""Photographs and renders: the bench recipe of ``chip_smoke.py``
(``bench_image``), frozen here.  Sinusoidal ramps per channel plus Gaussian
noise of sigma 12, opaque alpha; about 0.69 of the raw bytes under zlib -6
with the minimum-sum filter."""

import numpy as np


def image(seed: int, index: int, height: int, width: int) -> np.ndarray:
    """Image ``index`` of the run with ``seed``: ``(height, width, 4)``
    uint8."""
    s = int(np.random.SeedSequence([seed, index]).generate_state(1)[0])
    rng = np.random.default_rng(s)
    y, x = np.mgrid[0:height, 0:width]
    base = (128 + 60 * np.sin(x / 37.0 + s) + 50 * np.cos(y / 23.0)
            )[..., None] + np.array([0, 30, -20, 0])[None, None, :]
    noise = rng.normal(0, 12, (height, width, 4))
    pixels = np.clip(base + noise, 0, 255).astype(np.uint8)
    pixels[..., 3] = 255
    return pixels
