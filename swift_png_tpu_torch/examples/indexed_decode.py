"""Indexed (checkpoint-parallel) batch decoding.

Writes PNGs with the `spIx` checkpoint chunk — still 100 % standard files —
then decodes the whole batch through the lockstep device pipeline:
checkpoint-parallel token decode, back-reference expansion, wavefront
defilter, and RGBA convolve, all on the card (K1, the tail, K3).

Run: ``python -m swift_png_tpu_torch.examples.indexed_decode``
"""

import numpy as np

from swift_png_tpu_torch import png
from swift_png_tpu_torch.parallel.batch import decode_indexed
from swift_png_tpu_torch.png.format import Format, Layout


def make_image(seed: int, H: int = 64, W: int = 64) -> png.Image:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    px = np.empty((H, W, 4), np.uint8)
    px[..., 0] = (x * 4 + seed * 16) % 256
    px[..., 1] = (y * 4) % 256
    px[..., 2] = rng.integers(0, 256, (H, W))
    px[..., 3] = 255
    return png.Image.pack(px, Layout(Format("rgba8", ()), False))


def main(device=None) -> tuple[list[bytes], np.ndarray]:
    """Encode four indexed PNGs and decode them as one batch; return the
    files and the decoded ``(4, 64, 64, 4)`` pixels.  ``device``: ``cuda``
    unless the caller names ``"cpu"``, which runs the kernels' plain
    versions."""
    images = [make_image(i) for i in range(4)]
    files = [im.compress_bytes(level=6, index=True) for im in images]
    print(f"encoded {len(files)} indexed PNGs "
          f"({sum(map(len, files))} bytes total)")

    # any standard decoder still works (the index chunk is ancillary):
    check = png.Image.decompress_bytes(files[0])
    assert np.array_equal(check.unpack_rgba8(), images[0].unpack_rgba8())

    # the batched device fast path:
    pixels = decode_indexed(files, device=device)
    assert pixels is not None, "fast path refused (missing index?)"
    got = pixels.cpu().numpy()
    for i, im in enumerate(images):
        assert np.array_equal(got[i], im.unpack_rgba8()), i
    print(f"decoded batch on {got.shape=} — bit-exact")
    return files, got


if __name__ == "__main__":
    main()
