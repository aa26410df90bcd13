"""Custom color targets (``Snippets/PNG/CustomColor.swift`` analog):
unpack a PNG straight into a user-defined HSVA representation through
the ``ColorTarget`` protocol — vectorized instead of per-pixel.
"""

import sys

import numpy as np

from swift_png_tpu_torch import png
from swift_png_tpu_torch.models import RGBA


def rgba_to_hsva(px: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 RGBA → float32 HSVA (h in degrees)."""
    r, g, b, a = (px[..., i].astype(np.float32) / 255.0 for i in range(4))
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    c = mx - mn
    h = np.zeros_like(mx)
    m = c > 0
    rm = m & (mx == r)
    gm = m & ~rm & (mx == g)
    bm = m & ~rm & ~gm
    h[rm] = (((g - b) / np.where(c == 0, 1, c))[rm]) % 6
    h[gm] = (((b - r) / np.where(c == 0, 1, c))[gm]) + 2
    h[bm] = (((r - g) / np.where(c == 0, 1, c))[bm]) + 4
    s = np.where(mx > 0, c / np.where(mx == 0, 1, mx), 0)
    return np.stack([h * 60.0, s, mx, a], axis=-1)


def main(path: str, out: str = "/tmp/spt_value_plane.png") -> None:
    image = png.Image.decompress_path(path)
    # the protocol route: unpack(as:) with the RGBA aggregate, then the
    # user conversion — the analog of conforming HSVA to PNG.Color
    hsva = rgba_to_hsva(image.unpack(RGBA.of8))
    h, s, v, a = (hsva[..., i] for i in range(4))
    print(f"{path}: hue mean {h.mean():.1f}°, saturation mean "
          f"{s.mean():.3f}, value mean {v.mean():.3f}")

    # round-trip back through RGBA and re-encode the value plane
    v8 = (v * 255).astype(np.uint8)
    from swift_png_tpu_torch.png.format import Format, Layout

    gray = np.stack([v8, v8, v8, np.full_like(v8, 255)], axis=-1)
    png.Image.pack(gray, Layout(Format("v8", ()), False)).compress_path(
        out, level=9)
    print(f"wrote {out}")


if __name__ == "__main__":
    main(*sys.argv[1:])
