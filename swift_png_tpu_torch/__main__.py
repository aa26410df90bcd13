"""Command-line tools: inspect, decode, re-encode, index and gzip (the
commands of ``python -m swift_png_tpu``, with the same arguments, output
files, messages and exit codes)::

    python -m swift_png_tpu_torch inspect  file.png
    python -m swift_png_tpu_torch decode   file.png out.rgba   # rgba8 dump
    python -m swift_png_tpu_torch recode   in.png out.png --level 9 [--index]
    python -m swift_png_tpu_torch index    in.png [out.png]    # add spIx
    python -m swift_png_tpu_torch gzip     in [out.gz] --level 9
    python -m swift_png_tpu_torch gunzip   in.gz [out]

Every command runs on the host (numpy, and the native library when it is
available); none uses a device.
"""

from __future__ import annotations

import argparse
import os
import sys


def _cmd_inspect(args: argparse.Namespace) -> int:
    from . import inspection
    from ._host.png.image import Image

    img = Image.decompress_path(args.file)
    print(inspection.describe_image(img))
    return 0


def _cmd_decode(args: argparse.Namespace) -> int:
    from ._host.png.image import Image

    rgba = Image.decompress_path(args.file).unpack_rgba8()
    with open(args.out, "wb") as f:
        f.write(rgba.tobytes())
    h, w = rgba.shape[:2]
    print(f"{args.file}: {w}x{h} -> {args.out} "
          f"({rgba.nbytes} bytes rgba8)")
    return 0


def _cmd_recode(args: argparse.Namespace) -> int:
    from ._host.png.image import Image

    img = Image.decompress_path(args.file)
    img.compress_path(args.out, level=args.level, index=args.index)
    print(f"{args.file} ({os.path.getsize(args.file)} B) -> "
          f"{args.out} ({os.path.getsize(args.out)} B) at level "
          f"{args.level}{' +spIx' if args.index else ''}")
    return 0


def _cmd_index(args: argparse.Namespace) -> int:
    """Add an ``spIx`` checkpoint index to a PNG without recompressing it:
    one walk over the IDAT payload, every other chunk copied as it is."""
    from ._host.lz77.index import build_index
    from ._host.png import chunk as chunks
    from ._host.png import parsing
    from ._host.png.chunk import ByteDestination, ByteSource

    with open(args.file, "rb") as f:
        src = ByteSource(f.read())
    src.signature()
    parts: list[tuple[str, bytes]] = []
    idats: list[bytes] = []
    type_ = None
    while type_ != chunks.IEND:
        type_, payload = src.chunk()
        if type_ == chunks.IDAT:
            idats.append(payload)
        if type_ == chunks.spIx:
            print(f"{args.file}: already indexed")
            return 0
        if type_ == chunks.CgBI:
            print(f"{args.file}: iOS/CgBI stream — not indexable")
            return 1
        parts.append((type_, payload))
    full = b"".join(idats)
    if len(full) < 6:
        print(f"{args.file}: no IDAT payload")
        return 1
    header = parsing.Header.parse(dict(parts)[chunks.IHDR], "common")
    if header.interlaced:
        print(f"{args.file}: interlaced — not indexable")
        return 1
    W, H = header.size
    # the scanline bytes, filter bytes included
    out_size = H * (1 + ((W * header.pixel.volume + 7) >> 3))
    ix = build_index(full[2:-4], out_size, args.ob)
    if ix is None:
        print(f"{args.file}: stream outside the index's structural "
              "limits — left unchanged")
        return 1
    dst = ByteDestination()
    dst.signature()
    for type_, payload in parts:
        if type_ == chunks.IEND:
            dst.format(chunks.spIx, ix.serialize())
        dst.format(type_, payload)
    out = args.out or args.file
    with open(out, "wb") as f:
        f.write(b"".join(dst.chunks))
    print(f"{args.file} -> {out} (+spIx, {len(ix.serialize())} B, "
          f"ob={args.ob}, {os.path.getsize(out)} B total)")
    return 0


def _cmd_gzip(args: argparse.Namespace) -> int:
    from ._host.lz77 import gzip as g

    with open(args.file, "rb") as f:
        data = f.read()
    out = args.out or args.file + ".gz"
    with open(out, "wb") as f:
        f.write(g.archive(data, level=args.level))
    print(f"{args.file} ({len(data)} B) -> {out}")
    return 0


def _cmd_gunzip(args: argparse.Namespace) -> int:
    from ._host.lz77 import gzip as g

    with open(args.file, "rb") as f:
        blob = f.read()
    out = args.out or (args.file[:-3] if args.file.endswith(".gz")
                       else args.file + ".out")
    data = g.extract(blob)
    with open(out, "wb") as f:
        f.write(data)
    print(f"{args.file} ({len(blob)} B) -> {out} ({len(data)} B)")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="swift_png_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("inspect", help="dump metadata (PNGInspection)")
    s.add_argument("file")
    s.set_defaults(fn=_cmd_inspect)

    s = sub.add_parser("decode", help="decode to a raw rgba8 dump")
    s.add_argument("file")
    s.add_argument("out")
    s.set_defaults(fn=_cmd_decode)

    s = sub.add_parser("recode", help="decode + re-encode a PNG")
    s.add_argument("file")
    s.add_argument("out")
    s.add_argument("--level", type=int, default=9)
    s.add_argument("--index", action="store_true",
                   help="embed the spIx checkpoint decode index")
    s.set_defaults(fn=_cmd_recode)

    s = sub.add_parser(
        "index", help="add an spIx decode index without recompressing")
    s.add_argument("file")
    s.add_argument("out", nargs="?")
    s.add_argument("--ob", type=int, default=256,
                   help="output bytes per checkpoint unit")
    s.set_defaults(fn=_cmd_index)

    s = sub.add_parser("gzip", help="compress with the LZ77 product")
    s.add_argument("file")
    s.add_argument("out", nargs="?")
    s.add_argument("--level", type=int, default=9)
    s.set_defaults(fn=_cmd_gzip)

    s = sub.add_parser("gunzip", help="decompress a gzip member")
    s.add_argument("file")
    s.add_argument("out", nargs="?")
    s.set_defaults(fn=_cmd_gunzip)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
