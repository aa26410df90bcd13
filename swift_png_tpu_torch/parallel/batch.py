"""Batched PNG decode and encode on the GPU.

Counterpart of ``decode_indexed``, ``decode_stage``,
``_palette_key_arrays``, ``_fused_engine``, ``encode_stage`` and
``BatchCodec.decode``/``decode_filtered``/``encode`` in
``swift_png_tpu/parallel/batch.py``.  Indexed decode lexes each PNG, reads
its ``spIx`` checkpoint chunk, inflates the whole batch with the
checkpoint-parallel kernel, then defilters (K3) and convolves to RGBA.
General decode (any PNG, interlaced and iOS files too) inflates each image
with the fused inflate, then defilters (K3, once per Adam7 pass for
interlaced files) and convolves.  Encode packs and filters every scanline
of the batch on the device, then deflates the batch with the level 8–13
optimal parse (K4, K5, K6) or the native library's deflate, and writes the
containers on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .._host import native as _native
from .._host.lz77.index import CheckpointIndex, build_index
from .._host.lz77.inflate import Inflator
from .._host.png import chunk as chunks
from .._host.png import parsing
from .._host.png.format import COMMON, IOS, recognize_pixel
from .._host.png.image import write_pre_idat
from .._kernels import resolve_device
from ..ops import convolve
from ..ops.deflate_optimal import batch_layout, deflate_device_optimal_batch
from ..ops.deinterlace import deinterlace_samples, pass_geometry
from ..ops.filter import filter_select_batch
from ..ops.inflate_checkpoint import CheckpointInflator
from ..ops.inflate_fused import InflateFused
from ..ops.unfilter import defilter_batch

__all__ = ["decode_indexed", "decode_stage", "lex_png", "parse_indexed",
           "encode_stage", "BatchCodec"]


_FUSED: dict = {}


def _fused_engine(device: torch.device) -> InflateFused:
    """The fused inflate engine of ``device`` (one per device)."""
    eng = _FUSED.get(device)
    if eng is None:
        eng = _FUSED[device] = InflateFused(device=device)
    return eng


def decode_stage(filtered: torch.Tensor, *, delay: int, depth: int,
                 channels: int, width: int, is_bgr: bool = False,
                 is_indexed: bool = False, has_key: bool = False,
                 palette: torch.Tensor | None = None,
                 key: torch.Tensor | None = None,
                 bits: int = 8) -> torch.Tensor:
    """``(B, H, 1+pitch)`` filtered scanlines → ``(B, H, W, 4)`` RGBA on
    the input's device.  ``palette``/``key`` are per image: ``(B, 256, 4)``
    and ``(B, channels)`` (a key of −1 never matches); ``is_bgr`` reads
    the iOS byte order."""
    rows = defilter_batch(filtered, delay)
    return convolve.unpack_rgba(rows, depth=depth, channels=channels,
                                width=width, is_bgr=is_bgr,
                                is_indexed=is_indexed, has_key=has_key,
                                palette=palette, key=key, bits=bits)


def _palette_key_arrays(pixel, palettes, transparencies):
    """Per-image palette / chroma-key arrays (numpy): ``(pal (B, 256, 4) |
    None, key (B, channels) | None)``.  Palettes carry tRNS alpha (255
    default); a key of −1 never matches any raw sample."""
    B = len(transparencies)
    if pixel.is_indexed:
        pals = np.zeros((B, 256, 4), np.int32)
        for b, (palette, transparency) in enumerate(
                zip(palettes, transparencies)):
            alphas = list(transparency.value) if transparency else []
            for i, (r, g, bb) in enumerate(palette.entries):
                pals[b, i] = (r, g, bb,
                              alphas[i] if i < len(alphas) else 255)
        return pals, None
    if any(t is not None for t in transparencies):
        keys = np.full((B, pixel.channels), -1, np.int32)
        for b, transparency in enumerate(transparencies):
            if transparency is None:
                continue
            if transparency.case == "v":
                keys[b, 0] = transparency.value
            else:
                keys[b] = transparency.value
        return None, keys
    return None, None


def lex_png(data: bytes):
    """Lex one PNG for general decode: ``(header, standard, palette,
    transparency, idat)`` — the iOS standard when a CgBI chunk comes
    first, and the concatenated IDAT payloads."""
    stream = chunks.ByteSource(data)
    stream.signature()
    type_, payload = stream.chunk()
    standard = COMMON
    if type_ == chunks.CgBI:
        standard = IOS
        type_, payload = stream.chunk()
    header = parsing.Header.parse(payload, standard)
    palette = None
    transparency = None
    idat = bytearray()
    while True:
        type_, payload = stream.chunk()
        if type_ == chunks.PLTE:
            palette = parsing.Palette.parse(payload, header.pixel)
        elif type_ == chunks.tRNS:
            transparency = parsing.Transparency.parse(
                payload, header.pixel, palette)
        elif type_ == chunks.IDAT:
            idat += payload
        elif type_ == chunks.IEND:
            break
    return header, standard, palette, transparency, bytes(idat)


def parse_indexed(pngs: list[bytes]):
    """Lex a batch of PNGs for indexed decode.

    Returns ``(bodies, indexes, header, palettes, transparencies)`` — the
    raw-DEFLATE bodies, their checkpoint indexes and the first header — or
    ``None`` when any file is outside the fast path: no index, interlaced,
    iOS/CgBI, an indexed image without a palette, or mixed shapes.
    """
    bodies, indexes, headers, pals, keys = [], [], [], [], []
    for data in pngs:
        src = chunks.ByteSource(data)
        src.signature()
        type_, payload = src.chunk()
        if type_ != chunks.IHDR:
            return None  # CgBI (iOS stream framing) or malformed order
        header = parsing.Header.parse(payload)
        idats, ix, palette, transparency = [], None, None, None
        while type_ != chunks.IEND:
            type_, payload = src.chunk()
            if type_ == chunks.IDAT:
                idats.append(payload)
            elif type_ == chunks.spIx:
                try:
                    ix = CheckpointIndex.parse(payload)
                except ValueError:
                    ix = None  # unknown version/shape: general path
            elif type_ == chunks.PLTE:
                palette = parsing.Palette.parse(payload, header.pixel)
            elif type_ == chunks.tRNS:
                transparency = parsing.Transparency.parse(
                    payload, header.pixel, palette)
        if ix is None or header.interlaced:
            return None
        if header.pixel.is_indexed and palette is None:
            return None
        bodies.append(b"".join(idats)[2:-4])
        indexes.append(ix)
        headers.append(header)
        pals.append(palette)
        keys.append(transparency)
    if (len({ix.out_size for ix in indexes}) != 1
            or len({ix.ob for ix in indexes}) != 1):
        return None  # mixed shapes: bucket upstream
    h0 = headers[0]
    if any(h.pixel.name != h0.pixel.name or h.size != h0.size
           for h in headers):
        return None
    return bodies, indexes, h0, pals, keys


def decode_indexed(pngs: list[bytes], bits: int = 8, device=None):
    """Batched indexed decode: ``(B, H, W, 4)`` pixels on the device, at
    ``bits`` = 8 (uint8) or 16 (uint16), or ``None`` when any file is
    outside the fast path (see :func:`parse_indexed`).

    ``device``: ``cuda`` unless the caller names another; ``"cpu"`` runs
    the plain PyTorch versions of the kernels.  With no device named and
    no GPU present this raises.  Serves every non-interlaced standard
    format: gray/rgb/alpha at 1–16 bits, palette with per-image PLTE/tRNS,
    and chroma keys.
    """
    dev = resolve_device(device)
    parsed = parse_indexed(pngs)
    if parsed is None:
        return None
    bodies, indexes, h0, pals, keys = parsed
    out, _ = CheckpointInflator(dev).run(bodies, indexes)
    W, H = h0.size
    pixel = h0.pixel
    pal, key = _palette_key_arrays(pixel, pals, keys)
    return decode_stage(
        out.reshape(len(pngs), H, 1 + ((W * pixel.volume + 7) >> 3)),
        delay=(pixel.volume + 7) >> 3, depth=pixel.depth,
        channels=pixel.channels, width=W, is_indexed=pixel.is_indexed,
        palette=None if pal is None else torch.from_numpy(pal).to(dev),
        has_key=key is not None,
        key=None if key is None else torch.from_numpy(key).to(dev),
        bits=bits)


def encode_stage(rows: torch.Tensor, delay: int) -> torch.Tensor:
    """Raw scanlines ``(B, H, pitch)`` → filtered scanlines with filter
    bytes ``(B, H, 1+pitch)``, on the input's device."""
    return filter_select_batch(rows, delay)


# the non-indexed standard kinds by name: (depth, color type)
_KINDS = {"v1": (1, 0), "v2": (2, 0), "v4": (4, 0), "v8": (8, 0),
          "v16": (16, 0), "va8": (8, 4), "va16": (16, 4), "rgb8": (8, 2),
          "rgb16": (16, 2), "rgba8": (8, 6), "rgba16": (16, 6)}


class BatchCodec:
    """Batch decode and encode of same-shape images on one device.

    ``device``: ``cuda`` unless the caller names another; ``"cpu"`` runs
    the plain PyTorch versions of the kernels.  With no device named and
    no GPU present this raises.  (The JAX version takes a device mesh; one
    device serves here.)
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)

    # -- decode -----------------------------------------------------------

    def decode_filtered(self, images_png: list[bytes],
                        device_inflate: bool = True,
                        keep_on_device: bool = False):
        """Inflate each PNG into its filtered scanlines.

        Container lexing is host work; each image's DEFLATE stream is
        inflated by the fused inflate on the device
        (:mod:`swift_png_tpu_torch.ops.inflate_fused`), one image at a
        time, unless ``device_inflate=False`` selects the host engine.  An
        iOS file (CgBI chunk first) holds raw DEFLATE.

        Returns ``(B, H, 1+pitch)`` uint8 (``(B, nbytes)``, the flat pass
        streams, for interlaced files) — numpy, or a tensor on the device
        with ``keep_on_device`` — and the shared format info dict.  All
        images must agree on size and pixel format (``ValueError``).
        """
        batch = []
        info = None
        for data in images_png:
            header, standard, palette, transparency, idat = lex_png(data)
            W, H = header.size
            volume = header.pixel.volume
            if header.interlaced:
                _, nbytes = pass_geometry((W, H), volume)
                shape = None  # flat interlaced stream
            else:
                pitch = (W * volume + 7) >> 3
                nbytes = H * (pitch + 1)
                shape = (H, pitch + 1)
            fmt = "ios" if standard == IOS else "zlib"
            if device_inflate:
                raw = _fused_engine(self.device).inflate(
                    idat, nbytes, fmt, keep_on_device=keep_on_device)
            else:
                inflator = Inflator(fmt)
                inflator.push(idat)
                pulled = inflator.pull(nbytes)
                if pulled is None:
                    raise ValueError("truncated image data")
                raw = np.frombuffer(pulled, np.uint8)
            batch.append(raw.reshape(shape) if shape else raw)
            this = dict(size=(W, H), pixel=header.pixel, palette=palette,
                        transparency=transparency, standard=standard,
                        interlaced=header.interlaced)
            if info is None:
                info = dict(this)
                info["palettes"] = []
                info["transparencies"] = []
            elif (info["size"], info["pixel"].name) != (this["size"],
                                                        this["pixel"].name):
                raise ValueError("batch images must share size and format")
            # palettes and chroma keys are per-image even within one bucket
            info["palettes"].append(palette)
            info["transparencies"].append(transparency)
        if not keep_on_device:
            return np.stack(batch), info
        if device_inflate:
            return torch.stack(batch), info
        return torch.from_numpy(np.stack(batch)).to(self.device), info

    def decode(self, images_png: list[bytes], bits: int = 8,
               device_inflate: bool = True, keep_on_device: bool = False):
        """Full batch decode of any PNGs of one size and pixel format to
        ``(B, H, W, 4)`` RGBA pixels at ``bits`` = 8 (uint8) or 16
        (uint16): numpy, or a tensor on the device with
        ``keep_on_device``.

        Every standard format (gray, gray-alpha, rgb, rgba at 1–16 bits,
        palettes with per-image PLTE/tRNS, chroma keys), Adam7 interlacing
        (K3 once per pass) and iOS (CgBI) files with their bgr byte order.
        The filtered scanlines stay on the device between the inflate and
        the defilter.
        """
        filtered, info = self.decode_filtered(images_png, device_inflate,
                                              keep_on_device=True)
        W, H = info["size"]
        pixel = info["pixel"]
        pal, key = _palette_key_arrays(pixel, info["palettes"],
                                       info["transparencies"])
        pal = None if pal is None else torch.from_numpy(pal).to(self.device)
        key = None if key is None else torch.from_numpy(key).to(self.device)
        # CgBI streams store bgr8/bgra8 byte order
        is_bgr = info["standard"] == IOS and pixel.channels >= 3
        if info["interlaced"]:
            samples = deinterlace_samples(filtered, size=(W, H),
                                          depth=pixel.depth,
                                          channels=pixel.channels)
            out = convolve.samples_to_rgba(
                samples, depth=pixel.depth, channels=pixel.channels,
                is_bgr=is_bgr, is_indexed=pixel.is_indexed,
                has_key=key is not None, palette=pal, key=key, bits=bits)
        else:
            out = decode_stage(
                filtered, delay=(pixel.volume + 7) >> 3, depth=pixel.depth,
                channels=pixel.channels, width=W, is_bgr=is_bgr,
                is_indexed=pixel.is_indexed, has_key=key is not None,
                palette=pal, key=key, bits=bits)
        return out if keep_on_device else out.cpu().numpy()

    # -- encode -----------------------------------------------------------

    def encode(self, pixels, level: int = 9, bits: int = 8,
               kind: str | None = None, palette: tuple | None = None,
               hint: int = 1 << 15, index: bool = False, *,
               palettes: list | None = None, interlaced: bool = False,
               metadata=None, shared_trees: bool = False,
               size_policy: str = "strict") -> list[bytes]:
        """Batch encode raw samples → standard PNG byte strings, the same
        bytes as the JAX ``BatchCodec.encode``.

        ``pixels``: ``(B, H, W, C)`` samples in the target depth (numpy or
        torch; sub-byte gray kinds take raw ``depth``-bit samples, ``(B,
        H, W)`` is read as one channel).  Serves the non-interlaced,
        non-indexed kinds (v1/2/4/8/16, va8/16, rgb8/16, rgba8/16): filter
        select on the device, then the deflate, IDAT chunks of ``hint``
        bytes, an ``spIx`` checkpoint chunk with ``index=True``, IEND.

        The deflate's route, as in the JAX package: levels 8–13 on a CUDA
        device take the batched optimal parse (K4, K5, K6) under
        ``size_policy``.  With the native library, levels <= 7 on any
        device and levels 8–13 on a CPU device take its one-shot deflate
        (one block per stream when ``index=True``, which the indexed
        decoder prefers).  Without it, a CPU device runs the plain
        versions of the device parse.

        Indexed kinds, palettes, interlacing, metadata, shared trees and,
        without the native library, levels <= 7 raise
        ``NotImplementedError``: they are queued in ``ROADMAP.md``
        (queue 1).
        """
        if kind is None:
            kind = "rgba8" if bits == 8 else "rgba16"
        use_native = _native.available()
        why = None
        if kind not in _KINDS:
            why = f"kind {kind!r} (indexed and iOS kinds)"
        elif palette is not None or palettes is not None:
            why = "palettes"
        elif interlaced:
            why = "interlaced encode"
        elif metadata is not None:
            why = "metadata chunks"
        elif shared_trees:
            why = "shared trees"
        elif level < 8 and not use_native:
            why = f"level {level} (levels <= 7 without the native library)"
        if why is not None:
            raise NotImplementedError(
                f"BatchCodec.encode: {why} is not ported yet (ROADMAP.md, "
                f"queue 1: levels <= 7 without the native library and "
                f"shared trees; interlaced, indexed and metadata encode)")
        pixel = recognize_pixel(_KINDS[kind])
        x = (pixels if isinstance(pixels, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(pixels)))
        if x.dim() == 3:
            x = x[..., None]
        B, H, W, Cn = x.shape
        if Cn != pixel.channels:
            raise ValueError(f"{kind} wants {pixel.channels} channels, "
                             f"got {Cn}")
        delay = max(1, (pixel.volume + 7) >> 3)
        samples = x.to(device=self.device, dtype=torch.int32)
        rows = convolve.pack_rows(samples, pixel.depth, Cn, W)
        filtered = encode_stage(rows, delay).reshape(B, -1)
        flat_np = filtered.cpu().numpy()
        datas = [flat_np[b].tobytes() for b in range(B)]
        if level >= 8 and (self.device.type != "cpu" or not use_native):
            n_flat = filtered.shape[1]
            stride = batch_layout([n_flat] * B)[0]
            dbuf = torch.nn.functional.pad(filtered, (0, stride - n_flat))
            idats = deflate_device_optimal_batch(
                datas, level=level, pitch=W * delay + 1, bpp=delay,
                device=self.device, dbuf=dbuf.reshape(-1),
                size_policy=size_policy)
        else:
            idats = [_native.deflate(data, level, "zlib",
                                     block_terms=1 << 22 if index else 0)
                     for data in datas]
        outs = []
        for data, idat in zip(datas, idats):
            dest = chunks.ByteDestination()
            write_pre_idat(dest, (W, H), pixel)
            for ofs in range(0, len(idat), hint):
                dest.format(chunks.IDAT, idat[ofs:ofs + hint])
            if index:
                ix = build_index(idat[2:-4], len(data), 256)
                if ix is not None:
                    dest.format(chunks.spIx, ix.serialize())
            dest.format(chunks.IEND)
            outs.append(dest.getvalue())
        return outs
