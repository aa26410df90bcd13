"""Batched PNG decode and encode on the GPU.

Counterpart of ``decode_indexed``, ``decode_stage``,
``_palette_key_arrays``, ``_fused_engine``, ``encode_stage``,
``filter_select_sharded``, ``BatchCodec.decode``/``decode_filtered``/
``encode`` and ``deflate_shared_trees`` in
``swift_png_tpu/parallel/batch.py``.  Indexed
decode lexes each PNG, reads its ``spIx`` checkpoint chunk, inflates the
whole batch with the checkpoint-parallel kernel, then defilters (K3) and
convolves to RGBA.
General decode (any PNG, interlaced and iOS files too) inflates each image
with the fused inflate, then defilters (K3, once per Adam7 pass for
interlaced files) and convolves.  Encode packs and filters every scanline
of the batch on the device (each Adam7 pass apart for interlaced images),
then deflates the batch with the level 8–13 optimal parse (K4, K5, K6),
the greedy search with one shared tree set (K6), the native library's
deflate or the host ``Deflator``, and writes the containers on the host.
Over a device mesh (``BatchCodec(mesh=…)``) each process runs the device
stages of its block of images and the blocks are gathered back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from .._host import native as _native
from .._host.lz77.deflate import Deflator
from .._host.lz77.huffman import lengths_from_frequencies
from .._host.lz77.index import CheckpointIndex, build_index
from .._host.lz77.inflate import Inflator
from .._host.png import chunk as chunks
from .._host.png import parsing
from .._host.png.format import COMMON, IOS, Format, Layout
from .._host.png.image import write_pre_idat
from .._host.png.metadata import Metadata
from .._kernels import resolve_device
from ..ops import convolve
from ..ops.deflate import emit_pack_shared, greedy_tokens, term_frequencies
from ..ops.deflate_optimal import (_zlib_stream, batch_layout,
                                   deflate_device_optimal_batch)
from ..ops.deinterlace import ADAM7, deinterlace_samples, pass_geometry
from ..ops.filter import filter_select_batch
from ..ops.inflate_checkpoint import CheckpointInflator
from ..ops.inflate_fused import InflateFused
from ..ops.unfilter import defilter_batch
from .distributed import axis_block, gather_blocks, mesh_device

__all__ = ["decode_indexed", "decode_stage", "lex_png", "parse_indexed",
           "encode_stage", "filter_batch", "filter_select_sharded",
           "BatchCodec", "deflate_shared_trees"]


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
    with trace.span("decode.stage"):
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
    with trace.span("decode.lex"):
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
    with trace.span("decode.lex"):
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
    with trace.span("decode_indexed"):
        trace.count("images", len(pngs))
        parsed = parse_indexed(pngs)
        if parsed is None:
            return None
        bodies, indexes, h0, pals, keys = parsed
        out, _ = CheckpointInflator(dev).run(bodies, indexes)
        W, H = h0.size
        pixel = h0.pixel
        pal, key = _palette_key_arrays(pixel, pals, keys)
        out = decode_stage(
            out.reshape(len(pngs), H, 1 + ((W * pixel.volume + 7) >> 3)),
            delay=(pixel.volume + 7) >> 3, depth=pixel.depth,
            channels=pixel.channels, width=W, is_indexed=pixel.is_indexed,
            palette=None if pal is None else trace.upload(pal, dev),
            has_key=key is not None,
            key=None if key is None else trace.upload(key, dev),
            bits=bits)
        return out


def encode_stage(rows: torch.Tensor, delay: int) -> torch.Tensor:
    """Raw scanlines ``(B, H, pitch)`` → filtered scanlines with filter
    bytes ``(B, H, 1+pitch)``, on the input's device."""
    return filter_select_batch(rows, delay)


def filter_batch(samples: torch.Tensor, depth: int, channels: int,
                 interlaced: bool = False) -> torch.Tensor:
    """Raw samples ``(B, H, W, channels)`` int32 → each image's filtered
    bytes ``(B, n)`` uint8, on the input's device.  Adam7: each pass's
    strided subimage is packed and filtered for the whole batch, and the
    passes lie back to back per image."""
    B, H, W = samples.shape[:3]
    delay = max(1, (depth * channels + 7) >> 3)
    if not interlaced:
        rows = convolve.pack_rows(samples, depth, channels, W)
        return encode_stage(rows, delay).reshape(B, -1)
    parts = []
    for z, sub_x, _, _, _ in pass_geometry((W, H), depth * channels)[0]:
        (bx, by), (sx, sy) = ADAM7[z]
        rows = convolve.pack_rows(samples[:, by::sy, bx::sx], depth,
                                  channels, sub_x)
        parts.append(encode_stage(rows, delay).reshape(B, -1))
    return torch.cat(parts, dim=1)


def filter_select_sharded(mesh, rows: torch.Tensor, delay: int,
                          images_axis: str = "images",
                          rows_axis: str = "rows") -> torch.Tensor:
    """Filter select sharded over a 2-D ``(images, rows)`` device mesh, in
    SPMD form: each process passes its own block ``rows`` ``(B_local,
    H_local, pitch)`` uint8 and gets its block of the filtered scanlines,
    ``(B_local, H_local, 1 + pitch)``.  (The JAX version takes the global
    array and returns the global result.)

    A row shard needs the raw row just above its first row (the Up,
    Average and Paeth reference): the previous row shard's last raw row
    arrives over the ``rows`` sub-group (``batch_isend_irecv``), and the
    first shard takes zeros, as the JAX version masks its wrap-around.
    The halo and the block go through :func:`filter_select_batch` and the
    halo's row is dropped.  Every process of a column must pass the same
    ``B_local`` and ``pitch``.
    """
    axis = mesh.mesh_dim_names.index(rows_axis)
    idx, n = mesh.get_local_rank(rows_axis), mesh.size(axis)
    group = mesh.get_group(rows_axis)
    halo = torch.zeros_like(rows[:, 0])
    ops = []
    if idx + 1 < n:
        ops.append(dist.P2POp(dist.isend, rows[:, -1].contiguous(),
                              dist.get_global_rank(group, idx + 1), group))
    if idx > 0:
        ops.append(dist.P2POp(dist.irecv, halo,
                              dist.get_global_rank(group, idx - 1), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    padded = torch.cat([halo[:, None], rows], dim=1)
    return filter_select_batch(padded, delay)[:, 1:]


class BatchCodec:
    """Batch decode and encode of same-shape images on one device, or over
    a device mesh.

    ``device``: ``cuda`` unless the caller names another; ``"cpu"`` runs
    the plain PyTorch versions of the kernels.  With no device named and
    no GPU present this raises.

    ``mesh``: a ``DeviceMesh`` with a dimension named ``images_axis``
    (:func:`~swift_png_tpu_torch.parallel.distributed.global_mesh`).  The
    device then comes from the mesh (``cuda:<local rank>``, or ``cpu``).
    The mesh shards what the JAX version shards: ``decode`` runs the
    defilter and convolve (``decode_stage``, or the Adam7 deinterlace) and
    ``encode`` the filter stage (``filter_batch``) on this process's
    contiguous block of images, and the blocks come back to every process
    with ``all_gather_into_tensor`` over the images sub-group.  Everything
    else, lexing and inflate, the deflate and the containers, runs on
    every process as without a mesh, and processes along other mesh
    dimensions repeat their column's work.  Every process must make the
    same calls with the same inputs; the results equal the calls without
    a mesh byte for byte.
    """

    def __init__(self, device=None, mesh=None, images_axis: str = "images"):
        if mesh is not None:
            mdev = mesh_device(mesh)
            if device is not None and torch.device(device) != mdev:
                raise ValueError(f"device {device} is not this process's "
                                 f"device on the mesh, {mdev}")
            self.device = mdev
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.images_axis = images_axis

    def _sharded(self, fn, n: int) -> torch.Tensor:
        """``fn(lo, hi)``, a device stage over images ``[lo, hi)`` of a
        batch of ``n``: with a mesh over this process's block, the blocks
        gathered back to every process; else over all ``n``.  A process
        whose block is empty (``n`` under the images axis's size) runs the
        stage on the first image to learn the block's shape."""
        if self.mesh is None:
            return fn(0, n)
        lo, hi, block = axis_block(self.mesh, self.images_axis, n)
        part = fn(lo, hi) if hi > lo else fn(0, 1)[:0]
        return gather_blocks(self.mesh, self.images_axis, part, n, block)

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
        return trace.upload(np.stack(batch), self.device), info

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
        with trace.span("decode"):
            trace.count("images", len(images_png))
            filtered, info = self.decode_filtered(
                images_png, device_inflate, keep_on_device=True)
            W, H = info["size"]
            pixel = info["pixel"]
            pal, key = _palette_key_arrays(pixel, info["palettes"],
                                           info["transparencies"])
            pal = None if pal is None else trace.upload(pal, self.device)
            key = None if key is None else trace.upload(key, self.device)
            # CgBI streams store bgr8/bgra8 byte order
            is_bgr = info["standard"] == IOS and pixel.channels >= 3

            def run(lo: int, hi: int) -> torch.Tensor:
                pal_b = None if pal is None else pal[lo:hi]
                key_b = None if key is None else key[lo:hi]
                if info["interlaced"]:
                    with trace.span("decode.stage"):
                        samples = deinterlace_samples(
                            filtered[lo:hi], size=(W, H),
                            depth=pixel.depth, channels=pixel.channels)
                        return convolve.samples_to_rgba(
                            samples, depth=pixel.depth,
                            channels=pixel.channels, is_bgr=is_bgr,
                            is_indexed=pixel.is_indexed,
                            has_key=key_b is not None, palette=pal_b,
                            key=key_b, bits=bits)
                return decode_stage(
                    filtered[lo:hi], delay=(pixel.volume + 7) >> 3,
                    depth=pixel.depth, channels=pixel.channels, width=W,
                    is_bgr=is_bgr, is_indexed=pixel.is_indexed,
                    has_key=key_b is not None, palette=pal_b, key=key_b,
                    bits=bits)

            out = self._sharded(run, filtered.shape[0])
            return out if keep_on_device else trace.fetch(out).numpy()

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
        torch); for indexed kinds ``(B, H, W)`` palette indices; for
        sub-byte gray kinds raw ``depth``-bit samples.  Every non-iOS kind
        (v1/2/4/8/16, va8/16, rgb8/16, rgba8/16, indexed1/2/4/8) and
        bgr8/bgra8, which are written as iOS files (CgBI first) over a
        zlib stream.  ``palette`` (shared) or ``palettes`` (per image)
        give the palette: RGBA entries for indexed kinds (PLTE, and tRNS
        with its trailing opaque alphas trimmed), RGB entries (a suggested
        PLTE) for the others.  ``metadata``: one ``Metadata`` or one per
        image, written in the reference's chunk order.  ``interlaced``:
        Adam7, each pass packed and filtered on the device for the whole
        batch and the passes concatenated per image.  ``index=True`` adds
        an ``spIx`` checkpoint chunk (not for interlaced images).

        The deflate's route, as in the JAX package: ``shared_trees`` pools
        the batch's symbol statistics into one tree set
        (:func:`deflate_shared_trees`); levels 8–13 on a CUDA device, or
        without the native library, take the batched optimal parse (K4,
        K5, K6) under ``size_policy``; otherwise the native library's
        one-shot deflate (one block per stream when ``index=True``), or
        without it the host ``Deflator``.  A failure of the device parse
        raises (the JAX package falls back to the native deflate there).
        """
        with trace.span("encode"):
            if kind is None:
                kind = "rgba8" if bits == 8 else "rgba16"
            x = (pixels if isinstance(pixels, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(pixels)))
            if x.dim() == 3:
                x = x[..., None]
            B, H, W, Cn = x.shape
            trace.count("images", B)
            if palettes is None:
                palettes = [palette] * B
            if len(palettes) != B:
                raise ValueError("palettes must have one entry per image")
            mds = (metadata if isinstance(metadata, (list, tuple))
                   else [metadata] * B)
            layouts = [Layout(Format(kind, tuple(p) if p else ()),
                              interlaced) for p in palettes]
            pixel = layouts[0].format.pixel
            if pixel.channels != Cn:
                raise ValueError(f"{kind} wants {pixel.channels} channels, "
                                 f"got {Cn}")
            delay = max(1, (pixel.volume + 7) >> 3)
            with trace.sync():
                samples = x.to(device=self.device, dtype=torch.int32)
            with trace.span("encode.filter"):
                filtered = self._sharded(lambda lo, hi: filter_batch(
                    samples[lo:hi], pixel.depth, Cn, interlaced), B)
                flat_np = trace.fetch(filtered).numpy()
                datas = [flat_np[b].tobytes() for b in range(B)]

            use_native = _native.available()
            idats = None
            if shared_trees:
                idats = deflate_shared_trees(datas, level, device=self.device)
            elif level >= 8 and (self.device.type != "cpu" or not use_native):
                n_flat = filtered.shape[1]
                stride = batch_layout([n_flat] * B)[0]
                dbuf = torch.nn.functional.pad(filtered, (0, stride - n_flat))
                # the JAX package passes the full width's pitch, interlaced
                # or not
                idats = deflate_device_optimal_batch(
                    datas, level=level, pitch=W * delay + 1, bpp=delay,
                    device=self.device, dbuf=dbuf.reshape(-1),
                    size_policy=size_policy)
            outs = []
            for b, data in enumerate(datas):
                if idats is not None:
                    idat = idats[b]
                elif use_native:
                    idat = _native.deflate(
                        data, level, "zlib",
                        block_terms=1 << 22 if index else 0)
                else:
                    deflator = Deflator("zlib", level=level)
                    deflator.push(data, last=True)
                    idat = deflator.pull()
                ix = None
                if index and not interlaced:
                    with trace.span("encode.index"):
                        ix = build_index(idat[2:-4], len(data), 256)
                with trace.span("encode.container"):
                    dest = chunks.ByteDestination()
                    write_pre_idat(dest, (W, H), layouts[b],
                                   mds[b] or Metadata())
                    for ofs in range(0, len(idat), hint):
                        dest.format(chunks.IDAT, idat[ofs:ofs + hint])
                    if ix is not None:
                        dest.format(chunks.spIx, ix.serialize())
                    dest.format(chunks.IEND)
                    outs.append(dest.getvalue())
            return outs


def shared_tokens(payloads: list[bytes], level: int, device) -> list:
    """Each payload's greedy (lazy at level >= 4) terms over a buffer of
    ``2^max(12, bits of n)`` bytes on ``device``: ``[(terms, count)]``."""
    toks = []
    for data in payloads:
        n = len(data)
        N = 1 << max(12, n.bit_length())
        buf = torch.zeros(N, dtype=torch.uint8)
        buf[:n] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        with trace.sync():
            buf = buf.to(device)
        terms, _, count = greedy_tokens(buf, n, t_cap=N, lazy=level >= 4)
        toks.append((terms, count))
    return toks


def shared_tree(toks: list):
    """One tree set from the pooled symbol statistics of every stream's
    terms (the end-of-block symbol counted once per stream): ``((lit
    lengths, dist lengths), freq)``."""
    freq = np.zeros(320, np.int64)
    for terms, count in toks:
        freq += term_frequencies(trace.fetch(terms[:count]).numpy(),
                                 np.ones(count, bool))
    freq[256] = len(toks)
    return (lengths_from_frequencies(freq[:286], 15, force=True),
            lengths_from_frequencies(freq[288:318], 15, force=False)), freq


def deflate_shared_trees(payloads: list[bytes], level: int = 6,
                         device=None) -> list[bytes]:
    """Batch deflate with ONE tree set for every stream.

    Each payload's tokens come from the greedy match search
    (:func:`shared_tokens`), their statistics are pooled into one tree set
    built on the host (:func:`shared_tree`), and every stream's terms are
    emitted and packed against it, K6 in one launch for the batch
    (:func:`~swift_png_tpu_torch.ops.deflate.emit_pack_shared`).  Returns
    one complete single-block zlib stream per payload, computed on
    ``device`` (``cuda`` unless the caller names another).
    """
    toks = shared_tokens(payloads, level, resolve_device(device))
    tree, freq = shared_tree(toks)
    bodies = emit_pack_shared([t for t, _ in toks], [c for _, c in toks],
                              tree, freq)
    return [_zlib_stream(data, tree, *body)
            for data, body in zip(payloads, bodies)]
