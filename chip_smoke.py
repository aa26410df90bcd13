#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``swift_png_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``swift_png_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, then drives the
port's paths at the bench size (B = 32 streams of 512×512 rgba8, ob = 256):

* the main path — batched indexed PNG decode, :func:`decode_indexed` — on
  photographic content (literal-heavy: K1, the pointer-doubling tail, K3);
* the match-dominated ``records`` configuration: smooth images under the
  per-row minimum-sum filter heuristic, through :func:`decode_indexed`
  (K1, the records build, K2, the output-byte Adler-32, K3);
* the match-dominated ``sweeps`` configuration: the same images filtered
  ``y % 5``, as complete zlib streams through ``CheckpointInflator.
  inflate_zlib_batch`` (K1, the distance sweeps, the collapse residual,
  the trailer checks);
* the ``host_tier`` configuration: a batch of noisy zlib -9 streams
  (near-uniform match distances) interleaved with the ``records`` rows,
  and a batch of noisy streams alone, through ``inflate_zlib_batch`` (the
  native host tier, overlapped with K1 and K2 on the records streams);
* the general decode (``BatchCodec.decode``) of ordinary PNGs with no
  ``spIx`` chunk: rgba8, Adam7 and iOS (CgBI) bgra8 batches of the bench
  images (the fused inflate per image, K3 once or once per Adam7 pass,
  the convolve), with the lockstep ``InflateFusedBatch`` timed beside it;
* the level-9 encode (``BatchCodec.encode``, strict size policy) of
  photographic and smooth images, read back through
  :func:`decode_indexed` (K4, K5, K6; K1, K3 or K2);
* the rest of the encode (``encode_general``): the bench images Adam7
  interlaced at level 9 (K4, K5, K6 on the concatenated pass streams),
  quantised to indexed8 with a palette of 256 entries per image at level 9
  with ``index=True`` (1-byte rows), and with one shared tree set at level
  6 (the greedy search as torch ops, K6 in one launch for the batch); every
  stream inflates through ``zlib`` to the port's filtered bytes, four
  images of each come back exact through ``BatchCodec.decode`` (all 32
  indexed8 ones through :func:`decode_indexed` too), and each kernel is
  held against its plain version at these shapes; then a bgra8 batch with
  gAMA, pHYs, iCCP, compressed iTXt and tIME chunks (``encode_metadata``);
* the scale-out layer (``scale_out``) on a one-rank NCCL mesh:
  ``deflate_segmented`` of 32 MiB of the filtered bench images in 16
  segments (K6 once for all of them), ``BatchCodec(mesh)``'s level-9
  encode (K4, K5, K6) and decode (K3), ``filter_select_sharded`` and
  ``CorpusDecoder`` over four buckets, each equal to the call without a
  mesh, then ``dryrun_multichip(1)`` in a spawned process;
* the single-image API (``host_api``): ``Image.decompress_bytes`` and
  ``Image.compress_bytes(level=9)`` against ``BatchCodec.decode`` and
  ``BatchCodec.encode(level=9)`` on the card on the bench image, plain and
  Adam7, each read back through the other path (K3; K4, K5, K6); a 128×128
  image of every colour kind through the Python engine; a ``Context`` fed
  in 4,096-byte pieces; gzip both ways with Python's ``gzip``; every
  subcommand of ``python -m swift_png_tpu_torch`` in a subprocess; and the
  convolve twins ``samples_to_va``, ``premultiply`` and ``straighten`` on
  the card against the CPU;
* the port's copies of the JAX package's examples (``examples``):
  ``indexed_decode.main()`` (K1, the tail, K3) and ``batch_decode_cuda.
  main`` on 8 bench images as ordinary PNGs over a one-rank NCCL mesh
  (the fused inflate, K3), each with no device named and exact against
  its source; then the nine host examples as ``python -m
  swift_png_tpu_torch.examples.<name>`` subprocesses at once.

It builds the port's native host library (``swift_png_tpu_torch/_host/
native``, ``g++``) beside the kernels and fails when the library is not
available: the checkpoint-index walk, the host tier and the encoder's
sampling and strict policy run in it.  The index stages are timed beside
the Python walk they replaced.

Beside the main batches, K1 is held against its plain version on a stored
stream, a level-1 RLE stream, a stream with 15-bit literal codes and a
corrupt body, and on seeded corruptions of batches in each of the TPU
kernel's three step modes (``k1_corrupt``: flags compared, and ``run`` on
the card against ``run`` on the CPU), K3 on odd pitches, one pixel group,
heights 1 to 1,100 and base pointers off 16-byte alignment (the
``k3_launch`` line gives its launch shape), K2 on K2′'s recipe, records
crossing 128-byte rows, records longer than its ring, more records than
it stages at once, long runs of ``len = 0`` records, a hostile stream
among well-formed ones, rows off
16-byte alignment, a stream and a batch without records, and the records
of the ``sweeps`` batch (``k2_check``: each stream's path against
``records_well_formed``), K4 on its edge cases
(``k4_edge_check``: every ``d % 4`` residue, distances up to 32,768, ``n``
off multiples of 4 and 32, ``d >= n``, runs cut at 258, equal scores,
``dmax`` 8, 16 and 32, bytes off 16-byte alignment) and K5 on inputs built
to tie and on cost tables × 2,000.  K4 and K5 are timed on the
photographic and the smooth batch; the ``warps_per_sm`` line gives K1's,
K2's, K4's and K5's resident warps.

Each path checks its output against the source and zlib's Adler-32, and
each kernel of a path must have launched while the path ran.  Every phase
prints one JSON line; the line before the last is ``nvidia-smi``'s card
name and power limit and the last line is ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero before that line.  Without a CUDA
device it exits non-zero at once.  It imports nothing of JAX or of
``swift_png_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B, H, W, OB = 32, 512, 512, 256
DISTINCT = 8            # distinct streams, each reused B // DISTINCT times
REPS = 5                # warm timed runs of the main path
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# H100 SXM peak int32 rate outside the tensor cores: each SM's four
# schedulers issue one 32-lane instruction per clock (integer ALU ops on
# the INT32 pipe, IMAD on the FMA pipe), × 132 SMs × 1.98 GHz boost clock.
# The data sheet lists no int32 figure; no mix of int32 instructions can
# go faster than this issue rate.
INT_OPS_PER_S = 4 * 32 * 132 * 1.98e9
# Integer operations that the decode itself needs (not what K1's source
# spends), charged per token by kind so that the count follows this run's
# data.  One Huffman code: bit window (3), reverse (1), code-length search
# over 15 lengths by bisection (8), symbol index + packed lookup (4),
# cursor advance (1).
OPS_PER_CODE = 17
OPS_PER_EXTRA = 4           # base (closed form), extract, add, advance
OPS_PER_ADLER_BYTE = 3      # s1 add, s2 multiply-add, index
OPS_PER_STAMP_BYTE = 1      # one store per output byte
# K3: predictor operations per byte by filter type (None, Sub, Up, Average,
# Paeth) plus the add; types >= 5 predict 0 like None.
K3_OPS_BY_TYPE = (1, 1, 1, 3, 13)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---- inputs: the bench image recipe, filtered with type y % 5 -------------

def bench_image(seed: int, h: int | None = None,
                w: int | None = None) -> np.ndarray:
    """``bench.py``'s image recipe (``_image``), ``h × w`` (default
    ``H × W``)."""
    h, w = h or H, w or W
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(x / 37.0 + seed) + 50 * np.cos(y / 23.0)
            )[..., None] + np.array([0, 30, -20, 0])[None, None, :]
    noise = rng.normal(0, 12, (h, w, 4))
    pixels = np.clip(base + noise, 0, 255).astype(np.uint8)
    pixels[..., 3] = 255
    return pixels


def filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG-filter ``(H, pitch)`` rows with filter type ``y % 5`` per row."""
    h, p = rows.shape
    raw = rows.astype(np.int32)
    up = np.vstack([np.zeros((1, p), np.int32), raw[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), raw[:, :-bpp]])
    ul = np.hstack([np.zeros((h, bpp), np.int32), up[:, :-bpp]])
    pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    ft = (np.arange(h) % 5)[:, None]
    pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                     [left, up, (left + up) >> 1, paeth], 0)
    out = ((raw - pred) & 255).astype(np.uint8)
    return np.hstack([ft.astype(np.uint8), out])


def smooth_image(i: int, h: int | None = None,
                 w: int | None = None) -> np.ndarray:
    """The bench's smooth recipe (``bench.py``'s smooth set), image ``i``,
    ``h × w`` (default ``H × W``)."""
    y, x = np.mgrid[0:h or H, 0:w or W]
    return np.stack([(x // 8 + y // 8 + i) % 256, x // 4 % 256, y // 4 % 256,
                     np.full_like(x, 255)], axis=-1).astype(np.uint8)


def filter_minsum(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG-filter ``(H, pitch)`` rows, each with the type (None, Sub, Up,
    Average, Paeth; the lowest on a tie) whose residual bytes, read as
    signed, have the least sum of magnitudes."""
    h, p = rows.shape
    raw = rows.astype(np.int32)
    up = np.vstack([np.zeros((1, p), np.int32), raw[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), raw[:, :-bpp]])
    ul = np.hstack([np.zeros((h, bpp), np.int32), up[:, :-bpp]])
    pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    res = np.stack([(raw - pred) & 255 for pred in
                    (0, left, up, (left + up) >> 1, paeth)]).astype(np.uint8)
    score = np.abs(res.view(np.int8).astype(np.int32)).sum(2)
    ft = score.argmin(0)
    return np.hstack([ft[:, None].astype(np.uint8), res[ft, np.arange(h)]])


def k2_case(B: int, n_recs: int, Rp: int, rng, smooth: bool = False):
    """K2′'s input recipe (``tools/exp_seqcopy.py`` ``_make_case``):
    ``(lit (B, Rp·128) u8, recs (n, 3) i32, starts (B+1,) i32)``; random
    distances, or runs at d in {1, 2, 4, 8} that overlap themselves."""
    lit = rng.integers(0, 256, (B, Rp * 128), dtype=np.uint8)
    recs = []
    starts = [0]
    for b in range(B):
        pos = 300
        for _ in range(n_recs):
            if smooth:
                d = int(rng.choice([1, 2, 4, 8]))
                ln = int(rng.integers(64, 258))
            else:
                d = int(rng.integers(1, min(pos, 32768)))
                ln = int(rng.integers(3, 259))
            if pos + ln >= (Rp - 17) * 128:
                break
            recs.append((pos, d, ln))
            pos += ln + int(rng.integers(1, 40))
        starts.append(len(recs))
    recs = np.asarray(recs, np.int32).reshape(-1, 3)
    return lit, recs, np.asarray(starts, np.int32)


def k2_rows_case(B: int, Opad: int, rng):
    """Records that cross 128-byte rows: d = 1 runs and non-power-of-two
    distances above 128, each run starting a few bytes before a row end
    (never before the previous run's end) and reaching over several
    rows."""
    lit = rng.integers(0, 256, (B, Opad), dtype=np.uint8)
    recs, starts = [], [0]
    dists = (1, 3, 129, 200, 1000, 4097, 32768)
    for b in range(B):
        pos = 40_000
        k = 0
        while pos + 2000 < Opad:
            at = (pos // 128 + 1) * 128 - int(rng.integers(1, 9))
            pos = at if at >= pos else at + 128
            ln = int(rng.integers(130, 1500))
            recs.append((pos, dists[k % len(dists)], ln))
            pos += ln + int(rng.integers(0, 300))
            k += 1
        starts.append(len(recs))
    return lit, np.asarray(recs, np.int32), np.asarray(starts, np.int32)


def k2_long_case(Opad: int, ln: int, rng):
    """One record per stream, longer than K2's 128 KB ring, at d = 1, 3,
    4, 2,049 and 32,768."""
    dists = (1, 3, 4, 2049, 32768)
    lit = rng.integers(0, 256, (len(dists), Opad), dtype=np.uint8)
    recs = np.array([(40_000 + 7 * k, d, ln) for k, d in enumerate(dists)],
                    np.int32)
    return lit, recs, np.arange(len(dists) + 1, dtype=np.int32)


def k2_many_case(n: int, rng):
    """One stream of ``n`` short records (more than K2 stages at once),
    a few of them ``len = 0``, between two streams of a few records."""
    recs, starts = [], [0]
    for count in (5, n, 3):
        pos = 100
        for k in range(count):
            ln = 0 if k % 97 == 50 else int(rng.integers(3, 40))
            recs.append((pos, int(rng.integers(1, min(pos, 32768) + 1)), ln))
            pos += ln + int(rng.integers(0, 9))
        starts.append(len(recs))
    Opad = max(r[0] + r[2] for r in recs) + 1000
    lit = rng.integers(0, 256, (3, Opad), dtype=np.uint8)
    return lit, np.asarray(recs, np.int32), np.asarray(starts, np.int32)


def k2_noop_case(rng):
    """Three 200 KB streams whose well-formed records stand between runs
    of 64 to 200 consecutive ``(pos, 1, 0)`` records (no-ops), at the
    start of a stream, inside it and at its end."""
    Opad = 200_000
    recs, starts = [], [0]
    for _ in range(3):
        pos, k = 100, 0
        while pos + 3000 < Opad:
            recs.extend([(pos, 1, 0)] * (64, 70, 131, 200)[k % 4])
            ln = int(rng.integers(50, 3000))
            recs.append((pos, int(rng.integers(1, min(pos, 32768) + 1)), ln))
            pos += ln + int(rng.integers(0, 2000))
            k += 1
        recs.extend([(pos, 1, 0)] * 100)
        starts.append(len(recs))
    lit = rng.integers(0, 256, (3, Opad), dtype=np.uint8)
    return lit, np.asarray(recs, np.int32), np.asarray(starts, np.int32)


# the records of a hostile stream: before the row, past its end, d < 1, a
# source before byte 0, padding
K2_HOSTILE = ((-5, 3, 20), (290, 2, 50), (10, 0, 5), (5, 20, 10), (0, 1, 0))


def k2_mixed_case(rng):
    """Stream 1 holds :data:`K2_HOSTILE`; streams 0, 2 and 3 hold
    well-formed records with a ``len = 0`` record among them (``Opad`` =
    301, so rows are not 16-byte aligned)."""
    lit = rng.integers(0, 256, (4, 301), dtype=np.uint8)
    good = [(4, 1, 30), (40, 3, 9), (50, 0, 0), (60, 17, 200),
            (270, 270, 31)]
    recs = good + list(K2_HOSTILE) + good[:2] + good[3:] + good
    starts = [0, 5, 10, 14, 19]
    return lit, np.asarray(recs, np.int32), np.asarray(starts, np.int32)


def k2_edge_cases(rng) -> dict:
    """``Opad`` off a multiple of 16 (rows off 16-byte alignment) with one
    stream that has no records, and a batch with no records at all."""
    lit, recs, (_, s1, s2, s3) = k2_rows_case(3, 168_003, rng)
    recs = np.concatenate([recs[:s1], recs[s2:]])
    starts = np.array([0, s1, s1, s1 + s3 - s2], np.int32)
    return {"odd_opad": (lit, recs, starts),
            "no_records": (rng.integers(0, 256, (2, 4096), dtype=np.uint8),
                           np.zeros((0, 3), np.int32),
                           np.zeros(3, np.int32))}


def png_chunk(kind: bytes, data: bytes) -> bytes:
    return (len(data).to_bytes(4, "big") + kind + data
            + zlib.crc32(kind + data).to_bytes(4, "big"))


def make_png(stream: bytes, index_blob: bytes, w: int | None = None,
             h: int | None = None) -> bytes:
    """An rgba8 PNG of ``w × h`` (default ``W × H``) holding ``stream`` in
    one IDAT and ``index_blob`` in an ``spIx`` chunk."""
    ihdr = ((w or W).to_bytes(4, "big") + (h or H).to_bytes(4, "big")
            + bytes([8, 6, 0, 0, 0]))
    return (bytes([137, 80, 78, 71, 13, 10, 26, 10]) + png_chunk(b"IHDR", ihdr)
            + png_chunk(b"IDAT", stream) + png_chunk(b"spIx", index_blob)
            + png_chunk(b"IEND", b""))


# Adam7 ((base x, base y), (stride x, stride y)), pass by pass
ADAM7 = (((0, 0), (8, 8)), ((4, 0), (8, 8)), ((0, 4), (4, 8)),
         ((2, 0), (4, 4)), ((0, 2), (2, 4)), ((1, 0), (2, 2)),
         ((0, 1), (1, 2)))


def adam7_filtered(px: np.ndarray, bpp: int) -> bytes:
    """The interlaced filtered stream of ``px`` (``(h, w, c)`` uint8): each
    Adam7 pass subsampled, filtered with :func:`filter_rows`, the passes
    concatenated (empty passes have no rows)."""
    parts = []
    for (bx, by), (sx, sy) in ADAM7:
        sub = px[by::sy, bx::sx]
        if sub.size:
            parts.append(filter_rows(sub.reshape(sub.shape[0], -1),
                                     bpp).tobytes())
    return b"".join(parts)


def plain_png(w: int, h: int, stream: bytes, color: int = 6,
              interlaced: bool = False, cgbi: bool = False,
              hint: int = 1 << 15) -> bytes:
    """An 8-bit PNG of ``w × h`` and IHDR color type ``color`` holding
    ``stream`` in IDAT chunks of ``hint`` bytes, with no ``spIx`` chunk;
    ``cgbi`` puts the iOS CgBI chunk first (the stream is then raw
    DEFLATE of bgr/bgra samples)."""
    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([8, color, 0, 0, int(interlaced)]))
    out = bytes([137, 80, 78, 71, 13, 10, 26, 10])
    if cgbi:
        out += png_chunk(b"CgBI", bytes([48, 0, 32, 2 if color == 6 else 6]))
    out += png_chunk(b"IHDR", ihdr)
    for ofs in range(0, len(stream), hint):
        out += png_chunk(b"IDAT", stream[ofs:ofs + hint])
    return out + png_chunk(b"IEND", b"")


def general_png(px: np.ndarray, config: str, hint: int = 1 << 15) -> bytes:
    """An ordinary PNG of ``px`` (``(h, w, 4)`` uint8; no ``spIx``), zlib
    -6 in IDAT chunks of ``hint`` bytes: ``rgba8`` the rows filtered with
    :func:`filter_rows`; ``adam7`` the Adam7 passes so filtered; ``cgbi``
    bgra8 rows as raw DEFLATE after the iOS CgBI chunk."""
    h, w = px.shape[:2]
    src = px[..., [2, 1, 0, 3]] if config == "cgbi" else px
    f = (adam7_filtered(src, 4) if config == "adam7"
         else filter_rows(src.reshape(h, w * 4), 4).tobytes())
    s = zlib.compress(f, 6)
    return plain_png(w, h, s[2:-4] if config == "cgbi" else s,
                     interlaced=config == "adam7", cgbi=config == "cgbi",
                     hint=hint)


@contextlib.contextmanager
def native_off():
    """The port's native host library switched off, as on a machine that
    cannot build it (the route the JAX package takes without its own)."""
    from swift_png_tpu_torch._host import native

    on = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = on


# ---- timing ---------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int) -> list[float]:
    """Host-clock times of ``fn`` ending in a device synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take (ms), and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


def probe_sample(bodies: list[bytes]) -> list:
    """The host match probe of ``run``'s spread sample of a batch."""
    from swift_png_tpu_torch.ops.inflate_checkpoint import probe_match_profile

    n = len(bodies)
    return [probe_match_profile(bodies[i])
            for i in sorted({0, n // 3, 2 * n // 3, n - 1})]


def k2_reads_previous(starts, recs) -> int:
    """Records (``len > 0``) whose sources reach the target of the record
    before them in their stream: K2's ring path runs each such record in a
    group of its own, after a barrier."""
    recs = recs.reshape(-1, 3).long()
    st = starts.long().clamp(0, recs.shape[0])
    sid = torch.searchsorted(st, torch.arange(recs.shape[0],
                                              device=recs.device),
                             right=True) - 1
    keep = (recs[:, 2] > 0) & (sid < st.numel() - 1)
    pos, d, ln = recs[keep].unbind(1)
    sid = sid[keep]
    src_end = pos - d + torch.minimum(ln, d)
    return int(((sid[1:] == sid[:-1]) & (src_end[1:] > pos[:-1])).sum())


def k2_check(name: str, args, want=None, plain: bool = True,
             all_ring: bool = False) -> dict:
    """K2 on ``args = (starts, recs, lit)`` on the card, held exactly
    against ``want`` (default: its plain version on the same inputs), each
    stream's path against ``records_well_formed``; its device time beside
    its bytes bound.  Emits one ``k2_check`` line and returns it."""
    from swift_png_tpu_torch.ops.inflate_seqcopy import (
        records_well_formed, seqcopy_cuda, seqcopy_reference)

    starts, recs, lit = args
    nb, opad = lit.shape
    paths = torch.full((nb,), -1, dtype=torch.int32, device=lit.device)
    got = seqcopy_cuda(starts, recs, lit, paths)
    torch.cuda.synchronize()
    if want is None:
        want = seqcopy_reference(*args)
    err = max_abs([(got, want)])
    ring = records_well_formed(starts, recs, opad).to(torch.int32)
    st = starts.long().clamp(0, recs.numel() // 3)
    n_rec = int((st[1:] - st[:-1]).clamp(min=0).sum())
    # lit read once, out written once, the records and starts read once
    nbytes = 2 * nb * opad + n_rec * 12 + (nb + 1) * 4
    line = dict(phase="k2_check", case=name, streams=nb, stream_bytes=opad,
                records=n_rec, reads_previous=k2_reads_previous(starts, recs),
                ring_streams=int(paths.clamp(min=0).sum()),
                paths_equal_rule=torch.equal(paths, ring), max_abs_err=err,
                ms=cuda_ms(lambda: seqcopy_cuda(*args), 10),
                plain_ms=(cuda_ms(lambda: seqcopy_reference(*args), 1)
                          if plain else None),
                bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    emit(**line)
    if err:
        fail(f"K2 differs from its plain version on {name}")
    if not line["paths_equal_rule"]:
        fail(f"K2's stream paths differ from records_well_formed on {name}: "
             f"{paths.tolist()} against {ring.tolist()}")
    if all_ring and line["ring_streams"] != nb:
        fail(f"K2 left the ring path on {name}: {paths.tolist()}")
    return line


def records_path(dev) -> dict:
    """The ``records`` configuration through :func:`decode_indexed`; then
    its stages one by one, and K2 against its plain version on the
    batch's own records, every stream on K2's ring path.  Returns K2's
    numbers for the ``kernels`` line."""
    from swift_png_tpu_torch import _kernels, decode_indexed
    from swift_png_tpu_torch._host.lz77.index import build_index
    from swift_png_tpu_torch.ops.inflate_checkpoint import (
        CheckpointInflator, adler_batch, stamp, stamp_match_total,
        tail_pointers)
    from swift_png_tpu_torch.ops.inflate_seqcopy import (
        RECORDS_SMEM_CAP, build_records, seqcopy_cuda)
    from swift_png_tpu_torch.ops.unfilter import defilter_cuda
    from swift_png_tpu_torch.parallel.batch import parse_indexed

    t0 = time.perf_counter()
    images, rows, pngs, sizes = [], [], [], []
    for i in range(B):
        px = smooth_image(i)
        f = filter_minsum(px.reshape(H, W * 4), 4)
        s = zlib.compress(f.tobytes(), 6)
        ix = build_index(s[2:-4], f.size, OB)
        if ix is None:
            fail(f"smooth stream {i} did not index")
        images.append(px)
        rows.append(f)
        sizes.append(len(s))
        pngs.append(make_png(s, ix.serialize()))
    out_size = rows[0].size
    emit(phase="match_inputs", config="records", seconds=time.perf_counter()
         - t0, streams=B, out_size=out_size, ob=OB,
         filter_types=np.bincount(np.concatenate([f[:, 0] for f in rows]),
                                  minlength=5).tolist(),
         compressed_bytes=sizes)

    _kernels.reset_launches()
    pixels = decode_indexed(pngs)
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    for name in ("decode_stamp", "seqcopy", "defilter"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the records path")
    want = torch.from_numpy(np.stack(images)).to(dev)
    if (pixels is None or pixels.shape != want.shape
            or not torch.equal(pixels, want)):
        fail("records path: decoded pixels differ from the source images")
    bodies, indexes = parse_indexed(pngs)[:2]
    eng = CheckpointInflator(dev)
    _, adler = eng.run(bodies, indexes)
    if [int(a) for a in adler] != [zlib.adler32(f.tobytes()) for f in rows]:
        fail("records path: Adler-32 differs from zlib's")
    plan = eng.last_plan
    if (plan["collapse"] is not True or plan["records_cap"] != RECORDS_SMEM_CAP
            or plan["sweep_k"] is not None):
        fail(f"records path took another plan: {plan}")
    times = host_ms(lambda: decode_indexed(pngs), REPS)

    # per-stage split: the functions the path calls, on the same batch
    st = {}
    st["parse"] = host_ms(lambda: parse_indexed(pngs), REPS)
    st["prepare"] = host_ms(lambda: eng.prepare(bodies, indexes), REPS)
    prep = eng.prepare(bodies, indexes)
    st["k1"] = host_ms(lambda: stamp(prep), REPS)
    k1_out = stamp(prep)
    prep["match_total"] = stamp_match_total(k1_out[0], prep)
    st["probe"] = host_ms(lambda: probe_sample(bodies), REPS)
    st["pointers"] = host_ms(lambda: tail_pointers(*k1_out, prep), REPS)
    litv, ptr = tail_pointers(*k1_out, prep)[:2]
    Opad = litv.shape[1]
    cap = plan["records_cap"]
    st["build_records"] = host_ms(lambda: build_records(ptr, B, Opad, cap),
                                  REPS)
    starts, recs, ovf = build_records(ptr, B, Opad, cap)
    if ovf:
        fail("records path: the batch's records overflow their cap")
    st["k2"] = host_ms(lambda: seqcopy_cuda(starts, recs, litv), REPS)
    out2 = seqcopy_cuda(starts, recs, litv)
    st["adler"] = host_ms(lambda: adler_batch(out2, out_size), REPS)
    filtered = out2[:, :out_size].reshape(B, H, 1 + W * 4)
    st["k3"] = host_ms(lambda: defilter_cuda(filtered, 4), REPS)
    line = k2_check("records_batch", (starts, recs, litv), all_ring=True)
    best = min(times)
    emit(phase="match_path", config="records", streams=B,
         out_bytes=B * out_size, ms=times, ms_min=best,
         gb_per_s=B * out_size / best / 1e6,
         stage_ms_min={k: min(v) for k, v in st.items()}, stage_ms=st,
         k2_device_ms=line["ms"], launches=launches, plan=plan,
         pixels_equal=True, adler_equal=True)

    return dict(launches=launches["seqcopy"], max_abs_err=line["max_abs_err"],
                records=line["records"], ms=line["ms"],
                plain_ms=line["plain_ms"], bytes=line["bytes"])


def sweeps_path(dev) -> None:
    """The ``sweeps`` configuration through ``inflate_zlib_batch``, then
    its stages one by one, and K2 on the batch's records (the path routes
    them to the sweeps, past the records cap) against the sweeps' output."""
    from swift_png_tpu_torch import _kernels
    from swift_png_tpu_torch._host.lz77.index import (_build_index_host,
                                                      build_index)
    from swift_png_tpu_torch.ops.inflate_checkpoint import (
        SWEEP_K, CheckpointInflator, adler_batch, expand_sweeps, stamp,
        tail_pointers, top_distances)
    from swift_png_tpu_torch.ops.inflate_seqcopy import build_records

    rows, streams = [], []
    for i in range(B):
        f = filter_rows(smooth_image(i).reshape(H, W * 4), 4)
        rows.append(f)
        streams.append(zlib.compress(f.tobytes(), 6))
    out_size = rows[0].size
    eng = CheckpointInflator(dev, ob=OB)
    _kernels.reset_launches()
    out = eng.inflate_zlib_batch(streams, out_size)
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    if launches["decode_stamp"] < 1:
        fail("kernel decode_stamp was not launched on the sweeps path")
    want = torch.from_numpy(np.stack(rows).reshape(B, -1)).to(dev)
    if out is None or not torch.equal(out, want):
        fail("sweeps path: inflated bytes differ from the filtered rows")
    plan = eng.last_plan
    if (plan["collapse"] is not True or plan["records_cap"] is not None
            or plan["sweep_k"] != SWEEP_K):
        fail(f"sweeps path took another plan: {plan}")
    times = host_ms(lambda: eng.inflate_zlib_batch(streams, out_size), REPS)

    st = {}
    bodies = [s[2:-4] for s in streams]
    st["index"] = host_ms(lambda: [build_index(b, out_size, OB)
                                   for b in bodies], REPS)
    st["index_host"] = host_ms(lambda: [_build_index_host(b, out_size, OB)
                                        for b in bodies], 1)
    indexes = [build_index(b, out_size, OB) for b in bodies]
    if any(_build_index_host(b, out_size, OB).serialize() != ix.serialize()
           for b, ix in zip(bodies[:4], indexes)):
        fail("sweeps path: the native index differs from the host walk's")
    st["prepare"] = host_ms(lambda: eng.prepare(bodies, indexes), REPS)
    prep = eng.prepare(bodies, indexes)
    st["k1"] = host_ms(lambda: stamp(prep), REPS)
    k1_out = stamp(prep)
    st["probe"] = host_ms(lambda: probe_sample(bodies), REPS)
    st["pointers"] = host_ms(lambda: tail_pointers(*k1_out, prep), REPS)
    litv, ptr = tail_pointers(*k1_out, prep)[:2]
    d16 = torch.arange(ptr.numel(), device=dev) - ptr
    st["top_distances"] = host_ms(lambda: top_distances(d16, SWEEP_K), REPS)
    st["sweeps_and_residual"] = host_ms(
        lambda: expand_sweeps(ptr, litv.reshape(-1), SWEEP_K), REPS)
    out2 = expand_sweeps(ptr, litv.reshape(-1), SWEEP_K).reshape(B, -1)
    st["adler"] = host_ms(lambda: adler_batch(out2, out_size), REPS)
    # K2 on the batch's own records, with the routing unchanged: the cap is
    # the batch's record count (a record starts at each match byte whose
    # left neighbour in its row is not a match at the same distance)
    Opad = litv.shape[1]
    d = (torch.arange(B * Opad, device=dev) - ptr[:B * Opad]).reshape(B, -1)
    head = torch.ones_like(d, dtype=torch.bool)
    head[:, 1:] = d[:, 1:] != d[:, :-1]
    n_rec = int(((d > 0) & head).sum())
    starts, recs, ovf = build_records(ptr, B, Opad, n_rec)
    if ovf or int(starts[-1]) != n_rec:
        fail("sweeps path: the records count differs from build_records'")
    k2_check("sweeps_batch", (starts, recs, litv), want=out2, plain=False,
             all_ring=True)
    best = min(times)
    emit(phase="match_path", config="sweeps", streams=B,
         out_bytes=B * out_size, compressed_bytes=[len(s) for s in streams],
         match_share=sum(ix.match_bytes for ix in indexes) / (B * out_size),
         ms=times, ms_min=best, gb_per_s=B * out_size / best / 1e6,
         stage_ms_min={k: min(v) for k, v in st.items()}, stage_ms=st,
         launches=launches, plan=plan, bytes_equal=True, trailers_checked=True)


# ---- the native host tier of the match-dominated decode ----------------------

def noisy_rows(seed: int, n: int) -> bytes:
    """``n`` bytes of noisy repeat content: 4 KB of random bytes, then
    copies of 6–40 bytes from uniform offsets in the last 32 KB, one random
    literal after each copy.  Under ``zlib.compress(…, 9)`` most bytes are
    matches whose distances spread near uniformly (``run``'s probe reads
    ``cov48`` under 0.5), the content the native host tier serves."""
    rng = np.random.default_rng(seed)
    out = bytearray(rng.integers(0, 256, 4096, np.uint8).tobytes())
    k = n // 6
    lens = rng.integers(6, 41, k).tolist()
    dists = rng.integers(41, 32769, k).tolist()
    lits = rng.integers(0, 256, k).tolist()
    for ln, d, lit in zip(lens, dists, lits):
        if len(out) >= n:
            break
        p = len(out) - min(d, len(out))
        out += out[p:p + ln]
        out.append(lit)
    return bytes(out[:n])


def host_tier_inputs(b: int, h: int, w: int):
    """The ``host_tier`` configuration's streams, each ``h·(1 + 4w)``
    bytes: ``(mixed rows, mixed streams, noisy rows, noisy streams)``.  The
    mixed batch holds noisy rows at level 9 at even indices and the
    ``records`` configuration's rows (smooth image ``i``, minimum-sum
    filter) at level 6 at odd ones; the noisy batch holds ``b`` noisy
    streams, the mixed batch's first."""
    n = h * (1 + 4 * w)
    noisy = [noisy_rows(100 + i, n) for i in range(b)]
    rows = [noisy[i // 2] if i % 2 == 0 else
            filter_minsum(smooth_image(i, h, w).reshape(h, 4 * w), 4
                          ).tobytes() for i in range(b)]
    streams = [zlib.compress(r, 9 if i % 2 == 0 else 6)
               for i, r in enumerate(rows)]
    nstreams = [streams[2 * i] if 2 * i < b else zlib.compress(r, 9)
                for i, r in enumerate(noisy)]
    return rows, streams, noisy, nstreams


def host_tier_path(dev) -> None:
    """The ``host_tier`` configuration through ``inflate_zlib_batch``: a
    mixed batch (noisy streams on the native tier, overlapped with the
    records streams on the card: K1, K2) and a batch of noisy streams
    alone (the native tier only, no kernel), both exact; then both
    batches' ``run`` with the native library and with it forced off (the
    JAX package's route without its library: every stream on the card)."""
    from swift_png_tpu_torch import _kernels
    from swift_png_tpu_torch._host.lz77.index import build_index
    from swift_png_tpu_torch.ops.inflate_checkpoint import (
        CheckpointInflator, probe_match_profile)

    t0 = time.perf_counter()
    rows, streams, noisy, nstreams = host_tier_inputs(B, H, W)
    out_size = len(rows[0])
    probes = [probe_match_profile(s[2:-4]) for s in streams[:2]]
    emit(phase="host_tier_inputs", seconds=time.perf_counter() - t0,
         streams=B, out_size=out_size,
         compressed_bytes=[len(s) for s in streams],
         probe_noisy=probes[0], probe_records=probes[1],
         est_runs_noisy_x_b=probes[0][1] * out_size // probes[0][3] * B)
    eng = CheckpointInflator(dev, ob=OB)
    hostset = list(range(0, B, 2))
    st = {}
    for name, batch, want, tier in (
            ("mixed", streams, rows, "mixed"),
            ("noisy", nstreams, noisy, "host")):
        _kernels.reset_launches()
        out = eng.inflate_zlib_batch(batch, out_size)
        torch.cuda.synchronize()
        launches = _kernels.launch_counts()
        plan = eng.last_plan
        if out is None or out.shape != (B, out_size) or out.cpu().numpy(
                ).tobytes() != b"".join(want):
            fail(f"host_tier {name}: inflated bytes differ from the rows")
        if plan["tier"] != tier or (tier == "mixed"
                                    and plan["hostset"] != hostset):
            fail(f"host_tier {name} took another plan: {plan}")
        if tier == "mixed" and (launches["decode_stamp"] < 1
                                or launches["seqcopy"] < 1):
            fail(f"host_tier mixed: K1 or K2 was not launched: {launches}")
        if tier == "host" and any(launches.values()):
            fail(f"host_tier noisy: a kernel was launched: {launches}")
        st[f"{name}_call"] = host_ms(
            lambda: eng.inflate_zlib_batch(batch, out_size), REPS)
        bodies = [s[2:-4] for s in batch]
        st[f"{name}_index"] = host_ms(
            lambda: [build_index(b, out_size, OB) for b in bodies], REPS)
        indexes = [build_index(b, out_size, OB) for b in bodies]
        st[f"{name}_run"] = host_ms(lambda: eng.run(bodies, indexes), REPS)
        # without the library: the same indexes with every stream on the
        # card (the tier alone), and the whole call once (the index walk
        # in Python too)
        with native_off():
            got, adler = eng.run(bodies, indexes)
            off_plan = eng.last_plan
            st[f"{name}_run_without_native"] = host_ms(
                lambda: eng.run(bodies, indexes), 2)
            res = []
            st[f"{name}_call_without_native"] = host_ms(
                lambda: res.append(eng.inflate_zlib_batch(batch, out_size)),
                1)
            out = res[0]
        if (got.cpu().numpy().tobytes() != b"".join(want)
                or out.cpu().numpy().tobytes() != b"".join(want)
                or [int(a) for a in adler] != [zlib.adler32(r)
                                               for r in want]):
            fail(f"host_tier {name}: the run without the native library "
                 f"differs from the rows")
        emit(phase="host_tier", batch=name, streams=B,
             out_bytes=B * out_size, plan=plan, launches=launches,
             plan_without_native=off_plan,
             ms_min={k: min(v) for k, v in st.items()
                     if k.startswith(name)},
             bytes_equal=True, trailers_checked=True)


# ---- encode: the level 8-13 batched optimal parse ---------------------------

ENC_REPS = 3            # warm timed runs of each encode stage
ENC_LEVEL = 9
# Integer operations the encode kernels need (not what their sources
# spend).  K4: per live position and menu slot, the equality compare, the
# run update and the score compare of the top-2.  K5: per edge the run's
# candidates allow (the literal edge, and lengths 3..min(run, clen - i) of
# each candidate), an add and a compare.  K6: per slot, the field decode
# (8), two table entries (2) and four placements into the 64-bit window
# (5 each).
K4_OPS_PER_SLOT = 3
K5_OPS_PER_EDGE = 2
K6_OPS_PER_TERM = 30


def encode_images(config: str, b: int, h: int, w: int) -> np.ndarray:
    if config == "photographic":
        return np.stack([bench_image(s, h, w) for s in range(b)])
    return np.stack([smooth_image(i, h, w) for i in range(b)])


def encode_plan(dev, px: np.ndarray):
    """Filter ``px`` on the card and stage the batch as ``BatchCodec.encode``
    does: ``(filtered (B, n) on the card, datas, plan)``."""
    from swift_png_tpu_torch.ops import convolve
    from swift_png_tpu_torch.parallel.batch import encode_stage

    b, h, w, _ = px.shape
    samples = torch.from_numpy(px).to(dev, torch.int32)
    filtered = encode_stage(convolve.pack_rows(samples, 8, 4, w), 4
                            ).reshape(b, -1)
    return (filtered, *stage_plan(dev, filtered, w * 4 + 1, 4))


def stage_plan(dev, filtered: torch.Tensor, pitch: int, bpp: int):
    """``BatchCodec.encode``'s staging of filtered bytes ``(B, n)`` on the
    card for the optimal parse: ``(datas, plan)``."""
    from swift_png_tpu_torch.ops import deflate_optimal as tdo

    b, n = filtered.shape
    flat = filtered.cpu().numpy()
    datas = [flat[i].tobytes() for i in range(b)]
    stride = tdo.batch_layout([n] * b)[0]
    dbuf = torch.nn.functional.pad(filtered, (0, stride - n))
    return datas, tdo._batch_inputs(datas, bpp, pitch, dev, dbuf.reshape(-1))


def optimal_stages(dev, datas: list, plan: dict, pitch: int, bpp: int,
                   level: int = ENC_LEVEL):
    """The optimal parse's stages after filtering, one by one, best of
    ``ENC_REPS`` each: ``(stage ms, info)``; ``info["assembly"]`` builds
    the device parse's streams."""
    from swift_png_tpu_torch.ops import deflate_optimal as tdo
    from swift_png_tpu_torch.ops.deflate_emit import emit_terms_batch

    st = {}
    dbuf = plan["dbuf"]
    st["plan"] = host_ms(lambda: tdo._batch_inputs(datas, bpp, pitch, dev,
                                                   dbuf), ENC_REPS)
    cargs = (plan["dists2"], plan["decades2"], dbuf, plan["nvec"])
    ckw = dict(dmax=plan["dmax"], stride=plan["stride"])
    st["k4"] = host_ms(lambda: tdo.menu_candidates_batch(*cargs, **ckw),
                       ENC_REPS)
    cand = tdo.menu_candidates_batch(*cargs, **ckw)
    dep, run, dde, iters = tdo._initial_tables(plan, level)
    for it in range(iters):
        tabs = (dep, run, dde)
        st[f"k5_iter{it + 1}"] = host_ms(lambda: tdo.optimal_parse(
            dbuf, plan["clen"], cand, *tabs, tpi=plan["TPI"]), ENC_REPS)
        terms, valid, hist = tdo.optimal_parse(dbuf, plan["clen"], cand,
                                               *tabs, tpi=plan["TPI"])
        if it + 1 < iters:
            st[f"depths_refresh{it + 1}"] = host_ms(
                lambda: tdo._device_depths_update(hist, *tabs), ENC_REPS)
            dep, run, dde = tdo._device_depths_update(hist, *tabs)
    st["hist_fetch_trees"] = host_ms(lambda: tdo._host_trees(
        hist.cpu().numpy().astype(np.int64)), ENC_REPS)
    freqs = hist.cpu().numpy().astype(np.int64)
    trees, etabs, spans = tdo._host_trees(freqs)
    route, e_terms, _, per_image = tdo.emit_input(terms, valid, freqs,
                                                  plan["TPI"])
    etabs_d = torch.from_numpy(etabs).to(dev)
    st["k6"] = host_ms(lambda: emit_terms_batch(e_terms, etabs_d, per_image),
                       ENC_REPS)
    # K6 again, with the route's compaction and the scatter pack
    pack = lambda: tdo._emit_pack(terms, valid, freqs, etabs, spans,
                                  plan["TPI"])
    st["pack"] = host_ms(pack, ENC_REPS)
    atoms_list, totals = pack()
    st["fetch"] = host_ms(lambda: tdo._fetch_bodies(atoms_list, totals),
                          ENC_REPS)
    bodies = tdo._fetch_bodies(atoms_list, totals)
    asm = lambda: [tdo._zlib_stream(d, t, *bd)
                   for d, t, bd in zip(datas, trees, bodies)]
    st["assembly"] = host_ms(asm, ENC_REPS)
    return st, dict(route=route, slots=per_image, iters=iters, assembly=asm)


def encode_kernel_checks(dev, config: str, px: np.ndarray | None,
                         timed: bool = False, plan: dict | None = None,
                         level: int = ENC_LEVEL) -> dict:
    """K4, K5 (first-iteration tables) and K6 (on the batch's pack route)
    against their plain versions on the card, on the rgba8 images ``px``
    or an already staged ``plan``; with ``timed``, their device times and
    this input's bytes and operations too."""
    from swift_png_tpu_torch.ops import deflate_optimal as tdo
    from swift_png_tpu_torch.ops.deflate_emit import (emit_terms_cuda,
                                                      emit_terms_reference)

    if plan is None:
        _, _, plan = encode_plan(dev, px)
    cargs = (plan["dists2"], plan["decades2"], plan["dbuf"], plan["nvec"])
    ckw = dict(dmax=plan["dmax"], stride=plan["stride"])
    cand = tdo.menu_candidates_cuda(*cargs, **ckw)
    tables = tdo._initial_tables(plan, level)[:3]
    torch.cuda.synchronize()
    k4_err = max_abs([(cand, tdo.menu_candidates_reference(*cargs, **ckw))])
    dargs = (plan["dbuf"], plan["clen"], cand, *tables)
    got = tdo.optimal_parse_cuda(*dargs, tpi=plan["TPI"])
    torch.cuda.synchronize()
    want = tdo.optimal_parse_reference(*dargs, tpi=plan["TPI"])
    k5_err = max_abs(zip(got, want))
    terms, valid, hist = got
    freqs = hist.cpu().numpy().astype(np.int64)
    tabs = tdo._host_trees(freqs)[1]
    route, e_terms, _, per_image = tdo.emit_input(terms, valid, freqs,
                                                  plan["TPI"])
    tabs_d = torch.from_numpy(tabs).to(dev)
    e_got = emit_terms_cuda(e_terms, tabs_d, per_image)
    torch.cuda.synchronize()
    k6_err = max_abs(zip(e_got, emit_terms_reference(e_terms, tabs_d,
                                                     per_image)))
    images = (list(px.shape[:3]) if px is not None
              else [plan["B"], max(plan["ns"])])
    out = dict(config=config, images=images, route=route,
               dmax=plan["dmax"], k4_max_abs_err=k4_err,
               k5_max_abs_err=k5_err, k6_max_abs_err=k6_err,
               terms=int(valid.sum()), match_terms=int(freqs[:, 257:286].sum()))
    emit(phase="encode_kernel_check", **out)
    if k4_err or k5_err or k6_err:
        fail(f"an encode kernel differs from its plain version on {config} "
             f"{images}")
    if not timed:
        return out
    ntot, b = plan["Ntot"], plan["B"]
    live = int(plan["clen"].long().sum())
    live_slots = int(((plan["dists2"] > 0).sum(1) * plan["nvec"]).sum())
    # the edges this run's candidates allow, position by position
    clen_p = plan["clen"].long().repeat_interleave(tdo.NB)
    i = torch.arange(ntot, device=dev) % tdo.NB
    reach = torch.minimum(cand.long() & 0x1FF, (clen_p - i)[None])
    edges = int(((reach - 2).clamp(min=0) * (i < clen_p)[None]).sum())
    n_e = e_terms.numel()
    out.update(
        k4_ms=cuda_ms(lambda: tdo.menu_candidates_cuda(*cargs, **ckw), 10),
        k4_plain_ms=cuda_ms(
            lambda: tdo.menu_candidates_reference(*cargs, **ckw), 1),
        # data is read where it is live; cand is written at every position
        k4_bytes=live + ntot * 8 + b * plan["dmax"] * 8 + b * 4,
        k4_ops=live_slots * K4_OPS_PER_SLOT,
        k5_ms=cuda_ms(lambda: tdo.optimal_parse_cuda(*dargs,
                                                     tpi=plan["TPI"]), 5),
        k5_plain_ms=cuda_ms(lambda: tdo.optimal_parse_reference(
            *dargs, tpi=plan["TPI"]), 1),
        # data and cand are read where they are live; terms and valid are
        # written at every position
        k5_bytes=live * 9 + ntot * 5 + (ntot // tdo.NB) * 4 + b * 544 * 4
        + 288 * 4 + b * 320 * 4,
        k5_edges=live + edges, k5_ops=(live + edges) * K5_OPS_PER_EDGE,
        k6_ms=cuda_ms(lambda: emit_terms_cuda(e_terms, tabs_d, per_image),
                      10),
        k6_plain_ms=cuda_ms(lambda: emit_terms_reference(e_terms, tabs_d,
                                                         per_image), 1),
        k6_bytes=n_e * 16 + b * 320 * 4, k6_ops=n_e * K6_OPS_PER_TERM)
    return out


def k5_edge_checks(dev) -> int:
    """K4 and K5 against their plain versions on inputs built for K5's
    edge cases.  To tie: the filtered bytes of four all-zero 256×256 rgba8
    images (candidates d = 1 and d = 2), and four whose bytes alternate
    with period 2 (d = 2 and d = 4); with the first iteration's generic
    tables both candidates of a position cost the same at every length, so
    each relaxation ties and the merged relax must keep candidate 0.  Large
    costs: four photographic and four smooth 256×256 images with the first
    iteration's tables × 2,000 (entries near 2^17, under the wrapper's cap
    of 2^20).  Returns K5's worst error."""
    from swift_png_tpu_torch.ops import deflate_optimal as tdo

    n = 256 * (1 + 256 * 4)
    # the generic start: no sampled statistics, so no warm tables
    with native_off():
        cases = [(name, tdo._batch_inputs([data] * 4, 4, 256 * 4 + 1, dev),
                  1) for name, data in (("all_zero", bytes(n)),
                                        ("two_period", bytes([0x21, 0x7E])
                                         * (n // 2)))]
    cases += [(f"large_tables_{config}",
               encode_plan(dev, encode_images(config, 4, 256, 256))[2], 2000)
              for config in ("photographic", "smooth")]
    worst = 0
    for name, plan, scale in cases:
        cargs = (plan["dists2"], plan["decades2"], plan["dbuf"],
                 plan["nvec"])
        ckw = dict(dmax=plan["dmax"], stride=plan["stride"])
        cand = tdo.menu_candidates_cuda(*cargs, **ckw)
        torch.cuda.synchronize()
        k4_err = max_abs([(cand, tdo.menu_candidates_reference(*cargs,
                                                               **ckw))])
        tables = [t * scale for t in tdo._initial_tables(plan, ENC_LEVEL)[:3]]
        dargs = (plan["dbuf"], plan["clen"], cand, *tables)
        got = tdo.optimal_parse_cuda(*dargs, tpi=plan["TPI"])
        torch.cuda.synchronize()
        want = tdo.optimal_parse_reference(*dargs, tpi=plan["TPI"])
        err = max_abs(zip(got, want))
        worst = max(worst, err, k4_err)
        # positions where both candidates have edges at equal decade cost
        ddep = tables[2][0].long()
        dd = [tdo._decade_of((cand[k].long() >> 9)).clamp(0, 31)
              for k in range(2)]
        both = ((cand[0] & 0x1FF) >= 3) & ((cand[1] & 0x1FF) >= 3)
        ties = int((both & (ddep[dd[0]] == ddep[dd[1]])).sum())
        emit(phase="k5_edge_check", case=name, images=4,
             bytes_per_image=int(plan["nvec"][0]), table_scale=scale,
             tie_positions=ties, terms=int(got[1].sum()),
             k4_max_abs_err=k4_err, k5_max_abs_err=err)
        if err or k4_err:
            fail(f"K4/K5 differ from their plain versions on {name}")
        # every position ties but the few before both candidates reach
        if scale == 1 and ties < 4 * n - 64:
            fail(f"{name}: only {ties} of {4 * n} positions tie")
    return worst


K4_STRIDE = 128 * 1024    # one TPU tile of positions per image


def k4_copies(n: int, menu: list, seed: int) -> np.ndarray:
    """``n`` bytes built of random bytes and copies from the menu's
    distances (3 to 300 bytes, so runs reach the 258 cap)."""
    rng = np.random.default_rng(seed)
    buf = bytearray(rng.integers(0, 256, 16, dtype=np.uint8).tobytes())
    while len(buf) < n:
        d = int(menu[rng.integers(0, len(menu))])
        ln = int(rng.integers(3, 301))
        if d <= len(buf):
            for _ in range(ln):
                buf.append(buf[len(buf) - d])
        buf += rng.integers(0, 256, int(rng.integers(1, 6)),
                            dtype=np.uint8).tobytes()
    return np.frombuffer(bytes(buf[:n]), np.uint8)


def k4_edge_cases() -> dict:
    """K4's edge cases: ``{name: (data (2·K4_STRIDE,) u8, nvec (2,), dists
    (2, dmax), costs (2, dmax))}`` int32 numpy arrays.  Every ``d % 4``
    residue and distances up to 32,768 (above 8 KB read from global
    memory), ``n`` not a multiple of 4 or 32 and an image that ends inside
    its last window, ``d >= n``, all-zero bytes (runs cut at 258), equal
    scores across slots (the first slot wins), ``dmax`` of 8, 16 and 32,
    costs outside the kernel's key range, and image 0 at the buffer's first
    byte with distances past its first positions."""
    from swift_png_tpu_torch._host.lz77.constants import DISTANCE_DECADE

    S = K4_STRIDE

    def case(images, menus, dmax, costs=None):
        data = np.zeros(2 * S, np.uint8)
        for i, img in enumerate(images):
            data[i * S:i * S + img.size] = img
        dv = np.zeros((2, dmax), np.int32)
        cv = np.zeros((2, dmax), np.int32)
        for i, m in enumerate(menus):
            dv[i, :len(m)] = m
            cv[i, :len(m)] = ([DISTANCE_DECADE[d] for d in m] if costs is None
                              else costs[:len(m)])
        return (data, np.asarray([img.size for img in images], np.int32),
                dv, cv)

    far = [1, 2, 3, 5, 6, 7, 33, 255, 1026, 4097, 8191, 16383, 16384,
           16385, 20001, 32768]
    small = [1, 2, 3, 4, 6, 8, 12, 16]
    wide = list(range(1, 25)) + [258, 1000, 2049, 4098, 9000, 16385,
                                 24577, 32768]
    return {
        "residues_far_d": case([k4_copies(100_003, far, 1),
                                k4_copies(S - 3, far, 2)], [far, far], 16),
        "d_at_least_n": case([k4_copies(5_001, small, 3),
                              k4_copies(70_017, far, 4)],
                             [small + [5_001, 7_000], far], 16),
        "all_zero": case([np.zeros(S - 1, np.uint8),
                          np.zeros(40_001, np.uint8)], [small, far], 16),
        "equal_scores": case([np.full(60_002, 7, np.uint8),
                              np.tile(np.arange(4, dtype=np.uint8), 9_000)],
                             [small, small], 8, costs=[5] * 8),
        "dmax8": case([k4_copies(33_333, small, 5),
                       k4_copies(S, small, 6)], [small, small[:5]], 8),
        "dmax32": case([k4_copies(90_001, wide, 7),
                        k4_copies(S - 31, wide, 8)], [wide, wide[::2]], 32),
        # costs outside [0, 2^16), some near the int32 ends: the kernel's
        # general top 2, with scores that wrap as the plain version's do
        "costs_outside_keys": case(
            [k4_copies(50_001, small, 9), np.zeros(S, np.uint8)],
            [small, small], 8,
            costs=[-7, 65_536, 2**31 - 1, -2**31, 200, 0, 64, 130]),
    }


def k4_edge_checks(dev) -> int:
    """K4 against its plain version on :func:`k4_edge_cases`, each case's
    bytes at another offset from 16-byte alignment.  Returns the worst
    error."""
    from swift_png_tpu_torch.ops import deflate_optimal as tdo

    worst = 0
    for k, (name, (data, nvec, dv, cv)) in enumerate(k4_edge_cases().items()):
        off = 1 + 2 * k
        flat = torch.zeros(data.size + 32, dtype=torch.uint8, device=dev)
        d = flat[off:off + data.size]
        d.copy_(torch.from_numpy(data))
        args = [torch.from_numpy(x).to(dev) for x in (dv, cv)]
        nv = torch.from_numpy(nvec).to(dev)
        kw = dict(dmax=dv.shape[1], stride=K4_STRIDE)
        got = tdo.menu_candidates_cuda(*args, d, nv, **kw)
        torch.cuda.synchronize()
        want = tdo.menu_candidates_reference(*args, d, nv, **kw)
        err = max_abs([(got, want)])
        worst = max(worst, err)
        emit(phase="k4_edge_check", case=name, dmax=dv.shape[1],
             n=nvec.tolist(), max_d=int(dv.max()),
             base_offset=d.data_ptr() % 16,
             candidates=int(((want & 0x1FF) >= 3).sum()), max_abs_err=err)
        if err:
            bad = int((got != want).any(0).nonzero()[0, 0])
            fail(f"K4 differs from its plain version on {name} at position "
                 f"{bad}: {got[:, bad].tolist()} against "
                 f"{want[:, bad].tolist()}")
    return worst


def idat_streams(pngs: list[bytes]) -> list[bytes]:
    """Each PNG's concatenated IDAT payload, read with the port's lexer;
    fails unless every PNG carries an ``spIx`` chunk."""
    from swift_png_tpu_torch._host.png import chunk as chunks

    out = []
    for data in pngs:
        src = chunks.ByteSource(data)
        src.signature()
        parts, kinds = [], []
        while not kinds or kinds[-1] != chunks.IEND:
            kind, payload = src.chunk()
            kinds.append(kind)
            if kind == chunks.IDAT:
                parts.append(payload)
        if chunks.spIx not in kinds:
            fail("an encoded PNG has no spIx chunk")
        out.append(b"".join(parts))
    return out


def encode_path(dev, config: str) -> dict:
    """``BatchCodec.encode`` at full width (B = 32 × 512×512 rgba8, level
    9, ``index=True``), checked through zlib and the port's
    ``decode_indexed``; then its stages one by one, best of ``ENC_REPS``."""
    from swift_png_tpu_torch import BatchCodec, _kernels, decode_indexed
    from swift_png_tpu_torch._host.lz77.index import (_build_index_host,
                                                      build_index)
    from swift_png_tpu_torch.ops import convolve
    from swift_png_tpu_torch.ops import deflate_optimal as tdo
    from swift_png_tpu_torch.parallel.batch import encode_stage

    px = encode_images(config, B, H, W)
    codec = BatchCodec(dev)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    pngs = codec.encode(px, level=ENC_LEVEL, kind="rgba8", index=True)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    launches = _kernels.launch_counts()
    for name in ("cand", "dp_parse", "emit"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on encode_{config}")
    filtered, datas, plan = encode_plan(dev, px)
    streams = idat_streams(pngs)
    for d, s in zip(datas, streams):
        if zlib.decompress(s) != d:
            fail(f"encode_{config}: an IDAT stream does not inflate to the "
                 f"filtered bytes")
    _kernels.reset_launches()
    pixels = decode_indexed(pngs)
    torch.cuda.synchronize()
    dec_launches = _kernels.launch_counts()
    for name in ("decode_stamp", "defilter"):
        if dec_launches[name] < 1:
            fail(f"kernel {name} was not launched on the encode_{config} "
                 f"read-back")
    if pixels is None or not torch.equal(pixels.cpu(), torch.from_numpy(px)):
        fail(f"encode_{config}: decoded pixels differ from the source")

    # the stages one by one, on the same batch
    samples = torch.from_numpy(px).to(dev, torch.int32)
    st = {"filter": host_ms(lambda: encode_stage(
        convolve.pack_rows(samples, 8, 4, W), 4), ENC_REPS),
        "fetch_filtered": host_ms(lambda: filtered.cpu().numpy(), ENC_REPS)}
    more, info = optimal_stages(dev, datas, plan, W * 4 + 1, 4)
    st.update(more)
    route, per_image, iters = info["route"], info["slots"], info["iters"]
    asm = info["assembly"]
    # the strict size policy ships a native stream where it is smaller
    # than the device parse's by its rule; every other stream is the
    # device parse's
    dev_streams = asm()
    rerouted = [i for i, (a, b) in enumerate(zip(dev_streams, streams))
                if a != b]
    if any(len(streams[i]) >= len(dev_streams[i]) for i in rerouted):
        fail(f"encode_{config}: a rerouted stream is not the smaller one")
    with ThreadPoolExecutor(max_workers=4) as pool:
        st["strict_estimate"] = host_ms(lambda: list(pool.map(
            lambda d: tdo._strict_estimate(d, ENC_LEVEL), datas)), 1)
    st["index"] = host_ms(lambda: [build_index(s[2:-4], len(d), 256)
                                   for s, d in zip(streams, datas)], 1)
    # the Python walk that the native one replaced, on a few streams
    n_host = B if config == "smooth" else 4
    pairs = list(zip(streams, datas))[:n_host]
    st["index_host"] = host_ms(lambda: [
        _build_index_host(s[2:-4], len(d), 256) for s, d in pairs], 1)
    for s, d in pairs:
        if (_build_index_host(s[2:-4], len(d), 256).serialize()
                != build_index(s[2:-4], len(d), 256).serialize()):
            fail(f"encode_{config}: the native index differs from the "
                 f"host walk's")
    sizes = [len(s) for s in streams]
    zsizes = [len(zlib.compress(d, 9)) for d in datas]
    emit(phase="encode_path", config=config, streams=B, level=ENC_LEVEL,
         in_bytes=sum(len(d) for d in datas), call_ms=call_ms,
         mb_per_s=sum(len(d) for d in datas) / call_ms / 1e3, route=route,
         emit_slots_per_image=per_image, dp_iterations=iters,
         stage_ms_min={k: min(v) for k, v in st.items()}, stage_ms=st,
         launches=launches, readback_launches=dec_launches,
         index_host_streams=n_host, strict_rerouted=rerouted,
         menu_lengths=[len(m) for m in plan["menus"]],
         compressed_bytes=sizes, zlib9_bytes=zsizes,
         ratio_vs_zlib9=sum(sizes) / sum(zsizes), streams_inflate=True,
         pixels_equal=True)
    return launches


# ---- the rest of batched encode: Adam7, indexed, shared trees, metadata ---

EG_CONFIGS = ("adam7", "indexed8", "shared")
EG_DECODED = 4          # images of each run read back through decode
SHARED_LEVEL = 6


def indexed_images(b: int, h: int, w: int):
    """``b`` bench images quantised to 256 colours (r>>5, g>>5, b>>6), each
    image's colours under its own seeded permutation of the palette, a
    seventh of the entries with alpha below 255 (so ``tRNS`` is written):
    ``(indices (b, h, w) uint8, [palette of 256 RGBA tuples])``."""
    idx, pals = [], []
    for seed in range(b):
        px = bench_image(seed, h, w).astype(np.int64)
        q = ((px[..., 0] >> 5) << 5) | ((px[..., 1] >> 5) << 2) | (
            px[..., 2] >> 6)
        perm = np.random.default_rng(1000 + seed).permutation(256)
        idx.append(perm[q].astype(np.uint8))
        pal = [None] * 256
        for c in range(256):
            alpha = 255 if c % 7 else 64 + (c * 5) % 128
            pal[perm[c]] = ((c >> 5) << 5, ((c >> 2) & 7) << 5,
                            (c & 3) << 6, alpha)
        pals.append(tuple(pal))
    return np.stack(idx), pals


def png_chunks(data: bytes) -> list:
    """``[(type, payload)]`` of one PNG, read with the port's lexer."""
    from swift_png_tpu_torch._host.png import chunk as chunks

    src = chunks.ByteSource(data)
    src.signature()
    out = []
    while not out or out[-1][0] != chunks.IEND:
        out.append(src.chunk())
    return out


def zlib9_sizes(datas: list) -> list:
    with ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(lambda d: len(zlib.compress(d, 9)), datas))


def encode_general_path(dev, config: str) -> dict:
    """``BatchCodec.encode`` of B = 32 × 512×512 images beyond the plain
    kinds: ``adam7`` (the rgba8 bench images interlaced, level 9),
    ``indexed8`` (:func:`indexed_images` through ``palettes=``, level 9,
    ``index=True``) or ``shared`` (the rgba8 bench images, level 6,
    ``shared_trees=True``).  Every stream inflates (zlib) to the port's
    filtered bytes, ``EG_DECODED`` images come back exact through
    ``BatchCodec.decode`` (all 32 through ``decode_indexed`` for
    ``indexed8``), the run's kernels launched and are held against their
    plain versions at its shapes; then its stages one by one."""
    from swift_png_tpu_torch import BatchCodec, _kernels, decode_indexed
    from swift_png_tpu_torch._host.lz77.index import build_index
    from swift_png_tpu_torch.ops import deflate_optimal as tdo
    from swift_png_tpu_torch.ops.deflate import emit_input, emit_pack_shared
    from swift_png_tpu_torch.ops.deflate_emit import (emit_terms_batch,
                                                      emit_terms_cuda,
                                                      emit_terms_reference)
    from swift_png_tpu_torch.parallel.batch import (deflate_shared_trees,
                                                    filter_batch,
                                                    shared_tokens,
                                                    shared_tree)

    t0 = time.perf_counter()
    interlaced = config == "adam7"
    if config == "indexed8":
        src, pals = indexed_images(B, H, W)
        kw = dict(level=ENC_LEVEL, kind="indexed8", palettes=pals,
                  index=True)
        want = np.stack([np.asarray(p, np.uint8)[i]
                         for i, p in zip(src, pals)])
        channels = 1
    else:
        src = want = encode_images("photographic", B, H, W)
        kw = (dict(level=ENC_LEVEL, kind="rgba8", interlaced=True)
              if interlaced else dict(level=SHARED_LEVEL, kind="rgba8",
                                      shared_trees=True))
        channels = 4
    inputs_s = time.perf_counter() - t0
    codec = BatchCodec(dev)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    pngs = codec.encode(src, **kw)
    torch.cuda.synchronize()
    call_ms = [(time.perf_counter() - t0) * 1e3]
    launches = _kernels.launch_counts()
    call_ms += host_ms(lambda: codec.encode(src, **kw), 1)
    kernels_run = ("emit",) if config == "shared" else ("cand", "dp_parse",
                                                        "emit")
    for name in kernels_run:
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on encode_general "
                 f"{config}")
    if config == "shared" and launches["emit"] != 1:
        fail(f"encode_general shared: K6 launched {launches['emit']} "
             f"times, not once for the batch")

    samples = torch.from_numpy(src).to(dev, torch.int32)
    if samples.dim() == 3:
        samples = samples[..., None]
    filtered = filter_batch(samples, 8, channels, interlaced)
    flat = filtered.cpu().numpy()
    datas = [flat[i].tobytes() for i in range(B)]
    kinds = []
    streams = []
    for png in pngs:
        chunks = png_chunks(png)
        kinds.append([k for k, _ in chunks if k != "IDAT"])
        streams.append(b"".join(p for k, p in chunks if k == "IDAT"))
    for d, s in zip(datas, streams):
        if zlib.decompress(s) != d:
            fail(f"encode_general {config}: an IDAT stream does not "
                 f"inflate to the port's filtered bytes")
    want_kinds = {"adam7": ["IHDR", "IEND"], "shared": ["IHDR", "IEND"],
                  "indexed8": ["IHDR", "PLTE", "tRNS", "spIx", "IEND"]}
    if any(k != want_kinds[config] for k in kinds):
        fail(f"encode_general {config}: chunks {kinds[0]}")
    want_t = torch.from_numpy(want).to(dev)
    _kernels.reset_launches()
    out = codec.decode(pngs[:EG_DECODED], keep_on_device=True)
    torch.cuda.synchronize()
    dec_launches = _kernels.launch_counts()
    if not torch.equal(out, want_t[:EG_DECODED]):
        fail(f"encode_general {config}: decoded pixels differ")
    line = dict(phase="encode_general", config=config, streams=B,
                level=kw["level"], in_bytes=sum(map(len, datas)),
                inputs_seconds=inputs_s, call_ms=call_ms,
                mb_per_s=sum(map(len, datas)) / min(call_ms) / 1e3,
                launches=launches, decoded_images=EG_DECODED,
                decode_launches=dec_launches, pixels_equal=True,
                streams_inflate=True, chunks=kinds[0])
    if config == "indexed8":
        _kernels.reset_launches()
        pixels = decode_indexed(pngs, device=dev)
        torch.cuda.synchronize()
        ix_launches = _kernels.launch_counts()
        for name in ("decode_stamp", "defilter"):
            if ix_launches[name] < 1:
                fail(f"kernel {name} was not launched on the indexed8 "
                     f"read-back")
        if pixels is None or not torch.equal(pixels, want_t):
            fail("encode_general indexed8: decode_indexed differs")
        line["decode_indexed_launches"] = ix_launches

    # the kernels at this run's shapes, and the stages one by one
    st = {"filter": host_ms(lambda: filter_batch(samples, 8, channels,
                                                 interlaced), ENC_REPS)}
    errs = {}
    if config == "shared":
        toks = shared_tokens(datas, SHARED_LEVEL, dev)
        tree, freq = shared_tree(toks)
        counts = [c for _, c in toks]
        rows, tabs, _, slots = emit_input([t for t, _ in toks], counts,
                                          [tree] * len(toks))
        got = emit_terms_cuda(rows, tabs, slots)
        torch.cuda.synchronize()
        errs["k6"] = max_abs(zip(got, emit_terms_reference(rows, tabs,
                                                           slots)))
        n_e = rows.numel()
        k6_bound = bound(n_e * 16 + B * 320 * 4, n_e * K6_OPS_PER_TERM)
        line["kernel_ms"] = {"k6": dict(
            ms=cuda_ms(lambda: emit_terms_cuda(rows, tabs, slots), 10),
            plain_ms=cuda_ms(lambda: emit_terms_reference(rows, tabs,
                                                          slots), 1),
            bound_ms=k6_bound[0], bound_by=k6_bound[1])}
        cpu_two = deflate_shared_trees(datas[:2], SHARED_LEVEL,
                                       device="cpu")
        if cpu_two != deflate_shared_trees(datas[:2], SHARED_LEVEL,
                                           device=dev):
            fail("encode_general shared: the card's streams of two images "
                 "differ from the CPU's")
        st["greedy_search"] = host_ms(
            lambda: shared_tokens(datas, SHARED_LEVEL, dev), 2)
        st["trees"] = host_ms(lambda: shared_tree(toks), ENC_REPS)
        st["k6"] = host_ms(lambda: emit_terms_batch(rows, tabs, slots),
                           ENC_REPS)
        pack = lambda: emit_pack_shared([t for t, _ in toks], counts, tree,
                                        freq)
        st["pack_and_fetch"] = host_ms(pack, ENC_REPS)
        bodies = pack()
        st["assembly"] = host_ms(lambda: [
            tdo._zlib_stream(d, tree, *bd) for d, bd in zip(datas, bodies)],
            ENC_REPS)
        line.update(terms=sum(counts), emit_slots_per_image=slots,
                    k6_max_abs_err=errs["k6"], cpu_two_images_equal=True)
    else:
        delay = channels        # 8-bit samples: a byte a channel
        # the JAX package's arguments: the full width's pitch for Adam7
        pitch = W * delay + 1
        plan = stage_plan(dev, filtered, pitch, delay)[1]
        chk = encode_kernel_checks(dev, f"general_{config}", None,
                                   timed=True, plan=plan)
        errs = {k: chk[f"{k}_max_abs_err"] for k in ("k4", "k5", "k6")}
        line["kernel_ms"] = {k: dict(
            ms=chk[f"{k}_ms"], plain_ms=chk[f"{k}_plain_ms"],
            **dict(zip(("bound_ms", "bound_by"), bound(
                chk[f"{k}_bytes"], chk[f"{k}_ops"]))))
            for k in ("k4", "k5", "k6")}
        more, info = optimal_stages(dev, datas, plan, pitch, delay)
        st.update(more)
        # the strict size policy ships a native stream where it is smaller
        rerouted = [i for i, (a, b) in enumerate(zip(info["assembly"](),
                                                     streams)) if a != b]
        with ThreadPoolExecutor(max_workers=4) as pool:
            st["strict_estimate"] = host_ms(lambda: list(pool.map(
                lambda d: tdo._strict_estimate(d, ENC_LEVEL), datas)), 1)
        if config == "indexed8":
            st["index"] = host_ms(lambda: [
                build_index(s[2:-4], len(d), 256)
                for s, d in zip(streams, datas)], 1)
        line.update(route=info["route"], emit_slots_per_image=info["slots"],
                    strict_rerouted=rerouted,
                    dp_iterations=info["iters"],
                    menu_lengths=[len(m) for m in plan["menus"]], **{
                        f"{k}_max_abs_err": v for k, v in errs.items()})
    sizes = [len(s) for s in streams]
    zsizes = zlib9_sizes(datas)
    line.update(stage_ms_min={k: min(v) for k, v in st.items()},
                stage_ms=st, compressed_bytes=[min(sizes), max(sizes)],
                zlib9_bytes=[min(zsizes), max(zsizes)],
                ratio_vs_zlib9=sum(sizes) / sum(zsizes))
    emit(**line)
    if any(errs.values()):
        fail(f"encode_general {config}: a kernel differs from its plain "
             f"version: {errs}")
    return dict(launches=launches, errs=errs)


def encode_metadata_case(dev) -> None:
    """B = 2 × 64×64 bgra8 with a ``Metadata`` of gAMA, pHYs, iCCP, a
    compressed iTXt and tIME through ``BatchCodec.encode`` (level 9): the
    chunks in the reference's order, the iCCP and iTXt bodies inflating
    (zlib) to their inputs, the stream to the filtered bytes."""
    from swift_png_tpu_torch import BatchCodec
    from swift_png_tpu_torch._host.png import parsing
    from swift_png_tpu_torch._host.png.metadata import Metadata
    from swift_png_tpu_torch.parallel.batch import filter_batch

    px = np.stack([bench_image(s, 64, 64) for s in range(2)])
    profile = bytes(range(256)) * 12
    text = "a compressed international text chunk, " * 20
    md = Metadata(gamma=parsing.Gamma(45455),
                  physical_dimensions=parsing.PhysicalDimensions(
                      (2835, 2835), "meter"),
                  color_profile=parsing.ColorProfile("sRGB-like", profile),
                  text=[parsing.Text(True, ("Comment", "Kommentar"), "de",
                                     text)],
                  time=parsing.TimeModified(2026, 10, 18, 12, 0, 0))
    pngs = BatchCodec(dev).encode(px, level=ENC_LEVEL, kind="bgra8",
                                  metadata=md)
    samples = torch.from_numpy(px).to(dev, torch.int32)
    flat = filter_batch(samples, 8, 4).cpu().numpy()
    order = ["CgBI", "IHDR", "gAMA", "iCCP", "pHYs", "tIME", "iTXt", "IDAT",
             "IEND"]
    for i, png in enumerate(pngs):
        chunks = png_chunks(png)
        kinds = [k for k, _ in chunks]
        if kinds != order:
            fail(f"encode_metadata: chunk order {kinds}")
        body = dict(chunks)
        if zlib.decompress(body["iCCP"][len(b"sRGB-like") + 2:]) != profile:
            fail("encode_metadata: the iCCP profile does not inflate back")
        head = b"Comment\x00\x01\x00de\x00Kommentar\x00"
        if (not body["iTXt"].startswith(head) or zlib.decompress(
                body["iTXt"][len(head):]) != text.encode()):
            fail("encode_metadata: the iTXt text does not inflate back")
        if zlib.decompress(body["IDAT"]) != flat[i].tobytes():
            fail("encode_metadata: the stream does not inflate to the "
                 "filtered bytes")
    emit(phase="encode_metadata", images=[2, 64, 64], kind="bgra8",
         chunks=order, bytes=[len(p) for p in pngs], ok=True)


SO_SEGMENTS = 16         # deflate_segmented: 16 segments of 2^21 bytes
SO_SEGMENT_BYTES = 1 << 21
SO_DECODED = 4           # images of the sharded encode read back


def scale_out_corpus(rng):
    """A mixed set of four buckets, written with this script's writers:
    rgba8 64×64 (two), rgb8 33×17, Adam7 rgba8 40×24, CgBI bgra8 16×16.
    Returns ``(PNGs, RGBA pixels)``."""
    pngs, want = [], []
    for h, w, config in ((64, 64, "rgba8"), (64, 64, "rgba8"),
                         (24, 40, "adam7"), (16, 16, "cgbi")):
        px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        pngs.append(general_png(px, config))
        want.append(px)
    px = rng.integers(0, 256, (17, 33, 3), dtype=np.uint8)
    pngs.append(plain_png(33, 17, zlib.compress(
        filter_rows(px.reshape(17, 99), 3).tobytes(), 6), color=2))
    want.append(np.concatenate([px, np.full((17, 33, 1), 255, np.uint8)],
                               axis=2))
    return pngs, want


def scale_out_path(dev) -> dict:
    """The scale-out layer on a one-rank NCCL mesh on ``cuda:0``
    (``global_mesh()``), torn down at the end.  Driven with the launch
    counts set to 0: ``deflate_segmented`` of the first 16 × 2^21 bytes of
    the 32 filtered bench images in 16 segments (K6 once), the level-9
    ``BatchCodec(mesh).encode`` of the 32 bench images (K4, K5, K6),
    ``BatchCodec(mesh).decode`` of 4 of them (K3), ``filter_select_sharded``
    on the 1 × 1 mesh at 32 × 512 × 2,048 and ``CorpusDecoder(mesh)`` on a
    mixed set of four buckets.  Each is held against the call without a
    mesh (or the source pixels), the segmented stream against ``zlib``;
    then K6 against its plain version at the segments' shape, and
    ``dryrun_multichip(1)`` in a spawned process."""
    from swift_png_tpu_torch import _kernels
    from swift_png_tpu_torch.ops.deflate import emit_input, emit_pack
    from swift_png_tpu_torch.ops.deflate_emit import (emit_terms_cuda,
                                                      emit_terms_reference)
    from swift_png_tpu_torch.ops.filter import filter_select_batch
    from swift_png_tpu_torch.parallel import (BatchCodec, CorpusDecoder,
                                              deflate_segmented,
                                              filter_select_sharded,
                                              global_mesh, segment_tokens)
    from swift_png_tpu_torch.parallel.batch import filter_batch
    from swift_png_tpu_torch.parallel.blocks import segment_trees
    from swift_png_tpu_torch.parallel.distributed import shutdown
    from swift_png_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    px = encode_images("photographic", B, H, W)
    samples = torch.from_numpy(px).to(dev, torch.int32)
    flat = filter_batch(samples, 8, 4).reshape(-1)
    n = SO_SEGMENTS * SO_SEGMENT_BYTES
    payload = flat[:n].cpu().numpy().tobytes()
    rows = torch.from_numpy(px.reshape(B, H, W * 4)).to(dev)
    corpus_pngs, corpus_want = scale_out_corpus(np.random.default_rng(14))
    inputs_s = time.perf_counter() - t0
    line = dict(phase="scale_out", ranks=1, inputs_seconds=inputs_s)
    mesh = global_mesh()
    try:
        line.update(backend=torch.distributed.get_backend(),
                    mesh=list(mesh.mesh.shape), mesh_device=mesh.device_type)
        if line["backend"] != "nccl":
            fail(f"scale_out: the mesh's group is {line['backend']}, "
                 f"not NCCL")
        codec = BatchCodec(mesh=mesh)
        ms = {}
        _kernels.reset_launches()
        t0 = time.perf_counter()
        stream = deflate_segmented(payload, 6, SO_SEGMENTS, mesh=mesh)
        ms["segmented"] = (time.perf_counter() - t0) * 1e3
        seg_launches = _kernels.launch_counts()
        t0 = time.perf_counter()
        pngs = codec.encode(px, level=ENC_LEVEL)
        ms["encode"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        decoded = codec.decode(pngs[:SO_DECODED], keep_on_device=True)
        torch.cuda.synchronize()
        ms["decode"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        refiltered = filter_select_sharded(mesh, rows, 4)
        torch.cuda.synchronize()
        ms["filter_select_sharded"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        corpus_px = CorpusDecoder(mesh=mesh).decode(corpus_pngs)
        ms["corpus"] = (time.perf_counter() - t0) * 1e3
        launches = _kernels.launch_counts()
        # the first call above also set up NCCL's communicator: once more
        t0 = time.perf_counter()
        deflate_segmented(payload, 6, SO_SEGMENTS, mesh=mesh)
        ms["segmented_warm"] = (time.perf_counter() - t0) * 1e3
    finally:
        shutdown()
    if seg_launches["emit"] != 1:
        fail(f"scale_out: deflate_segmented launched K6 "
             f"{seg_launches['emit']} times, not once")
    for name in ("defilter", "cand", "dp_parse", "emit"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on scale_out")

    # ---- the same calls without a mesh, and the sources -------------------
    if zlib.decompress(stream) != payload:
        fail("scale_out: the segmented stream does not inflate to its input")
    t0 = time.perf_counter()
    if stream != deflate_segmented(payload, 6, SO_SEGMENTS, device=dev):
        fail("scale_out: deflate_segmented over the mesh differs from "
             "mesh=None")
    ms["segmented_no_mesh"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    if pngs != BatchCodec(dev).encode(px, level=ENC_LEVEL):
        fail("scale_out: the sharded encode differs from the unsharded")
    ms["encode_no_mesh"] = (time.perf_counter() - t0) * 1e3
    if not torch.equal(decoded, torch.from_numpy(px[:SO_DECODED]).to(dev)):
        fail("scale_out: the sharded decode differs from the source")
    if not torch.equal(refiltered, filter_select_batch(rows, 4)):
        fail("scale_out: filter_select_sharded differs from "
             "filter_select_batch")
    if any(not np.array_equal(g, w) for g, w in zip(corpus_px, corpus_want)):
        fail("scale_out: CorpusDecoder's pixels differ from the source")
    t0 = time.perf_counter()
    z6 = len(zlib.compress(payload, 6))
    zlib6_ms = (time.perf_counter() - t0) * 1e3

    # ---- K6 at the segments' shape; the search apart ----------------------
    L = SO_SEGMENT_BYTES
    seg = torch.frombuffer(bytearray(payload), dtype=torch.uint8).view(
        SO_SEGMENTS, L).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    terms, _, counts = segment_tokens(seg, [L] * SO_SEGMENTS, t_cap=L,
                                      lazy=True)
    torch.cuda.synchronize()
    ms["segment_search"] = (time.perf_counter() - t0) * 1e3
    counts_h = counts.tolist()
    t0 = time.perf_counter()
    trees, freqs = segment_trees(terms.cpu().numpy(), counts_h)
    ms["segment_trees"] = (time.perf_counter() - t0) * 1e3
    ms["segment_pack"] = host_ms(lambda: emit_pack(list(terms), counts_h,
                                                   trees, freqs), 1)[0]
    k6_rows, k6_tabs, _, slots = emit_input(list(terms), counts_h, trees)
    got = emit_terms_cuda(k6_rows, k6_tabs, slots)
    torch.cuda.synchronize()
    k6_err = max_abs(zip(got, emit_terms_reference(k6_rows, k6_tabs, slots)))
    n_e = k6_rows.numel()
    k6_bound = bound(n_e * 16 + SO_SEGMENTS * 320 * 4, n_e * K6_OPS_PER_TERM)
    k6 = dict(max_abs_err=k6_err, slots=n_e,
              ms=cuda_ms(lambda: emit_terms_cuda(k6_rows, k6_tabs, slots),
                         10),
              plain_ms=cuda_ms(lambda: emit_terms_reference(
                  k6_rows, k6_tabs, slots), 1),
              bound_ms=k6_bound[0], bound_by=k6_bound[1])
    if k6_err:
        fail(f"scale_out: K6 differs from its plain version ({k6_err})")

    t0 = time.perf_counter()
    dry = dryrun_multichip(1, timeout=240)
    dry_s = time.perf_counter() - t0
    line.update(
        segmented=dict(in_bytes=n, segments=SO_SEGMENTS, segment_bytes=L,
                       out_bytes=len(stream), zlib6_bytes=z6,
                       ratio_vs_zlib6=len(stream) / z6, zlib6_ms=zlib6_ms,
                       mb_per_s=n / min(ms["segmented"],
                                        ms["segmented_warm"]) / 1e3,
                       terms=sum(counts_h), k6_launches=seg_launches["emit"],
                       launches=seg_launches),
        encode=dict(images=B, level=ENC_LEVEL, equal=True),
        decode=dict(images=SO_DECODED, pixels_equal=True),
        filter_select=dict(shape=list(rows.shape), equal=True),
        corpus=dict(images=len(corpus_pngs), buckets=4, pixels_equal=True),
        ms=ms, launches=launches, k6=k6,
        dryrun=dict(seconds=dry_s, ranks=dry))
    emit(**line)
    return dict(launches=launches, k6_err=k6_err)


def k1_args(prep: dict) -> tuple:
    """K1's inputs from a prepared batch."""
    return (prep["spans"], prep["meta"], prep["pool_t"], prep["pool_s"],
            prep["ids"], prep["kbound"])


def k1_max_code_bits(prep: dict) -> int:
    """The longest literal/length code of a prepared batch's blocks: the
    first threshold equal to the last (2^15) gives the length."""
    thr = prep["pool_t"][:, 1:16].long()
    full = (thr >= (1 << 15)).long()
    return int((16 - full.sum(1)).clamp(max=15).max())


def fifteen_bit_stream() -> bytes:
    """Fibonacci symbol counts, shuffled, compressed Huffman-only at level
    9: the rarest literals take 15-bit codes."""
    f = [1, 2]
    while len(f) < 22:
        f.append(f[-1] + f[-2])
    syms = np.repeat((np.arange(22) * 37 + 5) % 256, f)
    np.random.default_rng(7).shuffle(syms)
    co = zlib.compressobj(9, zlib.DEFLATED, 15, 9, zlib.Z_HUFFMAN_ONLY)
    return co.compress(syms.astype(np.uint8).tobytes()) + co.flush()


def k1_extra_streams(rng) -> dict:
    """K1's check cases beside the main batch: ``{name: (zlib stream,
    body to decode)}``.  ``corrupt`` decodes a body with bits flipped in
    its first dynamic block with the intact body's index."""
    photo = filter_rows(bench_image(3, 128, 128).reshape(128, 512), 4)
    good = zlib.compress(photo.tobytes(), 9)
    bad = bytearray(good[2:-4])
    for at in range(len(bad) // 4, len(bad) // 4 + 200):
        bad[at] ^= 0x5A
    out = {
        "stored": zlib.compress(rng.integers(0, 256, 150_000, np.uint8)
                                .tobytes(), 0),
        "rle_level1": zlib.compress(b"x" * 700 + b"yz" * 700 + b"x" * 5000,
                                    1),
        "fifteen_bit": fifteen_bit_stream(),
    }
    out = {k: (s, s[2:-4]) for k, s in out.items()}
    out["corrupt"] = (good, bytes(bad))
    return out


# ---- K1 on corrupt bodies: the TPU kernel's step budget ---------------------

K1C_N = 16384           # bytes each stream of the corruption batches inflates to


def k1_corrupt_streams() -> dict:
    """``{name: (data, zlib stream)}``, each of ``K1C_N`` bytes: a noisy
    sine (``single``), long runs crossing units (``crossing``), a stream of
    four dynamic blocks (``multiblock``), a stored chain with mid-unit
    header gaps (``stored``), Huffman-only literals (``huffman``) and
    back-to-back short copies at level 1 (``dense``)."""
    n = K1C_N
    rng = np.random.default_rng(0)
    y = (np.sin(np.arange(n) / 9.0) * 50 + 128).astype(np.int64)
    single = np.clip(y + rng.integers(-6, 7, n), 0, 255).astype(
        np.uint8).tobytes()
    crossing = ((b"x" * 700 + b"yz" * 700 + b"x" * 700) * 8)[:n]
    multi = (np.random.default_rng(3).integers(0, 8, n) * 31 % 251).astype(
        np.uint8).tobytes()
    co = zlib.compressobj(4)
    mb = b"".join(co.compress(multi[i:i + 4096]) + co.flush(zlib.Z_BLOCK)
                  for i in range(0, n, 4096)) + co.flush()
    stored = np.random.default_rng(4).integers(0, 256, n,
                                               dtype=np.uint8).tobytes()
    co = zlib.compressobj(0)
    chain = b"".join(co.compress(stored[i:i + 3000])
                     + co.flush(zlib.Z_FULL_FLUSH) for i in range(0, n, 3000))
    huff = np.random.default_rng(5).integers(0, 40, n).astype(
        np.uint8).tobytes()
    co_h = zlib.compressobj(9, zlib.DEFLATED, 15, 9, zlib.Z_HUFFMAN_ONLY)
    rng = np.random.default_rng(21)
    dense = bytearray(rng.integers(0, 256, 8, dtype=np.uint8).tobytes())
    while len(dense) < n:
        k = int(rng.integers(6, 12))
        back = int(rng.integers(min(k, len(dense)),
                                min(len(dense), 4096) + 1))
        dense += dense[len(dense) - back:len(dense) - back + k]
    dense = bytes(dense[:n])
    return {"single": (single, zlib.compress(single, 6)),
            "crossing": (crossing, zlib.compress(crossing, 6)),
            "multiblock": (multi, mb),
            "stored": (stored, chain + co.flush()),
            "huffman": (huff, co_h.compress(huff) + co_h.flush()),
            "dense": (dense, zlib.compress(dense, 1))}


# batches whose tiles run each step mode of the TPU kernel: (streams,
# streams the corruption picks from, the mode, seeds)
K1_CORRUPT = {"mixed": (("single", "crossing", "multiblock", "stored"), 3, 2,
                        range(40)),
              "literal": (("huffman", "stored"), 1, 1, range(8)),
              "dense": (("dense", "crossing"), 2, 0, range(8))}


def corrupt_bodies(good: list, n_pick: int, seed: int) -> list:
    """``good`` with one of its first ``n_pick`` bodies' bytes ``[at, at +
    ln)`` XORed: with 0x3C on every third seed, else a random byte each."""
    rng = np.random.default_rng(100 + seed)
    k = int(rng.integers(0, n_pick))
    body = bytearray(good[k])
    at = int(rng.integers(2, len(body) - 4))
    ln = int(rng.integers(1, 64))
    for j in range(at, min(at + ln, len(body))):
        body[j] ^= 0x3C if seed % 3 == 0 else int(rng.integers(1, 256))
    return good[:k] + [bytes(body)] + good[k + 1:]


def run_outcome(eng, bodies: list, indexes: list):
    """The error case ``run`` raises, or its bytes and Adler-32."""
    from swift_png_tpu_torch._host.lz77.errors import DecompressionError

    try:
        out, adler = eng.run(bodies, indexes)
    except DecompressionError as e:
        return e.case
    return out.cpu().numpy().tobytes(), [int(a) for a in adler]


def k1_corrupt_checks(dev) -> int:
    """K1 against its plain version on seeded corruptions of batches in
    each step mode (every output exact, the tile mode as expected), and
    ``run`` on the card against ``run`` on the CPU: the same error case,
    or the same bytes and Adler-32.  Returns K1's worst error."""
    from swift_png_tpu_torch._host.lz77.index import build_index
    from swift_png_tpu_torch.ops.inflate_checkpoint import CheckpointInflator
    from swift_png_tpu_torch.ops.inflate_stamp import (
        decode_stamp_cuda, decode_stamp_reference)

    streams = k1_corrupt_streams()
    eng, host = CheckpointInflator(dev), CheckpointInflator("cpu")
    worst = 0
    for batch, (names, n_pick, mode, seeds) in K1_CORRUPT.items():
        good = [streams[n][1][2:-4] for n in names]
        indexes = [build_index(b, K1C_N, OB) for b in good]
        if any(ix is None for ix in indexes):
            fail(f"k1_corrupt: a {batch} stream did not index")
        t0 = time.perf_counter()
        err, flagged, raised = 0, 0, 0
        for seed in seeds:
            bodies = corrupt_bodies(good, n_pick, seed)
            prep = eng.prepare(bodies, indexes)
            if set(prep["kbound"][:, 1].tolist()) != {mode}:
                fail(f"k1_corrupt: {batch} is not in mode {mode}")
            args = k1_args(prep)
            got = decode_stamp_cuda(*args, ob=OB)
            torch.cuda.synchronize()
            e = max_abs(zip(got, decode_stamp_reference(*args, ob=OB)))
            err = max(err, e)
            flagged += int(got[1].count_nonzero())
            want = run_outcome(host, bodies, indexes)
            if run_outcome(eng, bodies, indexes) != want:
                fail(f"k1_corrupt: run on the card and on the CPU differ on "
                     f"{batch} seed {seed}")
            raised += isinstance(want, str)
            if e:
                fail(f"K1 differs from its plain version on {batch} seed "
                     f"{seed}")
        emit(phase="k1_corrupt", batch=batch, mode=mode, cases=len(seeds),
             units=int(prep["spans"].shape[0]), flagged_units=flagged,
             runs_raised=raised, max_abs_err=err,
             seconds=time.perf_counter() - t0)
        if not flagged or not raised or raised == len(seeds):
            fail(f"k1_corrupt: {batch} has {flagged} flagged units and "
                 f"{raised} of {len(seeds)} runs raised: both outcomes are "
                 f"wanted")
        worst = max(worst, err)
    return worst


# K3's shapes beyond the main batch: pitches that are not multiples of 4
# or 16, one pixel group, warp edges, a second 1,024-row chunk, and base
# pointers 1..15 bytes off 16-byte alignment
# (delays 5 and 7 come from no PNG but are in the kernel's contract)
K3_ODD_PITCH = {1: 97, 2: 98, 3: 99, 4: 100, 5: 105, 6: 102, 7: 98,
                8: 104}


def k3_odd_cases(dev) -> list:
    """``(name, delay, filtered)`` on the card, each with every filter type
    (0..4 and one of 5..255) on at least one row: six images when there is
    one row.  The filtered bytes are a view of a flat buffer at the offset."""
    rng = np.random.default_rng(3)
    cases = []
    for delay, pitch in K3_ODD_PITCH.items():
        for hh, p in ((1, pitch), (31, pitch), (33, pitch), (1100, pitch),
                      (33, delay)):
            b = 6 if hh == 1 else 2
            f = rng.integers(0, 256, (b, hh, 1 + p), dtype=np.uint8)
            kind = (np.arange(b)[:, None] + np.arange(hh)[None, :]) % 6
            f[:, :, 0] = np.where(kind == 5, rng.integers(5, 256, kind.shape),
                                  kind)
            off = 1 + len(cases) % 15
            flat = torch.zeros(f.size + 16, dtype=torch.uint8, device=dev)
            t = flat[off:off + f.size].view(f.shape)
            t.copy_(torch.from_numpy(f))
            name = "one_group" if p == delay else f"pitch{p}_h{hh}"
            cases.append((name, delay, t))
    return cases


def k3_launch(kernel, h: int, delay: int) -> dict:
    """K3's launch shape for images of ``h`` rows at ``delay`` (threads and
    dynamic shared memory per block, resident warps per SM from CUDA's
    occupancy calculator) and the registers of that delay's kernel."""
    import ctypes

    fn = kernel._lib.spt_defilter_occupancy
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int(0) for _ in range(3)]
    rc = fn(h, delay, *[ctypes.byref(v) for v in vals])
    if rc != 0:
        fail(f"K3 occupancy query failed ({rc})")
    regs, entry = None, ""
    for ln in kernel.ptxas.splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "registers" in ln and f"ILi{delay}E" in entry:
            regs = ln.split("Used ")[1].split(" registers")[0]
    return dict(threads=vals[0].value, dynamic_smem_bytes=vals[1].value,
                warps_per_sm=vals[2].value,
                registers=None if regs is None else int(regs))


def inflate_trace(eng, idat: bytes, nbytes: int, fmt: str) -> dict:
    """One stream's fused inflate traced: the torch ops it dispatches per
    block, and under ``torch.profiler`` its kernels' device time and
    launches per block, the heaviest five, and the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        eng.inflate(idat, nbytes, fmt, keep_on_device=True)
    blocks = eng.last_run["blocks"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.inflate(idat, nbytes, fmt, keep_on_device=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    return dict(blocks=blocks, torch_ops_per_block=Count.n / blocks,
                kernels_per_block=sum(e.count for e in kernels) / blocks,
                device_ms=device_ms, wall_ms_traced=wall,
                top=[[e.key[:60], dev_us(e) / 1e3, e.count] for e in top])


GD_CONFIGS = ("rgba8", "adam7", "cgbi")
GD_REPS = 1             # warm timed calls of each general decode batch


def general_decode_path(dev, config: str) -> dict:
    """``BatchCodec.decode`` of B = 32 ordinary 512×512 PNGs of the bench
    recipe (:func:`general_png`; no ``spIx``): the fused inflate per image,
    K3 (once per Adam7 pass), the convolve.  Exact against the source
    pixels, K3 launched and held against its plain version at every shape
    the batch gives it; the stage split, and the lockstep
    ``InflateFusedBatch.inflate_batch`` of the same streams as a figure
    beside the path."""
    from swift_png_tpu_torch import BatchCodec, _kernels
    from swift_png_tpu_torch.ops import convolve
    from swift_png_tpu_torch.ops.deinterlace import (deinterlace_samples,
                                                     pass_geometry)
    from swift_png_tpu_torch.ops.inflate_fused import InflateFusedBatch
    from swift_png_tpu_torch.ops.unfilter import (defilter_cuda,
                                                  defilter_reference)
    from swift_png_tpu_torch.parallel.batch import _fused_engine, lex_png

    t0 = time.perf_counter()
    images = [bench_image(seed) for seed in range(DISTINCT)]
    distinct = [general_png(px, config) for px in images]
    order = [i % DISTINCT for i in range(B)]
    pngs = [distinct[i] for i in order]
    want = torch.from_numpy(np.stack([images[i] for i in order])).to(dev)
    inputs_s = time.perf_counter() - t0
    passes, interlaced_bytes = pass_geometry((W, H), 32)
    nbytes = interlaced_bytes if config == "adam7" else H * (1 + 4 * W)

    codec = BatchCodec(dev)
    _kernels.reset_launches()
    out = codec.decode(pngs, keep_on_device=True)
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    want_k3 = len(passes) if config == "adam7" else 1
    if launches["defilter"] != want_k3:
        fail(f"general_decode {config}: K3 launched "
             f"{launches['defilter']} times, not {want_k3}")
    if out.device != want.device or not torch.equal(out, want):
        fail(f"general_decode {config}: pixels differ from the source")
    times = host_ms(lambda: codec.decode(pngs, keep_on_device=True),
                    GD_REPS)

    # ---- stages: the functions the call runs, timed apart -----------------
    st = {"lexing": host_ms(lambda: [lex_png(p) for p in pngs], GD_REPS)}
    idats = [lex_png(p)[4] for p in pngs]
    eng = _fused_engine(dev)
    fmt = "ios" if config == "cgbi" else "zlib"
    # each distinct stream once (the batch repeats them)
    per_ms, blocks, retries, flats = [], [], 0, []
    for idat in idats[:DISTINCT]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flats.append(eng.inflate(idat, nbytes, fmt, keep_on_device=True))
        torch.cuda.synchronize()
        per_ms.append((time.perf_counter() - t0) * 1e3)
        blocks.append(eng.last_run["blocks"])
        retries += eng.last_run["retries"]
    flat = torch.stack([flats[i] for i in order])
    trace = inflate_trace(eng, idats[0], nbytes, fmt)
    # the device's idle share over an untraced inflate of the same stream
    trace["idle_share"] = (1 - trace["device_ms"] / per_ms[0]
                           if trace["device_ms"] else None)
    k3, k3_err = [], 0
    shapes = ([(z, off, sy, pitch + 1) for z, _, sy, pitch, off in passes]
              if config == "adam7" else [(None, 0, H, 1 + 4 * W)])
    for z, off, rows_n, pitch1 in shapes:
        f = flat[:, off:off + rows_n * pitch1].reshape(B, rows_n, pitch1)
        f = f.contiguous()
        got = defilter_cuda(f, 4)
        torch.cuda.synchronize()
        err = max_abs([(got, defilter_reference(f, 4))])
        k3_err = max(k3_err, err)
        k3.append(dict(adam7_pass=z, shape=list(f.shape), max_abs_err=err,
                       ms=cuda_ms(lambda: defilter_cuda(f, 4), 10)))
        if err:
            fail(f"general_decode {config}: K3 differs from its plain "
                 f"version at shape {list(f.shape)}")
    if config == "adam7":
        st["deinterlace"] = host_ms(lambda: deinterlace_samples(
            flat, size=(W, H), depth=8, channels=4), GD_REPS)
        samples = deinterlace_samples(flat, size=(W, H), depth=8,
                                      channels=4)
        st["convolve"] = host_ms(lambda: convolve.samples_to_rgba(
            samples, depth=8, channels=4), GD_REPS)
    else:
        rows = defilter_cuda(flat.view(B, H, 1 + 4 * W), 4)
        st["convolve"] = host_ms(lambda: convolve.unpack_rgba(
            rows, depth=8, channels=4, width=W, is_bgr=config == "cgbi"),
            GD_REPS)

    # ---- the lockstep batch inflate of the same streams (a figure) --------
    beng = InflateFusedBatch(device=dev)
    got = beng.inflate_batch(idats, nbytes, fmt)
    if not torch.equal(got, flat):
        fail(f"general_decode {config}: the batch inflate differs")
    batch_ms = host_ms(lambda: beng.inflate_batch(idats, nbytes, fmt), 2)
    best = min(times)
    emit(phase="general_decode", config=config, streams=B,
         out_bytes=B * nbytes, inputs_seconds=inputs_s, ms=times,
         ms_min=best, mb_per_s=B * nbytes / best / 1e3,
         stage_ms_min={k: min(v) for k, v in st.items()}, stage_ms=st,
         inflate=dict(ms=per_ms, ms_mean=sum(per_ms) / DISTINCT,
                      blocks=blocks, ms_per_block=sum(per_ms) / sum(blocks),
                      retries=retries,
                      compressed_bytes=[len(d) for d in idats[:DISTINCT]]),
         k3=k3, launches=launches, pixels_equal=True, trace=trace,
         batch_inflate=dict(ms=batch_ms, blocks=beng.last_run["blocks"],
                            retries=beng.last_run["retries"]))
    return dict(k3_err=k3_err, k3_launches=launches["defilter"])


# ---- the single-image API, gzip and the CLI (host_api) ---------------------

HA_KINDS = ("v1", "v2", "v4", "v8", "v16", "va8", "va16", "rgb8", "rgb16",
            "rgba8", "rgba16", "indexed1", "indexed2", "indexed4",
            "indexed8", "bgr8", "bgra8")
HA_SIZE = 128           # side of the small images of every kind
HA_GZIP_BYTES = 1 << 18


def kind_image(kind: str, seed: int):
    """``(pixels, Format)``: a ``HA_SIZE``² image of ``kind`` that the kind
    holds exactly, as RGBA (uint16 for the 16-bit kinds)."""
    from swift_png_tpu_torch.png import Format

    rng = np.random.default_rng(seed)
    n = HA_SIZE
    depth = int("".join(c for c in kind if c.isdigit()))
    if kind.startswith("indexed"):
        pal = tuple((i * 37 % 256, i * 91 % 256, i * 13 % 256,
                     255 if i > 2 else 80 * i) for i in range(1 << depth))
        return (np.array(pal, np.uint8)[rng.integers(0, len(pal), (n, n))],
                Format(kind, pal))
    dtype, top = (np.uint16, 65535) if depth == 16 else (np.uint8, 255)
    px = rng.integers(0, top + 1, (n, n, 4)).astype(dtype)
    if kind[0] == "v":
        v = rng.integers(0, 1 << depth, (n, n)) * (top // ((1 << depth) - 1))
        px[..., :3] = v[..., None]
    if not kind.startswith(("va", "rgba", "bgra")):
        px[..., 3] = top
    return px, Format(kind)


def host_api_phase(dev) -> None:
    """The single-image API against the batched codec on the card, each
    step on a line of its own with its host ms: ``decode`` (two of
    ``general_decode``'s 512×512 inputs, rgba8 and Adam7 at zlib -6,
    through ``Image.decompress_bytes`` and ``BatchCodec.decode``),
    ``encode`` (the same images through ``Image.compress_bytes(level=9)``
    on the native engine and ``BatchCodec.encode(level=9)``, each read back
    through the other path), ``kinds`` (a 128×128 image of every kind
    through the Python engine at level 6 and back), ``stream`` (one file
    through ``Context`` in 4,096-byte pieces), ``gzip`` (256 KiB through
    ``archive`` at level 6 and Python's ``gzip``, and back), ``cli`` (every
    subcommand of ``python -m swift_png_tpu_torch`` in a subprocess) and
    ``convolve`` (``samples_to_va``, ``premultiply`` and ``straighten`` at
    512×512 rgba16 on the card against the CPU).  Every check is exact."""
    import gzip
    import tempfile

    from swift_png_tpu_torch import BatchCodec, _kernels
    from swift_png_tpu_torch.lz77 import gzip as tgzip
    from swift_png_tpu_torch.ops import convolve
    from swift_png_tpu_torch.png import (ByteSource, Context, Format, Image,
                                         Layout, Metadata, parsing)

    codec = BatchCodec(dev)
    px = bench_image(0)

    def step(name: str, t0: float, **fields) -> None:
        emit(phase="host_api", step=name,
             ms=(time.perf_counter() - t0) * 1e3, **fields)

    # ---- decode parity ---------------------------------------------------
    pngs = {c: general_png(px, c) for c in ("rgba8", "adam7")}
    for config, p in pngs.items():
        t0 = time.perf_counter()
        host = Image.decompress_bytes(p).unpack_rgba8()
        host_ms_ = (time.perf_counter() - t0) * 1e3
        _kernels.reset_launches()
        t1 = time.perf_counter()
        card = codec.decode([p], keep_on_device=True)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t1) * 1e3
        launches = _kernels.launch_counts()
        if launches["defilter"] < 1:
            fail(f"host_api decode {config}: K3 was not launched")
        if not (np.array_equal(host, px)
                and np.array_equal(card[0].cpu().numpy(), host)):
            fail(f"host_api decode {config}: Image and BatchCodec differ")
        step("decode", t0, config=config, image_ms=host_ms_,
             batch_ms=card_ms, launches=launches, pixels_equal=True)

    # ---- encode parity, each read back through the other path -------------
    for config in ("rgba8", "adam7"):
        interlaced = config == "adam7"
        t0 = time.perf_counter()
        single = Image.pack(px, Layout(Format("rgba8"), interlaced)
                            ).compress_bytes(level=9, engine="native")
        single_ms = (time.perf_counter() - t0) * 1e3
        _kernels.reset_launches()
        t1 = time.perf_counter()
        batch = codec.encode(px[None], level=9, interlaced=interlaced)[0]
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t1) * 1e3
        launches = _kernels.launch_counts()
        for name in ("cand", "dp_parse", "emit"):
            if launches[name] < 1:
                fail(f"host_api encode {config}: {name} was not launched")
        back_batch = codec.decode([single], keep_on_device=True)
        back_single = Image.decompress_bytes(batch).unpack_rgba8()
        if not (np.array_equal(back_batch[0].cpu().numpy(), px)
                and np.array_equal(back_single, px)):
            fail(f"host_api encode {config}: a read-back differs")
        step("encode", t0, config=config, image_ms=single_ms,
             batch_ms=batch_ms, image_bytes=len(single),
             batch_bytes=len(batch), launches=launches,
             read_back_equal=True)

    # ---- every kind through the Python engine, and a streamed file --------
    t0 = time.perf_counter()
    sizes = {}
    for i, kind in enumerate(HA_KINDS):
        kpx, fmt = kind_image(kind, i)
        blob = Image.pack(kpx, Layout(fmt, i % 2 == 1)).compress_bytes(
            level=6, engine="python")
        img = Image.decompress_bytes(blob)
        got = (img.unpack_rgba16() if kpx.dtype == np.uint16
               else img.unpack_rgba8())
        if not np.array_equal(got, kpx):
            fail(f"host_api kinds: {kind} does not come back")
        sizes[kind] = len(blob)
    step("kinds", t0, size=HA_SIZE, engine="python", level=6,
         bytes=sizes, interlaced=list(HA_KINDS[1::2]))

    t0 = time.perf_counter()
    rgba, fmt = kind_image("rgba8", 0)
    blob = Image.pack(rgba, Layout(fmt)).compress_bytes(level=6)
    src = ByteSource(blob)
    src.signature()
    _, ihdr = src.chunk()
    header = parsing.Header.parse(ihdr, "common")
    ctx = Context("common", header, None, None, None, Metadata())
    idat = b""
    while True:
        kind_, data = src.chunk()
        if kind_ != "IDAT":
            break
        idat += data
    for at in range(0, len(idat), 4096):
        ctx.push_data(idat[at:at + 4096])
    ctx.push_ancillary(kind_, data)
    if not np.array_equal(ctx.image.unpack_rgba8(), rgba):
        fail("host_api stream: the streamed image differs")
    step("stream", t0, pieces=-(-len(idat) // 4096), idat_bytes=len(idat))

    # ---- gzip both ways ----------------------------------------------------
    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9)))
             for _ in range(200)]
    text = b" ".join(words[i] for i in rng.integers(0, 200, HA_GZIP_BYTES
                                                     // 4))[:HA_GZIP_BYTES]
    t0 = time.perf_counter()
    ours = tgzip.archive(text, level=6)
    archive_ms = (time.perf_counter() - t0) * 1e3
    theirs = gzip.compress(text, 6)
    t1 = time.perf_counter()
    back = tgzip.extract(theirs)
    extract_ms = (time.perf_counter() - t1) * 1e3
    if gzip.decompress(ours) != text or back != text:
        fail("host_api gzip: a member does not come back")
    step("gzip", t0, bytes=len(text), level=6, archive_ms=archive_ms,
         extract_ms=extract_ms, archive_bytes=len(ours),
         python_gzip_bytes=len(theirs))

    # ---- the CLI in subprocesses -------------------------------------------
    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "f.png"), "wb") as f:
            f.write(blob)
        with open(os.path.join(tmp, "text.txt"), "wb") as f:
            f.write(text[:1 << 14])
        with open(os.path.join(tmp, "python.gz"), "wb") as f:
            f.write(gzip.compress(text[:1 << 14], 6))
        cli = sys.executable, "-m", "swift_png_tpu_torch"
        # each command reads only the inputs above: all run at once
        argvs = [("inspect", "f.png"), ("decode", "f.png", "out.rgba"),
                 ("recode", "f.png", "re.png", "--level", "9", "--index"),
                 ("index", "f.png", "ix.png"),
                 ("gzip", "text.txt", "--level", "6"),
                 ("gunzip", "python.gz", "back.txt")]
        procs = [(a, subprocess.Popen(cli + a, cwd=tmp, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
                 for a in argvs]
        out = {}
        try:
            for a, p in procs:
                so, se = p.communicate(timeout=180)
                if p.returncode != 0:
                    fail(f"host_api cli {a[0]}: exit {p.returncode}: {se}")
                out[a[0]] = so
        finally:
            for _, p in procs:
                p.kill()
                p.wait()

        def read(name):
            with open(os.path.join(tmp, name), "rb") as f:
                return f.read()

        checks = {
            "inspect": (f"PNG image {HA_SIZE}×{HA_SIZE} (rgba8)"
                        in out["inspect"]),
            "decode": read("out.rgba") == rgba.tobytes(),
            "recode": b"spIx" in read("re.png") and np.array_equal(
                Image.decompress_bytes(read("re.png")).unpack_rgba8(), rgba),
            "index": b"spIx" in read("ix.png") and np.array_equal(
                Image.decompress_bytes(read("ix.png")).unpack_rgba8(), rgba),
            "gzip": gzip.decompress(read("text.txt.gz")) == text[:1 << 14],
            "gunzip": read("back.txt") == text[:1 << 14]}
    for name, ok in checks.items():
        if not ok:
            fail(f"host_api cli {name}: wrong output")
    step("cli", t0, commands=list(checks), stdout={k: v.strip()
                                                   for k, v in out.items()})

    # ---- the convolve twins on the card -------------------------------------
    t0 = time.perf_counter()
    raw = torch.from_numpy(np.random.default_rng(6).integers(
        0, 1 << 16, (1, H, W, 4)).astype(np.int32))
    rgb = raw[..., :3].to(torch.uint16)
    alpha = raw[..., 3:].expand_as(raw[..., :3]).to(torch.uint16)
    card_ms = {}
    for name, fn, args in (
            ("samples_to_va", lambda r: convolve.samples_to_va(
                r, depth=16, channels=4, bits=16), (raw,)),
            ("premultiply", convolve.premultiply, (rgb, alpha)),
            ("straighten", convolve.straighten, (rgb, alpha))):
        want = fn(*args)
        on_card = [a.to(dev) for a in args]
        card_ms[name] = min(host_ms(lambda: fn(*on_card), 3))
        got = fn(*on_card)
        if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
            fail(f"host_api convolve: {name} on the card differs")
    step("convolve", t0, shape=[1, H, W, 4], kind="rgba16",
         card_ms=card_ms, equal=True)


EX_IMAGES = 8           # bench images decoded by batch_decode_cuda
EX_HOST_SIZE = 128      # side of the image the host examples read
EX_HOST = {             # each host example's arguments, in the phase's dir
    "basic_encoding": ["basic"], "custom_color": ["in.png", "value.png"],
    "decode_basic": ["in.png"], "gzip_tool": ["c", "in.png", "in.png.gz"],
    "image_metadata": ["in.png", "metadata.png"],
    "indexing": ["in.png", "indexed.png"],
    "iphone_optimized": ["in.png", "ios"], "online_decoding": ["in.png"],
    "streaming_zlib": ["in.png"]}


def examples_phase(dev) -> dict:
    """The port's copies of the JAX package's examples
    (``swift_png_tpu_torch.examples``).  First the two device examples run
    in this process with no device named, each with the launch counts set
    to 0 just before it: ``indexed_decode.main()`` (``decode_indexed`` of
    four 64×64 indexed PNGs: K1, the tail, K3) and ``batch_decode_cuda.
    main`` on 8 of the bench images at 512×512 as ordinary PNGs
    (``CorpusDecoder`` over a one-rank NCCL mesh from ``global_mesh()``,
    torn down after: the fused inflate, K3).  Every decoded image must
    equal its source.  Then the nine host examples start at once, each as
    ``python -m swift_png_tpu_torch.examples.<name>`` on a 128×128 bench
    image, and must exit cleanly (gzip_tool's archive is read back with
    Python's ``gzip``)."""
    import gzip
    import importlib
    import tempfile

    from swift_png_tpu_torch import _kernels
    from swift_png_tpu_torch.parallel.distributed import shutdown
    from swift_png_tpu_torch.png import Image

    t_phase = time.perf_counter()
    line = dict(phase="examples")
    ex = {name: importlib.import_module(f"swift_png_tpu_torch.examples.{name}")
          for name in ("indexed_decode", "batch_decode_cuda")}
    ms, launches = {}, {}
    _kernels.reset_launches()
    t0 = time.perf_counter()
    files, got = ex["indexed_decode"].main()
    ms["indexed_decode"] = (time.perf_counter() - t0) * 1e3
    launches["indexed_decode"] = _kernels.launch_counts()
    want = [Image.decompress_bytes(f).unpack_rgba8() for f in files]
    if not np.array_equal(got, np.stack(want)):
        fail("examples: indexed_decode's pixels differ")

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    with tempfile.TemporaryDirectory() as tmp:
        images = [bench_image(s) for s in range(EX_IMAGES)]
        paths = [os.path.join(tmp, f"bench{s}.png") for s in range(EX_IMAGES)]
        for path, px in zip(paths, images):
            with open(path, "wb") as f:
                f.write(general_png(px, "rgba8"))
        _kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            decoded = ex["batch_decode_cuda"].main(paths)
            ms["batch_decode_cuda"] = (time.perf_counter() - t0) * 1e3
            launches["batch_decode_cuda"] = _kernels.launch_counts()
            line.update(backend=torch.distributed.get_backend())
        finally:
            shutdown()
        if line["backend"] != "nccl":
            fail(f"examples: batch_decode_cuda's group is "
                 f"{line['backend']}, not NCCL")
        if len(decoded) != EX_IMAGES or any(
                not np.array_equal(g, w) for g, w in zip(decoded, images)):
            fail("examples: batch_decode_cuda's pixels differ from the "
                 "source")

        with open(os.path.join(tmp, "in.png"), "wb") as f:
            f.write(general_png(bench_image(0, EX_HOST_SIZE, EX_HOST_SIZE),
                                "rgba8"))
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", f"swift_png_tpu_torch.examples.{name}",
             *args], cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for name, args in EX_HOST.items()}
        try:
            for name, p in procs.items():
                _, err = p.communicate(timeout=600)
                if p.returncode != 0:
                    fail(f"examples: {name} exited {p.returncode}: {err}")
        finally:
            for p in procs.values():
                p.kill()
                p.wait()
        ms["host_examples"] = (time.perf_counter() - t0) * 1e3
        with open(os.path.join(tmp, "in.png"), "rb") as f, \
                open(os.path.join(tmp, "in.png.gz"), "rb") as g:
            if gzip.decompress(g.read()) != f.read():
                fail("examples: gzip_tool's archive does not read back")
    for name, kernels in (("indexed_decode", ("decode_stamp", "defilter")),
                          ("batch_decode_cuda", ("defilter",))):
        for k in kernels:
            if launches[name][k] < 1:
                fail(f"kernel {k} was not launched by the {name} example")
    line.update(ms=ms, launches=launches, host_examples=list(EX_HOST),
                images={"indexed_decode": list(got.shape),
                        "batch_decode_cuda": [EX_IMAGES, H, W, 4]},
                pixels_equal=True,
                phase_ms=(time.perf_counter() - t_phase) * 1e3)
    emit(**line)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from swift_png_tpu_torch import _kernels, decode_indexed
    from swift_png_tpu_torch._host import native
    from swift_png_tpu_torch._host.lz77.index import build_index
    from swift_png_tpu_torch.ops import convolve
    from swift_png_tpu_torch.ops.inflate_checkpoint import (
        CheckpointInflator, inflate_tail)
    from swift_png_tpu_torch.ops.inflate_stamp import (
        decode_stamp_cuda, decode_stamp_reference)
    from swift_png_tpu_torch.ops.unfilter import (
        defilter_cuda, defilter_reference)
    from swift_png_tpu_torch.parallel.batch import parse_indexed

    card = nvidia_smi()
    dev = torch.device("cuda")
    emit(phase="card", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # the native host library builds (g++) while the kernels do (nvcc)
    existed = os.path.exists(native._LIB_PATH)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(lambda: (native.available(),
                                   time.perf_counter() - t0))
        kernels = _kernels.build()
        regs = {k.name: [ln.strip() for ln in k.ptxas.splitlines()
                         if "registers" in ln] for k in kernels.values()}
        emit(phase="build", seconds=time.perf_counter() - t0,
             per_kernel={k.name: k.build_seconds for k in kernels.values()},
             ptxas=regs)
        ok, native_s = fut.result()
    emit(phase="native", available=ok, path=native._LIB_PATH,
         built=not existed, seconds=native_s, error=native.last_error())
    if not ok:
        fail(f"the native host library is not available: "
             f"{native.last_error()}")

    # ---- inputs ---------------------------------------------------------
    t0 = time.perf_counter()
    images, filtered, streams, pngs, indexes = [], [], [], [], []
    for seed in range(DISTINCT):
        px = bench_image(seed)
        f = filter_rows(px.reshape(H, W * 4), 4)
        s = zlib.compress(f.tobytes(), 6)
        ix = build_index(s[2:-4], f.size, OB)
        if ix is None:
            fail(f"stream {seed} did not index")
        images.append(px)
        filtered.append(f)
        streams.append(s)
        indexes.append(ix)
        pngs.append(make_png(s, ix.serialize()))
    order = [i % DISTINCT for i in range(B)]
    batch = [pngs[i] for i in order]
    out_size = indexes[0].out_size
    emit(phase="inputs", seconds=time.perf_counter() - t0, streams=B,
         distinct=DISTINCT, out_size=out_size, ob=OB,
         units=B * indexes[0].units,
         blocks=[ix.n_blocks for ix in indexes],
         match_share=sum(ix.match_bytes for ix in indexes)
         / (DISTINCT * out_size),
         compressed_bytes=[len(s) for s in streams])

    # ---- K1 against its plain version -------------------------------------
    eng = CheckpointInflator(dev)
    bodies = [streams[i][2:-4] for i in order]
    prep = eng.prepare(bodies, [indexes[i] for i in order])
    rng = np.random.default_rng(1)
    k1_cases = {"main": prep}
    for name, (s, body) in k1_extra_streams(rng).items():
        raw = zlib.decompress(s)
        ix = build_index(s[2:-4], len(raw), OB)
        if ix is None:
            fail(f"{name} stream did not index")
        k1_cases[name] = eng.prepare([body], [ix])
    k1_err = 0
    for name, p in k1_cases.items():
        args = k1_args(p)
        got = decode_stamp_cuda(*args, ob=OB)
        torch.cuda.synchronize()
        want = decode_stamp_reference(*args, ob=OB)
        err = max_abs(zip(got, want))
        k1_err = max(k1_err, err)
        if name == "main":
            # literal tokens are one byte each and never straddle a unit
            owned = (torch.arange(OB, device=dev)
                     < p["meta"][:, 2:3].long())
            literals = int((owned & (got[0] < 0) & (got[0] != -32768))
                           .sum())
        emit(phase="k1_check", case=name, units=int(p["spans"].shape[0]),
             multiblock=p["multiblock"], stored=p["has_stored"],
             blocks=int(p["pool_t"].shape[0]),
             max_lit_code_bits=k1_max_code_bits(p), max_abs_err=err,
             flags=int(got[1].count_nonzero()))
        if err:
            fail(f"K1 differs from its plain version on {name}")
        # a corrupt unit may decode on to its tile's budget and cover its
        # bytes (k1_corrupt_checks holds flagged cases)
        if name != "corrupt" and got[1].count_nonzero():
            fail(f"K1 flags on {name}: {int(got[1].count_nonzero())}")
        if name == "fifteen_bit" and k1_max_code_bits(p) != 15:
            fail("the fifteen_bit stream has no 15-bit literal code")
    k1_err = max(k1_err, k1_corrupt_checks(dev))
    args = k1_args(prep)
    k1_ms = cuda_ms(lambda: decode_stamp_cuda(*args, ob=OB), 10)
    k1_plain_ms = cuda_ms(lambda: decode_stamp_reference(*args,
                                                                ob=OB), 1)
    U = int(prep["spans"].shape[0])
    # every input read once (the table pool once, not per unit) and every
    # output written once
    k1_bytes = (sum(t.numel() * t.element_size() for t in args)
                + U * OB * 4 + U * (4 + 8 + 8))
    # the tokens this run's units decode, by kind: a unit decodes at most
    # one boundary EOB, and only where it has a jump
    tokens = sum(int(indexes[i].n_tokens.sum()) for i in order)
    eobs = (int((prep["meta"][:, 3] > 0).sum()) if prep["multiblock"]
            else 0)
    matches = tokens - literals - eobs
    out_bytes = B * out_size
    k1_ops = (literals * (OPS_PER_CODE + OPS_PER_ADLER_BYTE)
              + matches * 2 * (OPS_PER_CODE + OPS_PER_EXTRA)
              + eobs * OPS_PER_CODE + out_bytes * OPS_PER_STAMP_BYTE)

    # ---- K3 against its plain version -------------------------------------
    k3_err = 0
    for delay in (1, 2, 3, 4, 6, 8):
        # one image taller than a 1024-thread block runs K3's row chunks
        hh, pitch = (1100, 64) if delay == 4 else (300, 96 // delay * delay)
        f = torch.from_numpy(rng.integers(0, 256, (3, hh, 1 + pitch),
                                          np.uint8)).to(dev)
        f[:, :, 0] = torch.from_numpy(rng.integers(0, 8, (3, hh), np.uint8)
                                      ).to(dev)
        got = defilter_cuda(f, delay)
        torch.cuda.synchronize()
        err = max_abs([(got, defilter_reference(f, delay))])
        k3_err = max(k3_err, err)
        emit(phase="k3_check", delay=delay, shape=list(f.shape),
             max_abs_err=err)
        if err:
            fail(f"K3 differs from its plain version at delay {delay}")
    main_f = torch.from_numpy(np.stack([filtered[i] for i in order])).to(dev)
    flat = torch.zeros(main_f.numel() + 16, dtype=torch.uint8, device=dev)
    main_odd = flat[1:1 + main_f.numel()].view(main_f.shape)
    main_odd.copy_(main_f)
    for name, delay, f in (k3_odd_cases(dev)
                           + [("main", 4, main_f), ("main_offset1", 4,
                                                    main_odd)]):
        got = defilter_cuda(f, delay)
        torch.cuda.synchronize()
        err = max_abs([(got, defilter_reference(f, delay))])
        k3_err = max(k3_err, err)
        emit(phase="k3_check", case=name, delay=delay, shape=list(f.shape),
             base_offset=f.data_ptr() % 16, max_abs_err=err)
        if err:
            fail(f"K3 differs from its plain version on {name} at delay "
                 f"{delay}")
    emit(phase="k3_launch", **k3_launch(kernels["defilter"], H, 4))
    k3_ms = cuda_ms(lambda: defilter_cuda(main_f, 4), 10)
    k3_plain_ms = cuda_ms(lambda: defilter_reference(main_f, 4), 1)
    k3_bytes = main_f.numel() * 2 - B * H
    ftype = main_f[:, :, 0].long().clamp(max=5)
    per_row = torch.tensor(K3_OPS_BY_TYPE + K3_OPS_BY_TYPE[:1],
                           device=dev)[ftype]
    k3_ops = int(per_row.sum()) * (main_f.shape[2] - 1)

    # ---- K2 against its plain version: K2′'s recipe, row crossings, -------
    # records longer than the ring, more records than one staged batch, a
    # run of len = 0 records, a hostile stream among well-formed ones, rows
    # off 16-byte alignment, a stream and a batch without records
    k2_recipes = {
        "exp_random_d": k2_case(4, 1100, 8208, rng),
        "exp_smooth": k2_case(4, 1100, 8208, rng, smooth=True),
        "row_crossing": k2_rows_case(4, 1 << 20, rng),
        "long": k2_long_case(1 << 20, 600_000, rng),
        "many": k2_many_case(3000, rng),
        "noop_runs": k2_noop_case(rng),
        "mixed": k2_mixed_case(rng),
        **k2_edge_cases(rng)}
    k2_err = 0
    for name, (lit, recs, starts) in k2_recipes.items():
        line = k2_check(name, tuple(torch.from_numpy(x).to(dev)
                                    for x in (starts, recs, lit)),
                        all_ring=name != "mixed")
        k2_err = max(k2_err, line["max_abs_err"])
        if name == "mixed" and line["ring_streams"] != 3:
            fail("K2's mixed case: not exactly one stream off the ring")

    # ---- the main path -----------------------------------------------------
    _kernels.reset_launches()
    pixels = decode_indexed(batch)
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    for name in ("decode_stamp", "defilter"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the main path")
    want = torch.from_numpy(np.stack([images[i] for i in order])).to(dev)
    if (pixels is None or pixels.shape != want.shape
            or not torch.equal(pixels, want)):
        fail("decoded pixels differ from the source images")
    _, adler = eng.run(bodies, [indexes[i] for i in order])
    want_adler = [zlib.adler32(filtered[i].tobytes()) for i in order]
    if [int(a) for a in adler] != want_adler:
        fail("Adler-32 differs from zlib's")
    times = host_ms(lambda: decode_indexed(batch), REPS)

    # per-stage split: the same functions the main path calls
    st = {}
    st["parse"] = host_ms(lambda: parse_indexed(batch), REPS)
    parsed = parse_indexed(batch)
    st["prepare"] = host_ms(lambda: eng.prepare(parsed[0], parsed[1]),
                            REPS)
    st["k1"] = host_ms(lambda: decode_stamp_cuda(*args, ob=OB), REPS)
    k1_out = decode_stamp_cuda(*args, ob=OB)
    st["tail_expansion"] = host_ms(lambda: inflate_tail(*k1_out, prep),
                                   REPS)
    st["k3"] = host_ms(lambda: defilter_cuda(main_f, 4), REPS)
    rows = defilter_cuda(main_f, 4)
    st["convolve"] = host_ms(lambda: convolve.unpack_rgba(
        rows, depth=8, channels=4, width=W), REPS)
    best = min(times)
    emit(phase="main_path", card=card, streams=B, out_bytes=B * out_size,
         ms=times, ms_min=best, gb_per_s=B * out_size / best / 1e6,
         stage_ms_min={k: min(v) for k, v in st.items()},
         stage_ms=st, launches=launches, pixels_equal=True,
         adler_equal=True)

    k2 = records_path(dev)
    k2_err = max(k2_err, k2["max_abs_err"])
    sweeps_path(dev)
    host_tier_path(dev)
    for config in GD_CONFIGS:
        k3_err = max(k3_err, general_decode_path(dev, config)["k3_err"])

    # ---- encode: K4, K5, K6 against their plain versions, then the path ----
    checks = [encode_kernel_checks(dev, config, encode_images(config, 4, 256,
                                                              256))
              for config in ("photographic", "smooth")]
    edge_err = k5_edge_checks(dev)
    k4_edge_err = k4_edge_checks(dev)
    enc_launches = encode_path(dev, "photographic")
    encode_path(dev, "smooth")
    enc = encode_kernel_checks(dev, "photographic",
                               encode_images("photographic", B, H, W),
                               timed=True)
    enc_smooth = encode_kernel_checks(dev, "smooth",
                                      encode_images("smooth", B, H, W),
                                      timed=True)
    checks += [enc, enc_smooth]
    general = {config: encode_general_path(dev, config)
               for config in EG_CONFIGS}
    encode_metadata_case(dev)
    scale = scale_out_path(dev)
    host_api_phase(dev)
    ex_launches = examples_phase(dev)
    enc_err = {k: max([c[f"{k}_max_abs_err"] for c in checks]
                      + [g["errs"].get(k, 0) for g in general.values()])
               for k in ("k4", "k5", "k6")}
    enc_err["k6"] = max(enc_err["k6"], scale["k6_err"])
    enc_err["k5"] = max(enc_err["k5"], edge_err)
    enc_err["k4"] = max(enc_err["k4"], k4_edge_err)
    b_smooth = bound(enc_smooth["k5_bytes"], enc_smooth["k5_ops"])
    emit(phase="k5_smooth", ms=enc_smooth["k5_ms"],
         plain_ms=enc_smooth["k5_plain_ms"], bound_ms=b_smooth[0],
         bound_by=b_smooth[1], edges=enc_smooth["k5_edges"])
    b_smooth4 = bound(enc_smooth["k4_bytes"], enc_smooth["k4_ops"])
    emit(phase="k4_smooth", ms=enc_smooth["k4_ms"],
         plain_ms=enc_smooth["k4_plain_ms"], bound_ms=b_smooth4[0],
         bound_by=b_smooth4[1])
    emit(phase="warps_per_sm",
         **{name: kernels[name].resident_warps()
            for name in ("decode_stamp", "seqcopy", "dp_parse", "cand")})
    emit(phase="bounds", k1_tokens=tokens, k1_literals=literals,
         k1_matches=matches, k1_eobs=eobs, k1_bytes=k1_bytes, k1_ops=k1_ops,
         k3_bytes=k3_bytes, k3_ops=k3_ops, k2_records=k2["records"],
         k2_bytes=k2["bytes"],
         **{k: enc[k] for k in ("k4_bytes", "k4_ops", "k5_bytes", "k5_edges",
                                "k5_ops", "k6_bytes", "k6_ops")},
         hbm_bytes_per_s=HBM_BYTES_PER_S, int_ops_per_s=INT_OPS_PER_S)
    encode_kernels = []
    for k, name, line in (
            ("k4", "cand", "swift_png_tpu/ops/deflate_optimal.py:243"),
            ("k5", "dp_parse", "swift_png_tpu/ops/deflate_optimal.py:573"),
            ("k6", "emit", "swift_png_tpu/ops/deflate_emit.py:44")):
        b_ms, b_by = bound(enc[f"{k}_bytes"], enc[f"{k}_ops"])
        encode_kernels.append(dict(
            name=name, route="cuda",
            source=f"swift_png_tpu_torch/csrc/{name}.cu", replaces=line,
            launches=enc_launches[name],
            launches_by_path={"encode_photographic": enc_launches[name],
                              **{f"encode_general_{c}": g["launches"][name]
                                 for c, g in general.items()},
                              "scale_out": scale["launches"][name]},
            max_abs_err=enc_err[k],
            ms=enc[f"{k}_ms"], plain_ms=enc[f"{k}_plain_ms"], bound_ms=b_ms,
            bound_by=b_by, library_ms=None))

    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k3_bound, k3_by = bound(k3_bytes, k3_ops)
    emit(kernels=[
        dict(name="decode_stamp", route="cuda",
             source="swift_png_tpu_torch/csrc/inflate_stamp.cu",
             replaces="swift_png_tpu/ops/inflate_pallas.py:130",
             launches=launches["decode_stamp"],
             launches_by_path={"main_path": launches["decode_stamp"],
                               "scale_out":
                                   scale["launches"]["decode_stamp"],
                               "examples": ex_launches["indexed_decode"][
                                   "decode_stamp"]},
             max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound,
             bound_by=k1_by, library_ms=None),
        dict(name="defilter", route="cuda",
             source="swift_png_tpu_torch/csrc/defilter.cu",
             replaces="swift_png_tpu/ops/unfilter_pallas.py:39",
             launches=launches["defilter"],
             launches_by_path={"main_path": launches["defilter"],
                               "scale_out": scale["launches"]["defilter"],
                               "examples": sum(
                                   c["defilter"]
                                   for c in ex_launches.values())},
             max_abs_err=k3_err,
             ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound,
             bound_by=k3_by, library_ms=None),
        # K2 copies bytes and computes one index per byte: bytes bound it
        dict(name="seqcopy", route="cuda",
             source="swift_png_tpu_torch/csrc/seqcopy.cu",
             replaces="swift_png_tpu/ops/inflate_seqcopy.py:158, "
                      "tools/exp_seqcopy.py:39",
             launches=k2["launches"],
             launches_by_path={"records": k2["launches"],
                               "scale_out": scale["launches"]["seqcopy"],
                               "examples": ex_launches["indexed_decode"][
                                   "seqcopy"]},
             max_abs_err=k2_err, ms=k2["ms"],
             plain_ms=k2["plain_ms"],
             bound_ms=k2["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None),
        *encode_kernels,
    ])
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
