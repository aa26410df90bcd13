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
  the trailer checks).

Each path checks its output against the source and zlib's Adler-32, and
each kernel of a path must have launched while the path ran.  Every phase
prints one JSON line; the line before the last is ``nvidia-smi``'s card
name and power limit and the last line is ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero before that line.  Without a CUDA
device it exits non-zero at once.  It imports nothing of JAX or of
``swift_png_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zlib

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

def bench_image(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = (128 + 60 * np.sin(x / 37.0 + seed) + 50 * np.cos(y / 23.0)
            )[..., None] + np.array([0, 30, -20, 0])[None, None, :]
    noise = rng.normal(0, 12, (H, W, 4))
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
    and reaching over several rows."""
    lit = rng.integers(0, 256, (B, Opad), dtype=np.uint8)
    recs, starts = [], [0]
    dists = (1, 3, 129, 200, 1000, 4097, 32768)
    for b in range(B):
        pos = 40_000
        k = 0
        while pos + 2000 < Opad:
            pos = (pos // 128 + 1) * 128 - int(rng.integers(1, 9))
            ln = int(rng.integers(130, 1500))
            recs.append((pos, dists[k % len(dists)], ln))
            pos += ln + int(rng.integers(0, 300))
            k += 1
        starts.append(len(recs))
    return lit, np.asarray(recs, np.int32), np.asarray(starts, np.int32)


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


def max_abs(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


def probe_sample(bodies: list[bytes]) -> list:
    """The host match probe of ``run``'s spread sample of a batch."""
    from swift_png_tpu_torch.ops.inflate_checkpoint import probe_match_profile

    n = len(bodies)
    return [probe_match_profile(bodies[i])
            for i in sorted({0, n // 3, 2 * n // 3, n - 1})]


def records_path(dev) -> dict:
    """The ``records`` configuration through :func:`decode_indexed`; then
    its stages one by one, and K2 against its plain version on the
    batch's own records.  Returns K2's numbers for the ``kernels`` line."""
    from swift_png_tpu_torch import _kernels, decode_indexed
    from swift_png_tpu_torch._host.lz77.index import build_index
    from swift_png_tpu_torch.ops.inflate_checkpoint import (
        CheckpointInflator, adler_batch, stamp, stamp_match_total,
        tail_pointers)
    from swift_png_tpu_torch.ops.inflate_seqcopy import (
        RECORDS_SMEM_CAP, build_records, seqcopy_cuda, seqcopy_reference)
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
    k2_ms = cuda_ms(lambda: seqcopy_cuda(starts, recs, litv), 10)
    best = min(times)
    emit(phase="match_path", config="records", streams=B,
         out_bytes=B * out_size, ms=times, ms_min=best,
         gb_per_s=B * out_size / best / 1e6,
         stage_ms_min={k: min(v) for k, v in st.items()}, stage_ms=st,
         k2_device_ms=k2_ms, launches=launches, plan=plan,
         pixels_equal=True, adler_equal=True)

    torch.cuda.synchronize()
    err = max_abs([(out2, seqcopy_reference(starts, recs, litv))])
    n_rec = int(starts[-1])
    emit(phase="k2_check", case="records_batch", streams=B,
         stream_bytes=Opad, records=n_rec, max_abs_err=err)
    if err:
        fail("K2 differs from its plain version on the records batch")
    return dict(
        launches=launches["seqcopy"], max_abs_err=err, records=n_rec,
        ms=k2_ms,
        plain_ms=cuda_ms(lambda: seqcopy_reference(starts, recs, litv), 1),
        # lit read once, out written once, the records and starts read once
        bytes=2 * B * Opad + n_rec * 12 + (B + 1) * 4)


def sweeps_path(dev) -> None:
    """The ``sweeps`` configuration through ``inflate_zlib_batch``, then
    its stages one by one."""
    from swift_png_tpu_torch import _kernels
    from swift_png_tpu_torch._host.lz77.index import build_index
    from swift_png_tpu_torch.ops.inflate_checkpoint import (
        SWEEP_K, CheckpointInflator, adler_batch, expand_sweeps, stamp,
        tail_pointers, top_distances)

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
                                   for b in bodies], 1)
    indexes = [build_index(b, out_size, OB) for b in bodies]
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
    best = min(times)
    emit(phase="match_path", config="sweeps", streams=B,
         out_bytes=B * out_size, compressed_bytes=[len(s) for s in streams],
         match_share=sum(ix.match_bytes for ix in indexes) / (B * out_size),
         ms=times, ms_min=best, gb_per_s=B * out_size / best / 1e6,
         stage_ms_min={k: min(v) for k, v in st.items()}, stage_ms=st,
         launches=launches, plan=plan, bytes_equal=True, trailers_checked=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from swift_png_tpu_torch import _kernels, decode_indexed
    from swift_png_tpu_torch._host.lz77.index import build_index
    from swift_png_tpu_torch.ops import convolve
    from swift_png_tpu_torch.ops.inflate_checkpoint import (
        CheckpointInflator, inflate_tail)
    from swift_png_tpu_torch.ops.inflate_seqcopy import (
        seqcopy_cuda, seqcopy_reference)
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

    t0 = time.perf_counter()
    kernels = _kernels.build()
    regs = {k.name: [ln.strip() for ln in k.ptxas.splitlines()
                     if "registers" in ln] for k in kernels.values()}
    emit(phase="build", seconds=time.perf_counter() - t0,
         per_kernel={k.name: k.build_seconds for k in kernels.values()},
         ptxas=regs)

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
    extra = {
        "stored": zlib.compress(rng.integers(0, 256, 150_000, np.uint8)
                                .tobytes(), 0),
        "rle_level1": zlib.compress(b"x" * 700 + b"yz" * 700 + b"x" * 5000,
                                    1),
    }
    k1_cases = {"main": prep}
    for name, s in extra.items():
        raw = zlib.decompress(s)
        ix = build_index(s[2:-4], len(raw), OB)
        if ix is None:
            fail(f"{name} stream did not index")
        k1_cases[name] = eng.prepare([s[2:-4]], [ix])
    k1_err = 0
    for name, p in k1_cases.items():
        args = (p["spans"], p["meta"], p["tabs"], p["symtab"], p["kbound"])
        got = decode_stamp_cuda(*args, ob=OB)
        torch.cuda.synchronize()
        want = decode_stamp_reference(*args, ob=OB)
        owned = (torch.arange(OB, device=dev)
                 < p["meta"][:, 2:3].long())
        pairs = [(got[0][owned], want[0][owned])] + list(zip(got[1:],
                                                             want[1:]))
        err = max_abs(pairs)
        k1_err = max(k1_err, err)
        if name == "main":
            # literal tokens are one byte each and never straddle a unit
            literals = int((owned & (got[0] < 0) & (got[0] != -32768))
                           .sum())
        emit(phase="k1_check", case=name, units=int(p["spans"].shape[0]),
             multiblock=p["multiblock"], stored=p["has_stored"],
             max_abs_err=err, flags=int(got[1].count_nonzero()))
        if err:
            fail(f"K1 differs from its plain version on {name}")
    args = (prep["spans"], prep["meta"], prep["tabs"], prep["symtab"],
            prep["kbound"])
    k1_ms = cuda_ms(lambda: decode_stamp_cuda(*args, ob=OB), 10)
    k1_plain_ms = cuda_ms(lambda: decode_stamp_reference(*args,
                                                                ob=OB), 1)
    U = int(prep["spans"].shape[0])
    k1_bytes = (sum(t.numel() * t.element_size() for t in args)
                + U * OB * 4 + U * (4 + 8 + 8))
    # the tokens this run's units decode, by kind: a unit decodes at most
    # one boundary EOB, and only where it has a jump
    tokens = int(prep["kbound"].long().sum())
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
    got = defilter_cuda(main_f, 4)
    torch.cuda.synchronize()
    err = max_abs([(got, defilter_reference(main_f, 4))])
    k3_err = max(k3_err, err)
    emit(phase="k3_check", delay=4, shape=list(main_f.shape),
         max_abs_err=err)
    if err:
        fail("K3 differs from its plain version on the main batch")
    k3_ms = cuda_ms(lambda: defilter_cuda(main_f, 4), 10)
    k3_plain_ms = cuda_ms(lambda: defilter_reference(main_f, 4), 1)
    k3_bytes = main_f.numel() * 2 - B * H
    ftype = main_f[:, :, 0].long().clamp(max=5)
    per_row = torch.tensor(K3_OPS_BY_TYPE + K3_OPS_BY_TYPE[:1],
                           device=dev)[ftype]
    k3_ops = int(per_row.sum()) * (main_f.shape[2] - 1)

    # ---- K2 against its plain version on K2′'s recipe and row crossings ----
    k2_err = 0
    for name, (lit, recs, starts) in {
            "exp_random_d": k2_case(4, 1100, 8208, rng),
            "exp_smooth": k2_case(4, 1100, 8208, rng, smooth=True),
            "row_crossing": k2_rows_case(4, 1 << 20, rng)}.items():
        k2_args = [torch.from_numpy(x).to(dev) for x in (starts, recs, lit)]
        got = seqcopy_cuda(*k2_args)
        torch.cuda.synchronize()
        err = max_abs([(got, seqcopy_reference(*k2_args))])
        k2_err = max(k2_err, err)
        case_bytes = 2 * lit.size + recs.size * 4 + starts.size * 4
        emit(phase="k2_check", case=name, streams=lit.shape[0],
             stream_bytes=lit.shape[1], records=int(recs.shape[0]),
             max_abs_err=err,
             ms=cuda_ms(lambda: seqcopy_cuda(*k2_args), 10),
             plain_ms=cuda_ms(lambda: seqcopy_reference(*k2_args), 1),
             bytes=case_bytes,
             bound_ms=case_bytes / HBM_BYTES_PER_S * 1e3)
        if err:
            fail(f"K2 differs from its plain version on {name}")

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
    emit(phase="bounds", k1_tokens=tokens, k1_literals=literals,
         k1_matches=matches, k1_eobs=eobs, k1_bytes=k1_bytes, k1_ops=k1_ops,
         k3_bytes=k3_bytes, k3_ops=k3_ops, k2_records=k2["records"],
         k2_bytes=k2["bytes"], hbm_bytes_per_s=HBM_BYTES_PER_S,
         int_ops_per_s=INT_OPS_PER_S)

    emit(kernels=[
        dict(name="decode_stamp", route="cuda",
             source="swift_png_tpu_torch/csrc/inflate_stamp.cu",
             replaces="swift_png_tpu/ops/inflate_pallas.py:130",
             launches=launches["decode_stamp"], max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms,
             bound_ms=max(k1_bytes / HBM_BYTES_PER_S,
                          k1_ops / INT_OPS_PER_S) * 1e3,
             bound_by=("bytes" if k1_bytes / HBM_BYTES_PER_S
                       >= k1_ops / INT_OPS_PER_S else "operations"),
             library_ms=None),
        dict(name="defilter", route="cuda",
             source="swift_png_tpu_torch/csrc/defilter.cu",
             replaces="swift_png_tpu/ops/unfilter_pallas.py:39",
             launches=launches["defilter"], max_abs_err=k3_err,
             ms=k3_ms, plain_ms=k3_plain_ms,
             bound_ms=max(k3_bytes / HBM_BYTES_PER_S,
                          k3_ops / INT_OPS_PER_S) * 1e3,
             bound_by=("bytes" if k3_bytes / HBM_BYTES_PER_S
                       >= k3_ops / INT_OPS_PER_S else "operations"),
             library_ms=None),
        # K2 copies bytes and computes one index per byte: bytes bound it
        dict(name="seqcopy", route="cuda",
             source="swift_png_tpu_torch/csrc/seqcopy.cu",
             replaces="swift_png_tpu/ops/inflate_seqcopy.py:158, "
                      "tools/exp_seqcopy.py:39",
             launches=k2["launches"], max_abs_err=k2_err, ms=k2["ms"],
             plain_ms=k2["plain_ms"],
             bound_ms=k2["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None),
    ])
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
