#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``swift_png_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``swift_png_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, then drives the
port's main path — batched indexed PNG decode, :func:`decode_indexed` — at
the bench size (B = 32 streams of 512×512 rgba8, ob = 256) and checks the
pixels and the Adler-32 checksums against the source.  Every phase prints
one JSON line; the second-to-last line is ``nvidia-smi``'s card name and
power limit and the last line is ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before that line.  Without a CUDA device it exits
non-zero at once.  It imports nothing of JAX or of ``swift_png_tpu``.
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


def png_chunk(kind: bytes, data: bytes) -> bytes:
    return (len(data).to_bytes(4, "big") + kind + data
            + zlib.crc32(kind + data).to_bytes(4, "big"))


def make_png(stream: bytes, index_blob: bytes) -> bytes:
    ihdr = W.to_bytes(4, "big") + H.to_bytes(4, "big") + bytes([8, 6, 0, 0,
                                                               0])
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
    emit(phase="bounds", k1_tokens=tokens, k1_literals=literals,
         k1_matches=matches, k1_eobs=eobs, k1_bytes=k1_bytes, k1_ops=k1_ops,
         k3_bytes=k3_bytes, k3_ops=k3_ops, hbm_bytes_per_s=HBM_BYTES_PER_S,
         int_ops_per_s=INT_OPS_PER_S)

    # ---- the main path -----------------------------------------------------
    _kernels.reset_launches()
    pixels = decode_indexed(batch)
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    for name, n in launches.items():
        if n < 1:
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
    ])
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
