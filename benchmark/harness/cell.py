"""One run of one cell: set-up, the measured window, the check against the
reference, and the metrics.

The window is a closed loop with one client: the cell's entry is called on
the same batch back to back, each call ending when its device work has
ended, until ``seconds`` have passed; the window closes with the call that
passes them.  Rates are taken over every call and the whole window.  The
answers of a sample of the calls, drawn from the seed, are kept and judged
by the reference once the window has closed and the program's state is
freed.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from . import corpus, host, trace
from .spec import Spec


@dataclass
class Run:
    """What a metric's reader sees of a run."""

    config: dict
    traffic: dict
    batch: int
    raw_bytes: int              # RGBA8 bytes of one batch, B*H*W*4
    setup_s: float
    window_s: float
    calls: int                  # calls made in the window
    completed: int              # calls that returned
    out_bytes: int              # bytes of output the calls returned, where
                                # the entry returns files
    batch_s: list               # seconds of each call of the window
    call_peak_bytes: int | None  # the most device memory a call of the
                                 # window held above what it found held
    inputs: dict                # facts of the inputs (compressed sizes)
    spans: "trace.Spans | None" = None
    window_batches: list = field(default_factory=list)
    trace: dict | None = None   # the profiled stretch (trace.reduce_events)

    def span_ms_per_batch(self, name: str) -> float | None:
        """Mean milliseconds of span ``name`` in each call of the window."""
        if self.spans is None or not self.window_batches:
            return None
        per = self.spans.per_batch(name, self.window_batches)
        return None if per is None else 1e3 * statistics.fmean(per)

    def kernel(self, needle: str):
        """``(launches, seconds)`` of the device kernels whose name holds
        ``needle`` in the profiled stretch, or ``None`` without a trace."""
        if self.trace is None:
            return None
        hits = [v for k, v in self.trace["kernels"].items() if needle in k]
        return (sum(h[0] for h in hits), sum(h[1] for h in hits))


class Reservoir:
    """A uniform sample of at most ``k`` of the offered items, drawn by
    ``rng`` (algorithm R)."""

    def __init__(self, k: int, rng):
        self.k, self.rng = k, rng
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = item


def check_traffic(name: str, traffic: dict) -> None:
    """Refuse a traffic mix that asks for a loop :func:`run_cell` does not
    drive: it drives one closed-loop client, so ``loop`` must be
    ``closed`` and ``clients`` 1."""
    loop, clients = traffic.get("loop"), traffic.get("clients")
    if loop != "closed" or clients != 1:
        raise ValueError(f"traffic {name}: loop {loop!r} with clients "
                         f"{clients!r}; the harness drives one closed-loop "
                         "client (loop 'closed', clients 1)")


def _log(**fields) -> None:
    import json
    print(json.dumps(fields), file=sys.stderr, flush=True)


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             traced: bool, *, device: str | None = None,
             t_start: float | None = None, overrides: dict | None = None,
             log=_log) -> dict:
    """Run ``workload`` once and return its result (the keys of the printed
    line, ``checks`` last).  ``device`` defaults to ``cuda``; ``overrides``
    (``{"config": {...}, "traffic": {...}}``) shrink a cell for the tests
    on the CPU."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    cell = spec.workload(workload)
    cfg = {**spec.config(cell["config"]), **overrides.get("config", {})}
    traffic = {**spec.traffic(cell["traffic"]),
               **overrides.get("traffic", {})}
    corpus.check_config(cfg)
    check_traffic(cell["traffic"], traffic)
    op = spec.op(traffic["op"])
    metrics = spec.metrics(workload, traced)
    readers = {m["name"]: spec.reader(m["name"]) for m in metrics}
    dev = torch.device(device or "cuda")
    B, H, W = traffic["batch"], cfg["height"], cfg["width"]
    setup = {"imports": time.perf_counter() - t_start}

    # ---- set-up: kernels, the native library, inputs, one warm call ------
    from swift_png_tpu_torch import _kernels
    from swift_png_tpu_torch._host import native
    t = time.perf_counter()
    if dev.type == "cuda":
        _kernels.build()
    setup["kernels"] = time.perf_counter() - t
    setup["kernels_built"] = {k: v.build_seconds
                              for k, v in _kernels.KERNELS.items()
                              if v.build_seconds is not None}
    t = time.perf_counter()
    setup["native_available"] = native.available()
    setup["native"] = time.perf_counter() - t
    t = time.perf_counter()
    pixels = corpus.make_images(spec.content(cfg["content"]), seed, B, H, W)
    files = (corpus.make_files(pixels, cfg["writer"])
             if op.INPUT == "files" else None)
    inputs, facts = op.prepare(pixels, files, traffic, dev)
    setup["inputs"] = time.perf_counter() - t
    entry = op.entry(dev, traffic)

    def once():
        result = entry(inputs)
        op.finish(result)
        return result

    _kernels.reset_launches()
    t = time.perf_counter()
    route = op.warm(once)
    setup["warm"] = time.perf_counter() - t
    route["launches_warm_call"] = _kernels.launch_counts()
    if traced:
        trace.warm_profiler(dev)
    setup_s = time.perf_counter() - t_start
    log(phase="setup", workload=workload, seed=seed, setup_s=setup_s,
        **setup)

    # ---- the window ------------------------------------------------------
    segment = (trace.Segment(traffic["profile"], B) if traced else None)
    spans = trace.Spans(segment) if traced else None
    targets: dict = {}
    for name in readers:
        for span, tgts in getattr(readers[name], "SPANS", {}).items():
            targets.setdefault(span, [])
            targets[span] += [t for t in tgts if t not in targets[span]]
    call = spans.wrap("batch", once) if traced else once
    keep = Reservoir(traffic["check_batches"],
                     np.random.default_rng([seed, 1]))
    batch_s: dict = {}
    failed = out_bytes = i = 0
    cuda = dev.type == "cuda"
    memory_peak = call_peak = 0
    _kernels.reset_launches()
    with (trace.Hooks(spans, targets) if traced
          else contextlib.nullcontext()):
        cpu0 = host.cpu_seconds()
        t0 = te = time.perf_counter()
        while True:
            if traced:
                spans.batch = i
            if cuda:  # each call's own peak, and the process's kept whole
                memory_peak = max(memory_peak,
                                  torch.cuda.max_memory_allocated(dev))
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
            tb = time.perf_counter()
            try:
                result = call()
            except Exception:  # a failed call is counted and the loop goes on
                failed += 1
                result = None
                if failed == 1:
                    traceback.print_exc(file=sys.stderr)
            te = time.perf_counter()
            if cuda:
                call_peak = max(call_peak,
                                torch.cuda.max_memory_allocated(dev) - held)
            if result is not None:
                batch_s[i] = te - tb
                out_bytes += op.out_bytes(result)
                keep.offer(result)
            result = None
            i += 1
            if te - t0 >= seconds:
                break
        window_s = te - t0
        cpu_s = host.cpu_seconds() - cpu0
        launches = _kernels.launch_counts()
        if traced:
            segment.run(call, spans, i)
    if cuda:
        memory_peak = max(memory_peak, torch.cuda.max_memory_allocated(dev))
    window_batches = sorted(batch_s)
    run = Run(config=cfg, traffic=traffic, batch=B, raw_bytes=B * H * W * 4,
              setup_s=setup_s, window_s=window_s, calls=i,
              completed=len(batch_s), out_bytes=out_bytes,
              batch_s=[batch_s[b] for b in window_batches],
              call_peak_bytes=call_peak if cuda else None,
              inputs=facts, spans=spans, window_batches=window_batches,
              trace=segment.reduce() if traced else None)
    log(phase="window", workload=workload, calls=i, failed=failed,
        window_s=window_s, call_ms=[1e3 * s for s in run.batch_s[:20]],
        call_ms_by_tenth=[1e3 * statistics.fmean(part) for part in
                          np.array_split(run.batch_s, 10) if len(part)],
        launches_per_call={k: v / max(i, 1) for k, v in launches.items()},
        **route)
    host_readings = {"cpu_per_window_s": cpu_s / window_s,
                     "probe_ms": host.probe()}
    log(phase="host", **host_readings)
    if run.trace is not None:
        log(phase="trace", images=run.trace["images"],
            launches=sum(n for n, _ in run.trace["kernels"].values()),
            launches_by_span=run.trace["launches_by_span"])

    # ---- the check, after the program's state is freed -------------------
    kept = [op.to_host(r) for r in keep.items]
    del keep, entry, inputs, once, call
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = dict(failed_calls=failed,
                  **op.check(kept, pixels, traffic,
                             np.random.default_rng([seed, 2])))
    correct = bool(kept) and all(v <= 0 for v in checks.values())

    out_metrics = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
             "kind": (torch.cuda.get_device_name(dev) if cuda
                      else "cpu"),
             "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": i, "failed": failed,
              "metrics": out_metrics, "device": dinfo}
    if traced and run.trace is not None:
        dinfo["busy_s"] = run.trace["busy_s"]
        dinfo["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["setup"] = setup
    result["route"] = route
    result["host"] = host_readings
    result["checks"] = {k: {"value": v, "limit": 0}
                        for k, v in checks.items()}
    return result

