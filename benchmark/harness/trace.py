"""Tracing of a run (``--trace 1``): host spans around the calls into the
port's layers, and one stretch of the window under ``torch.profiler``.

Spans are recorded from the benchmark's side: a named callable of the port
(``module:function`` or ``module:Class.method``) is replaced, for the window
only, by a wrapper that reads the host clock around each call.  A call
nested in one of the same span is not counted again.  While the profiler
runs, each span is also a ``record_function`` annotation, so that the
trace can say what the host was doing in each stretch where the device sat
idle.
"""

from __future__ import annotations

import contextlib
import functools
import bisect
import importlib
import json
import os
import tempfile
import time
from collections import defaultdict

from . import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "bench::"
SEGMENT = "segment"


def resolve(target: str):
    """``(owner, attribute)`` of ``module:name`` or ``module:Class.name``."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    if not hasattr(owner, attr):
        raise AttributeError(f"{target}: no such callable")
    return owner, attr


class Spans:
    """Host spans of a window: ``(name, batch, start, end)`` in seconds of
    ``time.perf_counter``."""

    def __init__(self, segment: "Segment | None" = None):
        self.events: list = []
        self.batch = -1
        self.segment = segment
        self._depth: dict = defaultdict(int)

    def wrap(self, name: str, fn):
        spans = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if spans._depth[name]:
                return fn(*args, **kwargs)
            seg = spans.segment
            if seg is not None:
                seg.before_call(name)
            note = (seg.annotate(name) if seg is not None and seg.on
                    else contextlib.nullcontext())
            spans._depth[name] += 1
            t0 = time.perf_counter()
            try:
                with note:
                    return fn(*args, **kwargs)
            finally:
                spans.events.append((name, spans.batch, t0,
                                     time.perf_counter()))
                spans._depth[name] -= 1
        return wrapper

    def per_batch(self, name: str, batches) -> list | None:
        """Seconds of span ``name`` summed in each of ``batches``, or
        ``None`` when it was never called."""
        if not any(ev[0] == name for ev in self.events):
            return None
        sums = dict.fromkeys(batches, 0.0)
        for n, b, t0, t1 in self.events:
            if n == name and b in sums:
                sums[b] += t1 - t0
        return [sums[b] for b in batches]


class Hooks:
    """Replace each target of ``targets`` (span name → list of callables)
    by a span wrapper while the context is open."""

    def __init__(self, spans: Spans, targets: dict):
        self.spans = spans
        self.targets = targets
        self._saved: list = []

    def __enter__(self):
        for name, tgts in self.targets.items():
            for target in tgts:
                owner, attr = resolve(target)
                orig = getattr(owner, attr)
                self._saved.append((owner, attr, orig))
                setattr(owner, attr, self.spans.wrap(name, orig))
        return self

    def __exit__(self, *exc):
        while self._saved:
            owner, attr, orig = self._saved.pop()
            setattr(owner, attr, orig)
        return False


class Segment:
    """The stretch under ``torch.profiler``: calls made after the window
    closes, so that the profiler, which slows every launch while it is
    attached and for a while after, touches none of the window's calls.
    The traffic's ``profile`` says how much: ``{"batches": n}`` profiles
    ``n`` whole calls; ``{"span": name, "skip_calls": k}`` (a call too long
    to trace whole, whose span ``name`` runs once per image) starts at the
    ``k+1``-th call of span ``name`` in one call and ends with that call,
    and counts the span's calls it holds as its images."""

    def __init__(self, spec: dict, images_per_batch: int):
        self.spec = spec
        self.per_batch = images_per_batch
        self.armed = self.on = self.done = False
        self._calls = 0
        self._seen = 0          # whole calls, or the span's calls, profiled
        self._prof = self._note = None
        self.path = None

    def run(self, call, spans: "Spans", first: int) -> None:
        """Make the profiled calls, numbered from batch ``first`` on."""
        self.armed = True
        for j in range(self.spec.get("batches", 1)):
            spans.batch = first + j
            if "batches" in self.spec and not self.on:
                self._start()
            call()
            if "batches" in self.spec and self.on:
                self._seen += 1
        self.stop()

    def before_call(self, name: str) -> None:
        if (not self.armed or self.done
                or self.spec.get("span") != name):
            return
        if not self.on and self._calls == self.spec["skip_calls"]:
            self._start()
        if self.on:
            self._seen += 1
        self._calls += 1

    def annotate(self, name: str):
        import torch
        return torch.autograd.profiler.record_function(PREFIX + name)

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._note = self.annotate(SEGMENT)
        self._note.__enter__()
        self.on = True

    def stop(self) -> None:
        """End the profiled stretch and write its trace to a temporary
        file (under ``TMPDIR``)."""
        if not self.on:
            return
        self._note.__exit__(None, None, None)
        self._prof.stop()
        self.on, self.done = False, True
        fd, self.path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self._prof.export_chrome_trace(self.path)
        self._prof = None

    def reduce(self) -> dict | None:
        """The profiled stretch's reduction (:func:`reduce_events`); the
        trace file is deleted."""
        if self.path is None:
            return None
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(self.path)
            self.path = None
        out = reduce_events(events)
        if out is not None:
            out["images"] = (self._seen * self.per_batch
                             if "batches" in self.spec else self._seen)
        return out


def warm_profiler(device) -> None:
    """Start and stop the profiler once on a trivial op, so that its first
    start, which loads the device tracer and takes seconds, falls in the
    set-up and not in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        (torch.zeros(8, device=device) + 1).sum().item()


def short(name: str, n: int = 100) -> str:
    """A device op's name without a leading ``void``, at most ``n``
    letters."""
    name = name.removeprefix("void ").strip()
    return (name or "(unnamed)")[:n]


def reduce_events(events: list) -> dict | None:
    """Reduce chrome-trace ``events`` (``ph == "X"``, microseconds) to the
    stretch inside the ``bench::segment`` annotation: ``window_s``, the
    device's ``busy_s`` (the union of its kernels, copies and fills),
    ``kernels`` (name → ``[launches, seconds]``), ``launches_by_span``
    (span name → the kernels whose launch call on the host fell inside a
    span of that name; ``None`` where the trace links no kernel to its
    launch), ``device_ops`` (the ten that took most time) and
    ``idle_gaps`` (idle device time by the innermost host span it fell in,
    the ten largest)."""
    device, notes, seg = [], [], None
    launched_at: dict = {}   # correlation id → host time of the launch call
    launch_of: list = []     # correlation id of each kernel, or None
    for e in events:
        if e.get("ph") != "X":
            continue
        s = float(e["ts"])
        iv = (s, s + float(e.get("dur", 0)))
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in LAUNCH_CATS and corr is not None:
            launched_at[corr] = s
        elif cat in DEVICE_CATS:
            device.append((iv, e["name"], cat))
            if cat == "kernel":
                launch_of.append(corr)
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            name = e["name"][len(PREFIX):]
            if name == SEGMENT:
                seg = iv
            else:
                notes.append((iv, name))
    if seg is None:
        return None
    spans = [iv for iv, _, _ in device]
    # every device op in the trace was launched while the profiler ran; the
    # stretch takes them all in, where the card's clock, mapped onto the
    # host's, puts the last ones a little past the host's end of it
    lo = min([seg[0]] + [s for s, _ in spans])
    hi = max([seg[1]] + [e for _, e in spans])
    kernels: dict = {}
    ops: dict = defaultdict(float)
    for (s, e), name, cat in device:
        ops[short(name)] += (e - s) / 1e6
        if cat == "kernel":
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (e - s) / 1e6
    idle: dict = defaultdict(float)
    counts: dict = defaultdict(int)
    # outer spans first where two start together, so the inner one wins
    notes.sort(key=lambda n: (n[0][0], -n[0][1]))
    for gs, ge in stats.gaps(spans, lo, hi):
        mid = (gs + ge) / 2
        inner = "outside spans"
        for (s, e), name in notes:
            if s > mid:
                break
            if e > mid:
                inner = name
        idle[inner] += (ge - gs) / 1e6
        counts[inner] += 1
    by_span = None
    hosts = [launched_at[c] for c in launch_of if c in launched_at]
    if hosts:
        by_span = {name: _inside(hosts, [iv for iv, n in notes if n == name])
                   for name in {n for _, n in notes}}
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(hi - lo) / 1e6,
                busy_s=stats.union_seconds(spans, lo, hi) / 1e6,
                kernels=kernels, launches_by_span=by_span,
                device_ops=[[n, v] for n, v in top],
                idle_gaps=[[f"{n} ({counts[n]} gaps)", v] for n, v in gaps])


def _inside(points: list, intervals: list) -> int:
    """How many of ``points`` fall inside the union of ``intervals``."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]
    n = 0
    for p in points:
        i = bisect.bisect_right(starts, p) - 1
        n += i >= 0 and p <= merged[i][1]
    return n
