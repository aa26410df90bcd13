"""The port's own spans in a traced run: what its tracer
(``swift_png_tpu_torch.trace``) recorded inside each call of the window.

Importing this module turns the port's tracer on, each span also a
profiler annotation under :data:`trace.PREFIX`, so that
:func:`trace.reduce_events` puts each idle gap of the profiled stretch down
to the innermost program span around it.  The readers of the metrics that
read program spans import it; a per-layer reader is loaded only in a traced
run, before the set-up.  Where the port has no tracer, nothing is turned on
and every reader here finds nothing.

The tracer is turned on as a side effect of the import and never turned
off again: it stays on for the rest of the process (in a test session, for
every later test in the same worker).  Its place is ``cell.py``, which
could turn it on for the traced run alone and off after it.

A window call's spans are those whose root span started inside the call's
``batch`` event (both on ``time.perf_counter``'s clock); the warm call and
the profiled calls after the window are left out, as
``Run.span_ms_per_batch`` leaves them out.
"""

from __future__ import annotations

import bisect
import statistics

from . import trace as bench_trace

try:
    from swift_png_tpu_torch import trace as tracer
except ImportError:
    tracer = None
else:
    tracer.enable(annotate=bench_trace.PREFIX)


def calls(run) -> list | None:
    """The program spans of each completed window call, in call order, or
    ``None`` where the run kept no program span."""
    if tracer is None or run.spans is None or not run.window_batches:
        return None
    kept = tracer.spans()
    if not kept:
        return None
    window = set(run.window_batches)
    events = sorted((t0, t1, b) for name, b, t0, t1 in run.spans.events
                    if name == "batch" and b in window)
    starts = [e[0] for e in events]
    call_of = {}
    for s in kept:
        if s.parent is None:
            t = s.start_ns / 1e9
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= events[i][1]:
                call_of[s.id] = events[i][2]
    per = {b: [] for b in run.window_batches}
    for s in kept:
        b = call_of.get(s.root)
        if b is not None:
            per[b].append(s)
    return [per[b] for b in run.window_batches]


def span_ms(run, name: str) -> float | None:
    """Mean milliseconds a window call spent in spans ``name`` (summed in
    each call), or ``None`` where no call opened one."""
    per = calls(run)
    if per is None or not any(s.name == name for c in per for s in c):
        return None
    return statistics.fmean(
        sum(s.duration_ns for s in c if s.name == name) / 1e6 for c in per)


def counter(per: list, name: str) -> int:
    """Counter ``name`` summed over every span of ``per``'s calls."""
    return sum((s.counters or {}).get(name, 0) for c in per for s in c)


def roots(per: list) -> list:
    return [s for c in per for s in c if s.parent is None]


def root_self_ms(run) -> float | None:
    """Mean milliseconds a window call spent in its root spans and in none
    of their children: host work of the entry that no stage span covers."""
    per = calls(run)
    if not per or not roots(per):
        return None
    names = {r.name for r in roots(per)}
    total = 0.0
    for c in per:
        rows = tracer.summary(c)
        total += sum(rows[n]["self_ms"] for n in names if n in rows)
    return total / len(per)
