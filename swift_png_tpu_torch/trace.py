"""Spans and counters of the port's own work, off by default.

A span is a named interval of host time at a layer boundary of the port
(the entry points, lexing, the inflates and their staging, the stages of
the level 8–13 deflate, the containers) with the counters added while it
was the innermost open one.  Every place where the host blocks on the card
(a fetch, a ``torch.equal`` or scalar read of a device tensor, a blocking
upload of a host array) is a ``sync`` span of its own that counts
``syncs``.

While the tracer is off, :func:`span` and :func:`sync` return one shared
no-op context and :func:`count` returns at once: no clock is read and no
span is made.  While it is on, each closed span is kept in memory, up to
2**18 spans; past the bound only the number dropped grows::

    from swift_png_tpu_torch import BatchCodec, trace
    trace.enable()
    BatchCodec("cuda").decode(files)
    print(trace.summary()["inflate_fused.blocks"])

Spans nest per thread of control (a ``contextvars`` variable holds the
innermost one); a span opened with none around it is a root, and every
span under it carries the root's id.  Work handed to a worker thread is
charged to the span of the caller that waits for it: no span is opened on
the port's worker threads.

``enable(annotate=prefix)`` also makes each span a
``torch.profiler.record_function(prefix + name)`` while a profiler is
recording, so that the span's interval sits in the profiler's trace, on
its clock, beside the kernels and copies it launched.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "sync", "upload", "fetch", "count", "enable",
           "disable", "enabled", "spans", "clear", "dropped", "summary",
           "covered_ns", "Span", "NOOP"]

_on = False
_annotate: str | None = None
_limit = 1 << 18     # the most spans kept
_spans: list = []
_dropped = 0
_ids = itertools.count(1)
_lock = threading.Lock()
_current: contextvars.ContextVar = contextvars.ContextVar(
    "swift_png_tpu_torch.trace.current", default=None)


class _Noop:
    """The context :func:`span` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns``, its ``id``, its ``parent``'s id (``None`` for
    a root) and its ``root``'s id, the ``thread`` it ran on, ``attrs`` and
    ``counters`` (dicts, or ``None`` while empty)."""

    __slots__ = ("name", "id", "parent", "root", "thread", "attrs",
                 "counters", "start_ns", "end_ns", "_token", "_note")

    def __init__(self, name: str, attrs: dict | None = None,
                 counters: dict | None = None):
        self.name = name
        self.attrs = attrs or None
        self.counters = counters
        self.end_ns = None

    def __enter__(self):
        outer = _current.get()
        self.id = next(_ids)
        if outer is None:
            self.parent, self.root = None, self.id
        else:
            self.parent, self.root = outer.id, outer.root
        self.thread = threading.get_ident()
        self._token = _current.set(self)
        self._note = None
        if _annotate is not None and _profiler._is_profiler_enabled:
            self._note = _profiler.record_function(_annotate + self.name)
            self._note.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._note is not None:
            self._note.__exit__(*exc)
            self._note = None
        _current.reset(self._token)
        self._token = None
        global _dropped
        with _lock:
            if len(_spans) < _limit:
                _spans.append(self)
            else:
                _dropped += 1
        return False

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


def span(name: str, **attrs):
    """A context manager over the span ``name``; with the tracer off, the
    shared no-op."""
    if not _on:
        return NOOP
    return Span(name, attrs)


def sync(n: int = 1):
    """A ``sync`` span around a place where the host blocks on the card
    ``n`` times (a fetch, a comparison or scalar read of a device tensor, a
    blocking upload); it counts ``syncs``."""
    if not _on:
        return NOOP
    return Span("sync", None, {"syncs": n})


def upload(array, device) -> torch.Tensor:
    """``torch.from_numpy(array).to(device)`` under :func:`sync`: the copy
    of a pageable host array, which waits for the device's stream."""
    with sync():
        return torch.from_numpy(array).to(device)


def fetch(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()`` under :func:`sync`."""
    with sync():
        return t.cpu()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span."""
    if not _on:
        return
    sp = _current.get()
    if sp is not None:
        if sp.counters is None:
            sp.counters = {}
        sp.counters[name] = sp.counters.get(name, 0) + n


def enable(annotate: str | None = None) -> None:
    """Turn the tracer on.  ``annotate``: a prefix under which each span is
    also a profiler annotation while a profiler records."""
    global _on, _annotate
    _annotate = annotate
    _on = True


def disable() -> None:
    """Turn the tracer off; what it kept stays until :func:`clear`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def spans() -> list:
    """The kept spans, in the order they closed."""
    with _lock:
        return list(_spans)


def dropped() -> int:
    """Spans closed past the bound (``_limit``) and not kept."""
    return _dropped


def clear() -> None:
    """Forget the kept spans and the dropped count."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def covered_ns(start: int, end: int, intervals) -> int:
    """Nanoseconds of ``[start, end]`` that the union of ``intervals``
    (``(start, end)`` pairs) covers."""
    total, at = 0, start
    for s, e in sorted(intervals):
        s, e = max(s, at), min(e, end)
        if e > s:
            total += e - s
            at = e
    return total


def summary(kept: list | None = None) -> dict:
    """Per span name, over ``kept`` (default: every kept span): ``calls``,
    ``total_ms``, ``self_ms`` (each span's duration less the part its
    children cover) and the summed ``counters``."""
    kept = spans() if kept is None else kept
    children: dict = {}
    for s in kept:
        if s.parent is not None:
            children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out: dict = {}
    for s in kept:
        row = out.setdefault(s.name, {"calls": 0, "total_ms": 0.0,
                                      "self_ms": 0.0, "counters": {}})
        row["calls"] += 1
        row["total_ms"] += s.duration_ns / 1e6
        inner = covered_ns(s.start_ns, s.end_ns, children.get(s.id, ()))
        row["self_ms"] += (s.duration_ns - inner) / 1e6
        for k, v in (s.counters or {}).items():
            row["counters"][k] = row["counters"].get(k, 0) + v
    return out
