"""The port's tracer, ``swift_png_tpu_torch.trace``, on the CPU: the shared
no-op while it is off; nesting, root ids, self time, counters and the
bound while it is on; the spans and ``sync`` counts that the general
decode, the indexed decode, the level 8-13 deflate and the encode leave,
with outputs byte-identical to the untraced calls; and the spans as
``torch.profiler`` annotations under a prefix."""

import json
import threading
import zlib

import numpy as np
import pytest
import torch

from swift_png_tpu_torch import BatchCodec, decode_indexed, trace
from swift_png_tpu_torch.ops.deflate_optimal import (
    deflate_device_optimal_batch)
from swift_png_tpu_torch.ops.inflate_fused import InflateFused
from swift_png_tpu_torch.parallel import batch as port_batch
from swift_png_tpu_torch.png import Format, Image, Layout

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _tracer():
    """The tracer off and empty before and after each test; one torch
    thread and the CPU fused engine at a 4 KB window."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = dict(port_batch._FUSED)
    port_batch._FUSED[CPU] = InflateFused(win_bytes=1 << 12, t_max=1 << 10,
                                          device=CPU)
    trace.disable()
    trace.clear()
    try:
        yield
    finally:
        trace.disable()
        trace.clear()
        port_batch._FUSED.clear()
        port_batch._FUSED.update(saved)
        torch.set_num_threads(n)


def _pixels(n=2, h=12, w=20):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, (h, w, 4)) // 32 * 32).astype(np.uint8)
            for _ in range(n)]


def _files(index: bool):
    return [Image.pack(p, Layout(Format("rgba8"))).compress_bytes(
        level=6, index=index) for p in _pixels()]


def _traced(fn):
    """``fn()`` with the tracer off, then on: both results and the kept
    spans of the traced call."""
    off = fn()
    assert trace.spans() == []
    trace.enable()
    on = fn()
    trace.disable()
    return off, on, trace.spans()


def _one_root(kept, name):
    roots = [s for s in kept if s.parent is None]
    assert [r.name for r in roots] == [name]
    root = roots[0]
    assert all(s.root == root.id for s in kept)
    return root


def _syncs(kept) -> int:
    return sum((s.counters or {}).get("syncs", 0) for s in kept)


def test_off_is_the_shared_noop():
    assert not trace.enabled()
    assert trace.span("a") is trace.NOOP
    assert trace.span("b", x=1) is trace.NOOP
    assert trace.sync() is trace.NOOP
    with trace.span("a"):
        trace.count("n", 3)
    BatchCodec("cpu").decode(_files(False)[:1])
    assert trace.spans() == [] and trace.dropped() == 0
    assert trace.summary() == {}


def test_nesting_roots_counters_and_self_time():
    trace.enable()
    with trace.span("outer", kind="x") as outer:
        with trace.span("inner") as inner:
            trace.count("items", 2)
            trace.count("items")
            with trace.sync(2):
                pass
        with trace.span("second"):
            trace.count("bytes", 5)
        trace.count("own")
    with trace.span("next") as nxt:
        pass
    kept = {s.name: s for s in trace.spans()}
    assert [s.name for s in trace.spans()] == ["sync", "inner", "second",
                                               "outer", "next"]
    assert outer.parent is None and outer.root == outer.id
    assert inner.parent == outer.id and inner.root == outer.id
    assert kept["sync"].parent == inner.id and kept["sync"].root == outer.id
    assert kept["second"].parent == outer.id
    assert nxt.parent is None and nxt.root == nxt.id != outer.id
    assert outer.attrs == {"kind": "x"} and inner.attrs is None
    assert inner.counters == {"items": 3}
    assert kept["sync"].counters == {"syncs": 2}
    assert kept["second"].counters == {"bytes": 5}
    assert outer.counters == {"own": 1}
    assert all(s.thread == threading.get_ident() for s in kept.values())
    summ = trace.summary()
    children = inner.duration_ns + kept["second"].duration_ns
    assert summ["outer"]["calls"] == 1
    assert summ["outer"]["total_ms"] == outer.duration_ns / 1e6
    assert summ["outer"]["self_ms"] == pytest.approx(
        (outer.duration_ns - children) / 1e6, abs=1e-9)
    assert summ["inner"]["self_ms"] == pytest.approx(
        (inner.duration_ns - kept["sync"].duration_ns) / 1e6, abs=1e-9)
    assert summ["inner"]["counters"] == {"items": 3}
    assert summ["sync"]["counters"] == {"syncs": 2}


def test_self_time_takes_the_union_of_children():
    assert trace.covered_ns(0, 100, [(10, 30), (20, 40), (90, 120)]) == 40
    assert trace.covered_ns(0, 100, []) == 0
    assert trace.covered_ns(50, 60, [(0, 100)]) == 10


def test_count_outside_any_span_is_not_kept():
    trace.enable()
    trace.count("lost")
    with trace.span("call") as root:
        pass
    trace.count("lost", 2)
    assert [s.name for s in trace.spans()] == ["call"]
    assert root.counters is None and root.attrs is None


def test_worker_threads_open_their_own_roots():
    trace.enable()
    seen = {}

    def work():
        with trace.span("worker") as sp:
            seen["span"] = sp

    with trace.span("caller") as caller:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen["span"].parent is None and seen["span"].root != caller.id
    assert seen["span"].thread != caller.thread


def test_bound_keeps_a_dropped_count(monkeypatch):
    monkeypatch.setattr(trace, "_limit", 3)
    trace.enable()
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    assert [s.name for s in trace.spans()] == ["s0", "s1", "s2"]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_general_decode_spans():
    files = _files(False)
    off, on, kept = _traced(lambda: BatchCodec("cpu").decode(files))
    assert np.array_equal(off, on)
    root = _one_root(kept, "decode")
    assert root.counters == {"images": 2}
    summ = trace.summary(kept)
    assert summ["decode.lex"]["calls"] == 2
    assert summ["inflate_fused.inflate"]["calls"] == 2
    assert summ["inflate_fused.blocks"]["calls"] == 2
    assert summ["inflate_fused.assemble"]["calls"] == 2
    assert summ["decode.stage"]["calls"] == 1
    by_id = {s.id: s for s in kept}
    # the pointer-doubling loop compares once a round, two rounds at least
    assert _syncs([s for s in kept if s.parent is not None and by_id[
        s.parent].name == "inflate_fused.assemble"]) >= 2 * 2
    for s in kept:
        if s.name in ("inflate_fused.blocks", "inflate_fused.assemble"):
            assert by_id[s.parent].name == "inflate_fused.inflate"
    assert _syncs(kept) > 0


def test_indexed_decode_spans():
    files = _files(True)
    off, on, kept = _traced(
        lambda: decode_indexed(files, device="cpu").numpy())
    assert np.array_equal(off, on)
    root = _one_root(kept, "decode_indexed")
    assert root.counters == {"images": 2}
    by_name = {s.name: s for s in kept}
    by_id = {s.id: s for s in kept}
    for name, parent in (("decode.lex", "decode_indexed"),
                         ("checkpoint.run", "decode_indexed"),
                         ("checkpoint.prepare", "checkpoint.run"),
                         ("checkpoint.layout", "checkpoint.prepare"),
                         ("checkpoint.upload", "checkpoint.prepare"),
                         ("checkpoint.stamp", "checkpoint.run"),
                         ("checkpoint.tail", "checkpoint.run"),
                         ("decode.stage", "decode_indexed")):
        assert by_id[by_name[name].parent].name == parent
    upload = by_name["checkpoint.upload"]
    assert _syncs([s for s in kept if s.parent == upload.id]) >= 7
    assert _syncs(kept) > 0


def test_optimal_deflate_spans():
    datas = [np.ascontiguousarray(p).tobytes() for p in _pixels(n=1)]

    def run():
        return deflate_device_optimal_batch(datas, level=8, device="cpu",
                                            size_policy="strict")
    off, on, kept = _traced(run)
    assert off == on
    assert [zlib.decompress(s) for s in on] == datas
    root = _one_root(kept, "deflate.optimal")
    assert root.counters is None
    children = [s.name for s in kept if s.parent == root.id]
    assert children == ["deflate.plan", "deflate.parse", "deflate.trees",
                        "deflate.emit", "deflate.fetch", "deflate.assemble",
                        "deflate.strict_wait"]
    assert _syncs(kept) > 0


def test_encode_spans():
    px = np.stack(_pixels())

    def run():
        return BatchCodec("cpu").encode(px, level=9, index=True)
    off, on, kept = _traced(run)
    assert off == on
    root = _one_root(kept, "encode")
    assert root.counters == {"images": 2}
    summ = trace.summary(kept)
    assert summ["encode.filter"]["calls"] == 1
    assert summ["encode.filter"]["counters"] == {}
    assert summ["encode.index"]["calls"] == 2
    assert summ["encode.container"]["calls"] == 2
    assert _syncs(kept) > 0


def test_profiler_annotations(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    files = _files(False)[:1]
    trace.enable(annotate="x::")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        BatchCodec("cpu").decode(files)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = {e["name"] for e in events
             if e.get("cat") == "user_annotation"}
    assert {"x::decode", "x::inflate_fused.blocks", "x::sync"} <= notes
    # with no profiler recording the spans are kept as before
    BatchCodec("cpu").decode(files)
    assert [s.name for s in trace.spans()].count("decode") == 2
