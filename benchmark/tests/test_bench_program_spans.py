"""The metrics that read the port's own spans: the window calls' spans
found by the ``batch`` events, readers that find nothing without spans, idle
gaps put down to program spans, and one shrunk traced run of each cell on
the CPU in which every such metric reads a number."""

from types import SimpleNamespace

import pytest

from conftest import small
from harness import program_spans, trace
from harness.cell import run_cell
from swift_png_tpu_torch import trace as port_trace

NEW = {
    "photo512_rgba8.decode_png": [
        "inflate_blocks_ms.decode_png", "inflate_assemble_ms.decode_png",
        "host_syncs_per_image.decode_png", "sync_wait_pct.decode_png",
        "entry_self_ms.decode_png"],
    "photo512_rgba8.decode_indexed": [
        "stage_layout_ms.decode_indexed", "stage_upload_ms.decode_indexed",
        "host_syncs_per_image.decode", "sync_wait_pct.decode",
        "entry_self_ms.decode"],
    "photo512_rgba8.encode_l9": [
        "filter_fetch_ms.encode", "assemble_ms.encode",
        "host_syncs_per_image.encode", "sync_wait_pct.encode",
        "entry_self_ms.encode"],
}
OUTSIDE = {
    "photo512_rgba8.decode_png": ["lex_ms.decode_png",
                                  "inflate_ms.decode_png"],
    "photo512_rgba8.decode_indexed": ["lex_ms.decode",
                                      "inflate_ms.decode_indexed",
                                      "prepare_ms.decode_indexed"],
    "photo512_rgba8.encode_l9": ["deflate_ms.encode", "index_ms.encode"],
}
ALL_NEW = [m for ms in NEW.values() for m in ms]


def sp(id_, name, start, end, parent=None, root=None, **counters):
    """A synthetic span, times in seconds."""
    return SimpleNamespace(id=id_, name=name, parent=parent,
                           root=id_ if root is None else root,
                           start_ns=int(start * 1e9), end_ns=int(end * 1e9),
                           duration_ns=int((end - start) * 1e9),
                           counters=counters or None)


def window_run(spans, tracer, monkeypatch):
    """A run of three window calls (batches 0-2, 1 s apart), a warm call
    before them and one profiled call (batch 3) after, with ``spans`` as
    the port's kept spans."""
    monkeypatch.setattr(program_spans, "tracer", tracer)
    tracer.spans = lambda: list(spans)
    tracer.summary = port_trace.summary
    events = [("batch", b, 10.0 + b, 10.9 + b) for b in range(4)]
    events += [("lex", 1, 11.1, 11.2)]
    return SimpleNamespace(spans=SimpleNamespace(events=events),
                           window_batches=[0, 1, 2])


def calls_spans():
    out = [sp(1, "decode", 5.0, 5.5, images=2),            # the warm call
           sp(2, "sync", 5.1, 5.2, parent=1, root=1, syncs=1)]
    nid = 3
    for b in range(4):                                      # 3 is profiled
        t = 10.0 + b
        root = sp(nid, "decode", t + 0.1, t + 0.8, images=2)
        lex = sp(nid + 1, "decode.lex", t + 0.1, t + 0.2, parent=nid,
                 root=nid)
        blocks = sp(nid + 2, "inflate_fused.blocks", t + 0.3, t + 0.6,
                    parent=nid, root=nid)
        wait = sp(nid + 3, "sync", t + 0.4, t + 0.5, parent=nid + 2,
                  root=nid, syncs=2)
        out += [lex, wait, blocks, root]
        nid += 4
    return out


def test_spans_go_to_the_window_call_their_root_started_in(monkeypatch):
    run = window_run(calls_spans(), SimpleNamespace(), monkeypatch)
    per = program_spans.calls(run)
    assert len(per) == 3
    for b, c in enumerate(per):
        root = 3 + 4 * b
        assert sorted(s.id for s in c) == list(range(root, root + 4))
        assert all(s.root == root for s in c)
    assert program_spans.span_ms(run, "inflate_fused.blocks") == \
        pytest.approx(300.0)
    assert program_spans.span_ms(run, "nothing") is None
    assert program_spans.counter(per, "syncs") == 6
    assert program_spans.counter(per, "images") == 6
    # the root's 700 ms less its children's 100 + 300 ms
    assert program_spans.root_self_ms(run) == pytest.approx(300.0)


@pytest.mark.parametrize("metric", ALL_NEW)
def test_reader_values_on_synthetic_spans(spec, monkeypatch, metric):
    run = window_run(calls_spans(), SimpleNamespace(), monkeypatch)
    value = spec.reader(metric).read(run)
    family = metric.rsplit(".", 1)[0]
    if family == "host_syncs_per_image":
        assert value == pytest.approx(1.0)          # 6 syncs, 6 images
    elif family == "sync_wait_pct":
        assert value == pytest.approx(100 * 0.1 / 0.7)
    elif family == "entry_self_ms":
        assert value == pytest.approx(300.0)
    elif metric == "inflate_blocks_ms.decode_png":
        assert value == pytest.approx(300.0)
    else:
        assert value is None                        # no such span here


@pytest.mark.parametrize("metric", ALL_NEW)
@pytest.mark.parametrize("case", ["no tracer", "no spans", "untraced"])
def test_readers_find_nothing_without_spans(spec, monkeypatch, metric, case):
    kept = [] if case == "no spans" else calls_spans()
    run = window_run(kept, SimpleNamespace(), monkeypatch)
    if case == "no tracer":             # a port without the tracer
        monkeypatch.setattr(program_spans, "tracer", None)
    elif case == "untraced":
        run.spans = None
    assert spec.reader(metric).read(run) is None


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_gaps_go_to_the_innermost_program_span():
    p = trace.PREFIX
    events = [
        ev(p + "segment", "user_annotation", 0, 1000),
        ev(p + "inflate_fused", "user_annotation", 0, 1000),
        ev(p + "inflate_fused.inflate", "user_annotation", 10, 980),
        ev(p + "inflate_fused.blocks", "user_annotation", 20, 600),
        ev(p + "sync", "user_annotation", 500, 120),
        ev(p + "inflate_fused.assemble", "user_annotation", 700, 250),
        ev("void k()", "kernel", 0, 100),
        ev("void k()", "kernel", 400, 150),
        ev("void k()", "kernel", 650, 100),
        ev("void k()", "kernel", 800, 200),
    ]
    gaps = {k.split(" (")[0]: v
            for k, v in trace.reduce_events(events)["idle_gaps"]}
    assert gaps == pytest.approx({"inflate_fused.blocks": 300e-6,
                                  "sync": 100e-6,
                                  "inflate_fused.assemble": 50e-6})


@pytest.mark.parametrize("workload", list(NEW))
def test_shrunk_traced_cell_reads_every_metric(spec, monkeypatch, workload):
    overrides = small(workload)
    if workload.endswith("encode_l9"):
        # on the CPU the encode takes the device parse only without the
        # native library; level 8 and two images keep its plain DP short
        from swift_png_tpu_torch._host import native
        monkeypatch.setattr(native, "available", lambda: False)
        overrides["traffic"].update(batch=2, profile={"batches": 1},
                                    check_batches=1,
                                    call={"level": 8, "index": True})
    r = run_cell(spec, workload, 2**31 + 19, 0.2, True, device="cpu",
                 overrides=overrides, log=lambda **kw: None)
    assert r["correct"], r["checks"]
    for name in NEW[workload] + OUTSIDE[workload]:
        value = r["metrics"][name]["value"]
        assert isinstance(value, float) and value >= 0, name
