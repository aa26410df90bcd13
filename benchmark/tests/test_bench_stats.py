"""The metric arithmetic on synthetic timings and traces."""

import numpy as np
import pytest

from harness import stats, trace
from harness.cell import Reservoir, Run


def test_rate():
    assert stats.rate(33554432 * 3, 2.0) == 50331648.0
    with pytest.raises(ValueError):
        stats.rate(1, 0)


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 100, 457])
def test_percentile_nearest_rank(n):
    vals = list(range(1, n + 1))
    p95 = stats.percentile(vals[::-1], 95)
    assert p95 == vals[max(1, -(-95 * n // 100)) - 1]
    assert sum(v <= p95 for v in vals) >= 0.95 * n
    assert stats.percentile([], 95) is None


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (10, 12)]
    assert stats.union_seconds(iv, 0, 11) == 3 + 1 + 1
    assert stats.union_seconds(iv, 2.5, 5.5) == 0.5 + 0.5
    assert stats.gaps(iv, 0, 11) == [(3, 5), (6, 10)]
    assert stats.gaps([], 1, 2) == [(1, 2)]
    assert stats.gaps(iv, -1, 1) == [(-1, 0)]


def test_roofline():
    # 3.35 GB in 1 ms is the whole 3.35 TB/s
    assert stats.roofline_pct(3.35e9, 1, 1e-3) == pytest.approx(100.0)
    assert stats.roofline_pct(3.35e9, 2, 4e-3) == pytest.approx(50.0)
    assert stats.roofline_pct(1, 0, 1.0) is None


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_events():
    events = [
        ev("bench::segment", "user_annotation", 0, 1000),
        ev("bench::batch", "user_annotation", 0, 1000),
        ev("bench::lex", "user_annotation", 0, 300),
        ev("bench::prepare", "user_annotation", 400, 200),
        ev("void decode_stamp_kernel(int*)", "kernel", 300, 100),
        ev("void defilter_kernel<4>(unsigned char const*)", "kernel", 700,
           50),
        ev("Memcpy HtoD", "gpu_memcpy", 720, 100),
        ev("decode_stamp_kernel", "gpu_user_annotation", 0, 1000),
        ev("aten::add", "cpu_op", 0, 10),
        ev("void late_kernel()", "kernel", 1002, 10),
    ]
    r = trace.reduce_events(events)
    # the stretch runs on to the end of the last device op
    assert r["window_s"] == pytest.approx(1.012e-3)
    assert r["busy_s"] == pytest.approx(230e-6)
    assert r["kernels"] == {"void decode_stamp_kernel(int*)": [1, 1e-4],
                            "void defilter_kernel<4>(unsigned char const*)":
                            [1, 5e-5], "void late_kernel()": [1, 1e-5]}
    ops = dict(r["device_ops"])
    assert ops["Memcpy HtoD"] == pytest.approx(1e-4)
    gaps = {k.split(" (")[0]: v for k, v in r["idle_gaps"]}
    assert gaps["lex"] == pytest.approx(300e-6)
    # a gap goes whole to the innermost span around its middle
    assert gaps["prepare"] == pytest.approx(300e-6)
    assert gaps["batch"] == pytest.approx(182e-6)
    assert r["launches_by_span"] is None      # no kernel linked to a launch
    assert trace.reduce_events(events[1:]) is None


def test_launches_by_span_follow_the_host_launch():
    """A kernel counts for the spans its launch call fell in, wherever the
    device ran it."""
    events = [
        ev("bench::segment", "user_annotation", 0, 1000),
        ev("bench::inflate", "user_annotation", 0, 100),
        ev("bench::inflate", "user_annotation", 200, 100),
        ev("bench::lex", "user_annotation", 250, 10),
        ev("cudaLaunchKernel", "cuda_runtime", 10, 5, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 255, 2, corr=2),
        ev("cudaLaunchKernel", "cuda_runtime", 500, 5, corr=3),
        ev("k_a", "kernel", 150, 10, corr=1),     # runs after its span
        ev("k_b", "kernel", 400, 10, corr=2),
        ev("k_c", "kernel", 90, 10, corr=3),      # in a span by its time
        ev("k_d", "kernel", 600, 10),             # linked to no launch
    ]
    r = trace.reduce_events(events)
    assert r["launches_by_span"] == {"inflate": 2, "lex": 1}
    assert sum(n for n, _ in r["kernels"].values()) == 4


def run_with(spans, batches, kernels=None, profile=None, by_span=None,
             images=2):
    r = Run(config={"height": 4, "width": 4},
            traffic={"profile": profile or {"batches": 1}}, batch=2,
            raw_bytes=128, setup_s=1.0, window_s=2.0, calls=4, completed=4,
            out_bytes=0, batch_s=[0.1, 0.2], call_peak_bytes=None,
            inputs={}, spans=spans,
            window_batches=batches)
    if kernels is not None:
        r.trace = {"kernels": kernels, "busy_s": 0.1, "window_s": 1.0,
                   "images": images, "launches_by_span": by_span}
    return r


def test_span_ms_per_batch_counts_the_windows_batches():
    s = trace.Spans()
    s.events = [("lex", 0, 0.0, 1.0), ("lex", 1, 0.0, 0.002),
                ("lex", 1, 0.0, 0.002), ("lex", 3, 0.0, 0.006),
                ("run", 3, 0.0, 0.5)]
    r = run_with(s, batches=[1, 2, 3])
    assert r.span_ms_per_batch("lex") == pytest.approx((4 + 0 + 6) / 3)
    assert r.span_ms_per_batch("missing") is None
    assert run_with(s, batches=[]).span_ms_per_batch("lex") is None


def test_spans_skip_nested_calls_of_one_name():
    s = trace.Spans()

    def f(n):
        return n if n == 0 else wrapped(n - 1)
    wrapped = s.wrap("f", f)
    s.batch = 5
    assert wrapped(3) == 0
    assert [e[:2] for e in s.events] == [("f", 5)]


def test_hooks_restore(monkeypatch):
    import harness.stats as target
    s = trace.Spans()
    orig = target.rate
    with trace.Hooks(s, {"r": ["harness.stats:rate"]}):
        assert target.rate is not orig
        target.rate(1, 1)
    assert target.rate is orig
    assert [e[0] for e in s.events] == ["r"]


def test_kernel_lookup_and_readers(spec):
    r = run_with(None, [], {"void defilter_kernel<4>(x)": [2, 0.001],
                            "void decode_stamp_kernel(y)": [1, 0.002]})
    assert r.kernel("defilter_kernel") == (2, 0.001)
    assert r.kernel("nothing") == (0, 0)
    idle = spec.reader("device_idle_pct.decode").read(r)
    assert idle == pytest.approx(90.0)
    per_image = spec.reader("device_launches_per_image.decode").read(r)
    assert per_image == 1.5
    k3 = spec.reader("defilter_roofline").read(r)
    want = 100 * 2 * (2 * 4 * 17 + 2 * 4 * 16) / 3.35e12 / 0.001
    assert k3 == pytest.approx(want)
    assert spec.reader("dp_parse_roofline").read(r) is None


def test_split_readers_read_alike(spec):
    """A metric split by cell (``.decode``, ``.decode_png``) is read by its
    family's one reader, and the per-layer rate by the end-to-end one's."""
    assert (spec.reader("lex_ms.decode") is spec.reader("lex_ms.decode_png")
            is spec.reader("lex_ms"))
    assert (spec.reader("device_launches_per_image.decode_png")
            is spec.reader("device_launches_per_image.decode"))
    assert (spec.reader("defilter_roofline.decode_png")
            is spec.reader("defilter_roofline"))
    assert spec.reader("decode_MBps.decode_png") is spec.reader("decode_MBps")


def test_call_peak_reads_the_card_only(spec):
    reader = spec.reader("call_peak_MB")
    r = run_with(None, [])
    assert reader.read(r) is None           # no card: nothing to read
    r.call_peak_bytes = 270_240_256
    assert reader.read(r) == pytest.approx(270.240256)


def test_launches_per_image_charge_the_tail_to_the_batch(spec):
    """A stretch of a batch's last calls of a span: the span's launches go
    to the images it profiled, the batch's tail to the whole batch."""
    reader = spec.reader("device_launches_per_image.decode")
    kernels = {"inflate_op": [90, 0.01], "defilter_kernel": [10, 0.001]}
    prof = {"span": "inflate_fused", "skip_calls": 30}
    r = run_with(None, [], kernels, profile=prof,
                 by_span={"inflate_fused": 90}, images=3)
    r.batch = 32
    assert reader.read(r) == pytest.approx(90 / 3 + 10 / 32)
    r.trace["launches_by_span"] = None      # no kernel linked to a launch
    assert reader.read(r) is None


def test_reservoir_is_fixed_by_its_rng():
    a = Reservoir(3, np.random.default_rng([9, 1]))
    b = Reservoir(3, np.random.default_rng([9, 1]))
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items and len(a.items) == 3
    few = Reservoir(4, np.random.default_rng(0))
    for i in range(2):
        few.offer(i)
    assert few.items == [0, 1]
