"""Metric arithmetic: window rates, percentiles, the device's busy time from
a trace, and bytes rooflines."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)


def rate(amount: float, seconds: float) -> float:
    """``amount`` per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError("a window must last longer than 0 s")
    return amount / seconds


def percentile(values, q: float) -> float | None:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``:
    the smallest value with at least ``q`` % of them at or below it."""
    vals = sorted(values)
    if not vals:
        return None
    k = max(1, math.ceil(q / 100 * len(vals)))
    return vals[k - 1]


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to ``[lo,
    hi]``, in the intervals' unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The ``(start, end)`` stretches of ``[lo, hi]`` that no interval
    covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if e <= at:
            continue
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def roofline_pct(bytes_per_launch: float, launches: int,
                 device_seconds: float) -> float | None:
    """A kernel's share of its bytes roofline, in %: the time its work needs
    at the card's memory rate (each input byte read once, each output byte
    written once, ``bytes_per_launch`` a launch) over the time its
    ``launches`` took on the device.  ``None`` when it did not run."""
    if not launches or device_seconds <= 0:
        return None
    return 100.0 * bytes_per_launch * launches / HBM_BYTES_PER_S / \
        device_seconds
