"""Latency statistics: percentiles and histograms.

The port's copy of ``repro.serving.metrics``: one implementation shared
by the load generator and the serving launcher, so a "p99" means the
same number in both. ``union_length`` measures intervals that may
overlap; ``device_busy`` reads the device's busy share from a
``torch.profiler`` trace with it. Pure Python on sorted copies — sample counts
here are thousands at most, and exact interpolation semantics matter
more than speed (the unit tests pin them against numpy's default
``linear`` method).
"""
from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["percentile", "p50", "p99", "latency_histogram", "union_length",
           "device_busy"]


def percentile(xs: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) with linear interpolation between
    order statistics — numpy's default method, so swapping ``np.percentile``
    in or out of a report cannot move a gated number."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    s = sorted(float(x) for x in xs)
    if not s:
        raise ValueError("percentile of an empty sample")
    if len(s) == 1:
        return s[0]
    pos = q / 100.0 * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def p50(xs: Sequence[float]) -> float:
    return percentile(xs, 50.0)


def p99(xs: Sequence[float]) -> float:
    return percentile(xs, 99.0)


def latency_histogram(xs: Sequence[float], bins: int = 10,
                      lo: Optional[float] = None,
                      hi: Optional[float] = None
                      ) -> tuple[list[float], list[int]]:
    """Equal-width histogram → (bin edges, counts); ``len(edges) ==
    bins + 1`` and ``sum(counts) == len(xs)``. Values outside an
    explicit [lo, hi] clamp into the edge bins (a latency histogram
    must not silently drop outliers — they ARE the story)."""
    if bins < 1:
        raise ValueError("bins must be >= 1")
    vals = [float(x) for x in xs]
    if not vals:
        raise ValueError("histogram of an empty sample")
    lo = min(vals) if lo is None else float(lo)
    hi = max(vals) if hi is None else float(hi)
    if hi <= lo:
        hi = lo + 1e-12
    width = (hi - lo) / bins
    edges = [lo + i * width for i in range(bins + 1)]
    counts = [0] * bins
    for v in vals:
        idx = int((v - lo) / width)
        counts[min(max(idx, 0), bins - 1)] += 1
    return edges, counts


def union_length(spans) -> float:
    """Length of the union of ``(start, end)`` intervals: where they
    overlap, the time counts once."""
    total, cur0, cur1 = 0.0, None, None
    for t0, t1 in sorted(spans):
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    return total if cur1 is None else total + cur1 - cur0


def device_busy(prof) -> tuple[float, float]:
    """(busy ms, window ms) of a ``torch.profiler`` trace: busy is the
    union of the device's intervals (kernels, copies), so that kernels
    that overlap count once; the window runs from the trace's first event
    to the last device interval's end. busy / window is at most 1; both
    are 0 when the trace holds no device interval."""
    from torch.autograd import DeviceType
    spans, first = [], None
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        first = t0 if first is None else min(first, t0)
        if e.device_type == DeviceType.CUDA and t1 > t0:
            spans.append((t0, t1))
    if not spans:
        return 0.0, 0.0
    window = max(t1 for _, t1 in spans) - min(first, min(spans)[0])
    return union_length(spans) / 1e3, window / 1e3
