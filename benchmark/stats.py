"""The arithmetic the benchmark's metrics share: rates, percentiles, the
union of device intervals, idle gaps and the spread of repeated runs."""

import math
import statistics


def rate(units, seconds):
    """Work per second over a window."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return units / seconds


def percentile(values, q):
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("a percentile needs at least one value")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def merge(intervals):
    """Sorted, disjoint ``(start, end)`` covering the same time."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals, lo, hi):
    """The parts of ``intervals`` inside [lo, hi]."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def union_length(intervals):
    """The time covered by at least one interval (overlaps once)."""
    return sum(e - s for s, e in merge(intervals))


def gaps(intervals, lo, hi):
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def quartile_spread(values):
    """(Q3 - Q1) / median by ``statistics.quantiles(values, n=4)``."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
