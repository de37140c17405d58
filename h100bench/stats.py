"""The arithmetic of the end-to-end numbers and of the device's busy share.

A rate is all the work of the window over all its time, never a median of
calls; a tail is the nearest-rank percentile over every tick of the window.
"""

from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """Nearest-rank q-th percentile (0 < q <= 100) of every value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps counted once."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]
