"""The benchmark's arithmetic on times and intervals."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merged, sorted intervals covering the same points."""
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def covered(intervals: Iterable[Interval]) -> float:
    """The length of the union of the intervals."""
    return sum(hi - lo for lo, hi in union(intervals))


def gaps(intervals: Iterable[Interval], lo: float,
         hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def geomean(values: Sequence[float]) -> float:
    return math.exp(sum(math.log(v) for v in values) / len(values))


def p95(values: Sequence[float]) -> float:
    """The nearest-rank 95th percentile: the smallest value that at least
    95% of the values do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]
