"""The benchmark's arithmetic: percentiles, and the union of intervals
from which the device's busy time and idle gaps come."""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union(intervals: Iterable[Tuple[float, float]], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals clipped to [lo, hi], as
    disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(intervals: Iterable[Tuple[float, float]], lo: float,
            hi: float) -> float:
    """Length of [lo, hi] that some interval covers (not the sum of
    their lengths: overlapping streams count once)."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = e
    if hi > t:
        out.append((t, hi))
    return out
