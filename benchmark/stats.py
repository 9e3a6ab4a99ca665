"""The benchmark's arithmetic over frames and spans: plain Python and numpy,
no device. The end-to-end metrics, the spread that sets a bound, and the
union of device spans that gives the busy share."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def rate(units_per_frame: float, frames: int, window_s: float) -> float:
    """Work a second over the whole window: every frame's units over the
    time from the window's start to the end of its last frame."""
    return units_per_frame * frames / window_s


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between ranks
    (numpy's default rule)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median, as
    `statistics.quantiles(values, n=4)` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals covering every (start, end) span."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(spans: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The parts of the spans that lie inside [lo, hi]."""
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def busy(spans: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of the spans inside [lo, hi]."""
    return sum(b - a for a, b in union(clip(spans, lo, hi)))


def gaps(spans: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The idle intervals of [lo, hi] that no span covers."""
    out, cur = [], lo
    for a, b in union(clip(spans, lo, hi)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return out
