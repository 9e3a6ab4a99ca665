"""What the program itself records in a traced run: its `rfw.*` spans
(`record_function` annotations, which `tracing.capture` keeps in
`Trace.host` beside the benchmark's own) and its frame records
(`rfw_tpu_torch.utils.trace.frames()`). A program that records neither
gives None to every reader here, never 0."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from benchmark import stats


def spans(t, match: Callable[[str], bool]) -> List[Tuple[float, float]]:
    """The host spans whose name `match` accepts, clipped to the window."""
    lo, hi = t.window
    return stats.clip([(a, b) for name, a, b in t.host if match(name)], lo, hi)


def idle_ms(t, match: Callable[[str], bool]) -> Optional[float]:
    """Device-idle ms a traced frame inside the named spans: the gaps
    between the window's device spans, intersected with the spans' union."""
    inside = stats.union(spans(t, match))
    if not inside:
        return None
    lo, hi = t.window
    gaps = stats.gaps([(a, b) for _, a, b, _ in t.device_in_window()], lo, hi)
    idle, i = 0.0, 0
    for a, b in gaps:  # both sorted and disjoint: one sweep
        while i < len(inside) and inside[i][1] <= a:
            i += 1
        j = i
        while j < len(inside) and inside[j][0] < b:
            idle += min(b, inside[j][1]) - max(a, inside[j][0])
            j += 1
    return 1e3 * idle / len(t.frames)


def records(t) -> Optional[List[Dict]]:
    """The program's frame records of the window: the last len(t.frames)
    of `trace.frames()`, or None where the program keeps none."""
    try:
        from rfw_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = trace.frames()[-len(t.frames):]
    return recs if len(recs) == len(t.frames) else None


def counter(t, name: str) -> Optional[List[int]]:
    """Each window frame's count `name` (0 where a frame has none), or None
    where no record of the window holds it."""
    recs = records(t)
    if not recs or not any(name in r["counts"] for r in recs):
        return None
    return [r["counts"].get(name, 0) for r in recs]
