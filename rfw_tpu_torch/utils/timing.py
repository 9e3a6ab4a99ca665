"""Frame timing helpers (copy of `rfw_tpu/utils/timing.py`; reference
crates/rfw-utils/src/lib.rs:10-105).

`Timer` measures elapsed wall time; `Averager` keeps a rolling mean used by
the FPS overlay / bench harness. Callers must wait for device work (e.g.
`torch.cuda.synchronize()`) before sampling the timer — helpers here stay
device-agnostic.
"""

from __future__ import annotations

import time
from typing import List


class Timer:
    __slots__ = ("_start",)

    def __init__(self) -> None:
        self._start = time.perf_counter()

    def reset(self) -> None:
        self._start = time.perf_counter()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._start) * 1e3

    def elapsed_s(self) -> float:
        return time.perf_counter() - self._start


class Averager:
    """Rolling average over a fixed window (default 100 samples, matching the
    reference's FPS overlay)."""

    __slots__ = ("_cap", "_vals", "_idx", "_full")

    def __init__(self, capacity: int = 100) -> None:
        self._cap = max(1, capacity)
        self._vals: List[float] = []
        self._idx = 0
        self._full = False

    def add(self, v: float) -> None:
        if self._full:
            self._vals[self._idx] = v
            self._idx = (self._idx + 1) % self._cap
        else:
            self._vals.append(v)
            if len(self._vals) == self._cap:
                self._full = True
                self._idx = 0

    def average(self) -> float:
        if not self._vals:
            return 0.0
        return sum(self._vals) / len(self._vals)

    def last(self) -> float:
        """Most recent sample (per-frame readouts; the rolling average
        folds in first-frame compile spikes for ~100 frames)."""
        if not self._vals:
            return 0.0
        idx = (self._idx - 1) % len(self._vals) if self._full else -1
        return self._vals[idx]

    def __len__(self) -> int:
        return len(self._vals)
