"""Frame timer resource (reference GameTimer, rfw/src/lib.rs:54-92).

Host copy of `rfw_tpu/app/timer.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

import time


class GameTimer:
    def __init__(self) -> None:
        now = time.perf_counter()
        self._start = now
        self._last = now
        self.dt = 0.0  # seconds since previous frame
        self.elapsed = 0.0  # seconds since startup
        self.frame = 0

    def tick(self) -> None:
        now = time.perf_counter()
        self.dt = now - self._last
        self.elapsed = now - self._start
        self._last = now
        self.frame += 1
