"""Key/button state with age counters (reference rfw/src/input/mod.rs:8-65:
`just_pressed` = age 0).

Host copy of `rfw_tpu/app/input.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Generic, Hashable, TypeVar

K = TypeVar("K", bound=Hashable)


class Input(Generic[K]):
    def __init__(self) -> None:
        self._down: Dict[K, int] = {}  # key -> age in frames
        self._released: Dict[K, int] = {}

    def press(self, key: K) -> None:
        if key not in self._down:
            self._down[key] = 0
        self._released.pop(key, None)

    def release(self, key: K) -> None:
        self._down.pop(key, None)
        self._released[key] = 0

    def pressed(self, key: K) -> bool:
        return key in self._down

    def just_pressed(self, key: K) -> bool:
        return self._down.get(key, -1) == 0

    def just_released(self, key: K) -> bool:
        return self._released.get(key, -1) == 0

    def update(self) -> None:
        """Age all states (call once per frame)."""
        for k in self._down:
            self._down[k] += 1
        for k in self._released:
            self._released[k] += 1
