"""Double-buffered event queues (reference rfw/src/event/mod.rs:28-95).

Host copy of `rfw_tpu/app/events.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from typing import Generic, Iterator, List, TypeVar

T = TypeVar("T")


class Events(Generic[T]):
    """Events pushed this frame are readable next frame too (current/last
    swap in PreUpdate), matching the reference semantics."""

    def __init__(self) -> None:
        self._current: List[T] = []
        self._last: List[T] = []

    def push(self, ev: T) -> None:
        self._current.append(ev)

    def iter(self) -> Iterator[T]:
        yield from self._last
        yield from self._current

    def update(self) -> None:
        """Swap buffers (call once per frame in PreUpdate)."""
        self._last = self._current
        self._current = []

    def clear(self) -> None:
        self._current = []
        self._last = []
