"""Slot-map storage (host copy of `FlaggedStorage` from
`rfw_tpu/utils/collections.py`): stable integer slots with O(1)
allocate/erase and free-list reuse.
"""

from __future__ import annotations

from typing import Generic, Iterator, List, Optional, TypeVar

T = TypeVar("T")


class FlaggedStorage(Generic[T]):
    """Slot map: dense list + active mask + free list.

    Semantics follow reference crates/rfw-utils/src/collections.rs:87-302
    (allocate/erase/overwrite_val/iterators) — stable indices survive
    erasure of other slots; erased slots are reused LIFO.
    """

    __slots__ = ("_items", "_active", "_free")

    def __init__(self) -> None:
        self._items: List[Optional[T]] = []
        self._active: List[bool] = []
        self._free: List[int] = []

    def __len__(self) -> int:
        return sum(self._active)

    @property
    def capacity(self) -> int:
        return len(self._items)

    def allocate(self) -> int:
        """Reserve a slot (value None until overwritten). O(1)."""
        if self._free:
            idx = self._free.pop()
            self._active[idx] = True
            self._items[idx] = None
            return idx
        self._items.append(None)
        self._active.append(True)
        return len(self._items) - 1

    def push(self, value: T) -> int:
        idx = self.allocate()
        self._items[idx] = value
        return idx

    def overwrite(self, idx: int, value: T) -> None:
        """Write `value` at `idx`, growing storage if needed
        (reference collections.rs:70-85 overwrite_val)."""
        while idx >= len(self._items):
            self._items.append(None)
            self._active.append(False)
        if not self._active[idx]:
            if idx in self._free:
                self._free.remove(idx)
            self._active[idx] = True
        self._items[idx] = value

    def erase(self, idx: int) -> T:
        if not (0 <= idx < len(self._items)) or not self._active[idx]:
            raise KeyError(f"slot {idx} not active")
        val = self._items[idx]
        self._items[idx] = None
        self._active[idx] = False
        self._free.append(idx)
        return val  # type: ignore[return-value]

    def get(self, idx: int) -> Optional[T]:
        if 0 <= idx < len(self._items) and self._active[idx]:
            return self._items[idx]
        return None

    def __getitem__(self, idx: int) -> T:
        v = self.get(idx)
        if v is None and not (0 <= idx < len(self._items) and self._active[idx]):
            raise KeyError(f"slot {idx} not active")
        return v  # type: ignore[return-value]

    def __setitem__(self, idx: int, value: T) -> None:
        self.overwrite(idx, value)

    def __contains__(self, idx: int) -> bool:
        return 0 <= idx < len(self._items) and self._active[idx]

    def __iter__(self) -> Iterator[tuple]:
        for i, (a, v) in enumerate(zip(self._active, self._items)):
            if a:
                yield i, v

    def indices(self) -> List[int]:
        return [i for i, a in enumerate(self._active) if a]
