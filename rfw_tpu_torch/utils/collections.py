"""Slot-map storages with change tracking.

Fresh TPU-first design with the semantics of the reference's storage
primitives (reference: crates/rfw-utils/src/collections.rs — FlaggedStorage
:87-125, TrackedStorage :389-509): stable integer slots with O(1)
allocate/erase and free-list reuse, plus a *change feed* that the host->device
sync protocol drains once per frame.

Differences from the reference by design:
  * `changed` is a Python ``set`` of slot indices rather than a BitVec — the
    consumer on TPU wants an *index list* to turn into gather/scatter
    ``device_put`` deltas, not a bitmask scan.
  * Values are arbitrary Python objects (usually SoA dataclasses holding
    numpy arrays); the device mirror lives in the backend, keyed by slot.

Host copy of `rfw_tpu/utils/collections.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from typing import Generic, Iterator, List, Optional, Set, TypeVar

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


class TrackedStorage(FlaggedStorage[T]):
    """FlaggedStorage + change feed: the host->device sync primitive.

    Reference semantics (collections.rs:389-509): any mutating access marks
    the slot changed; the per-frame sync drains ``changed`` and ``erased``
    then calls :meth:`reset_changed`.
    """

    __slots__ = ("_changed", "_erased")

    def __init__(self) -> None:
        super().__init__()
        self._changed: Set[int] = set()
        self._erased: List[int] = []

    # -- mutation (all mark dirty) -------------------------------------
    def allocate(self) -> int:
        idx = super().allocate()
        self._changed.add(idx)
        return idx

    def overwrite(self, idx: int, value: T) -> None:
        super().overwrite(idx, value)
        self._changed.add(idx)

    def erase(self, idx: int) -> T:
        v = super().erase(idx)
        self._changed.discard(idx)
        self._erased.append(idx)
        return v

    def get_mut(self, idx: int) -> T:
        """Fetch for mutation: marks the slot changed
        (reference collections.rs:403-411)."""
        v = self[idx]
        self._changed.add(idx)
        return v

    def touch(self, idx: int) -> None:
        if idx in self:
            self._changed.add(idx)

    def trigger_changed_all(self) -> None:
        self._changed.update(self.indices())

    # -- change feed ----------------------------------------------------
    @property
    def any_changed(self) -> bool:
        return bool(self._changed) or bool(self._erased)

    def changed_indices(self) -> List[int]:
        return sorted(self._changed)

    def iter_changed(self) -> Iterator[tuple]:
        for i in sorted(self._changed):
            yield i, self._items[i]

    def take_erased(self) -> List[int]:
        e, self._erased = self._erased, []
        return e

    def reset_changed(self) -> None:
        self._changed.clear()
        self._erased.clear()
