"""Single-value dirty-flag wrapper (reference crates/rfw-utils/src/track.rs:1-117).

Host copy of `rfw_tpu/utils/track.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from typing import Generic, TypeVar

T = TypeVar("T")


class Tracked(Generic[T]):
    """Wraps a value; any write through :attr:`value` sets the changed flag."""

    __slots__ = ("_value", "_changed")

    def __init__(self, value: T, changed: bool = True) -> None:
        self._value = value
        self._changed = changed

    @property
    def value(self) -> T:
        return self._value

    @value.setter
    def value(self, v: T) -> None:
        self._value = v
        self._changed = True

    def get_mut(self) -> T:
        """Access for in-place mutation; marks changed."""
        self._changed = True
        return self._value

    @property
    def changed(self) -> bool:
        return self._changed

    def reset_changed(self) -> None:
        self._changed = False

    def trigger_changed(self) -> None:
        self._changed = True
