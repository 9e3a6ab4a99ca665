"""Staged scheduler + resource/entity world.

Reference: rfw/src/ecs/mod.rs:14-103 — bevy_ecs Schedule with run-once
Startup stages and PreUpdate/Update/PostUpdate per frame, plus entities
with components iterated via `par_for_each_mut`
(examples/animated/src/main.rs:197-219).

TPU re-architecture: components are SoA numpy COLUMNS, not per-entity
objects. A query returns the matching entities' component columns as dense
batched arrays — the vectorized equivalent of bevy's parallel per-entity
closures (one numpy/jnp expression over the whole batch replaces
par_for_each_mut; on-device work is already data-parallel). Writes go
back through `Batch.set`, which scatters into the stores.

Host copy of `rfw_tpu/app/ecs.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Dict, List, Optional, Type, TypeVar

import numpy as np

T = TypeVar("T")


class Stage(enum.Enum):
    PRE_STARTUP = 0
    STARTUP = 1
    POST_STARTUP = 2
    PRE_UPDATE = 3
    UPDATE = 4
    POST_UPDATE = 5


_STARTUP = (Stage.PRE_STARTUP, Stage.STARTUP, Stage.POST_STARTUP)
_FRAME = (Stage.PRE_UPDATE, Stage.UPDATE, Stage.POST_UPDATE)


class _Store:
    """Dense SoA column for one component: (cap, *shape) array, swap-remove
    on despawn, entity<->row maps."""

    def __init__(self, example: np.ndarray) -> None:
        self.shape = example.shape
        self.dtype = example.dtype
        self.values = np.zeros((0,) + self.shape, self.dtype)
        self.entities = np.zeros(0, np.int64)
        self.row_of: Dict[int, int] = {}

    def insert(self, entity: int, value: np.ndarray) -> None:
        row = self.row_of.get(entity)
        if row is None:
            row = self.values.shape[0]
            self.values = np.concatenate([self.values, value[None]])
            self.entities = np.append(self.entities, entity)
            self.row_of[entity] = row
        else:
            self.values[row] = value

    def remove(self, entity: int) -> None:
        row = self.row_of.pop(entity, None)
        if row is None:
            return
        last = self.values.shape[0] - 1
        if row != last:
            self.values[row] = self.values[last]
            moved = int(self.entities[last])
            self.entities[row] = moved
            self.row_of[moved] = row
        self.values = self.values[:last]
        self.entities = self.entities[:last]


class Batch:
    """One query result: matching entities + their component columns as
    dense arrays. `col` returns a gathered COPY — compute new values and
    scatter them back with `set` (in-place writes on the copy are lost)."""

    def __init__(self, world: "World", entities: np.ndarray,
                 rows: Dict[str, np.ndarray]) -> None:
        self._world = world
        self.entities = entities
        self._rows = rows

    def __len__(self) -> int:
        return len(self.entities)

    def col(self, name: str) -> np.ndarray:
        """A COPY of the column for the matched entities (gather)."""
        store = self._world._components[name]
        return store.values[self._rows[name]]

    def set(self, name: str, values: np.ndarray) -> None:
        """Scatter a full column of new values back (batched write)."""
        store = self._world._components[name]
        store.values[self._rows[name]] = values


class World:
    """Typed resource map + SoA entity/component store."""

    def __init__(self) -> None:
        self._resources: Dict[type, Any] = {}
        self._components: Dict[str, _Store] = {}
        self._next_entity = 0

    # ---- resources -----------------------------------------------------
    def insert(self, resource: Any) -> None:
        self._resources[type(resource)] = resource

    def get(self, ty: Type[T]) -> T:
        return self._resources[ty]

    def try_get(self, ty: Type[T]) -> Optional[T]:
        return self._resources.get(ty)

    def __contains__(self, ty: type) -> bool:
        return ty in self._resources

    # ---- entities/components --------------------------------------------
    def spawn(self, **components) -> int:
        """Create an entity with named components (array-likes)."""
        e = self._next_entity
        self._next_entity += 1
        for name, value in components.items():
            self.add_component(e, name, value)
        return e

    def despawn(self, entity: int) -> None:
        for store in self._components.values():
            store.remove(entity)

    def add_component(self, entity: int, name: str, value) -> None:
        value = np.asarray(value)
        store = self._components.get(name)
        if store is None:
            store = self._components[name] = _Store(value)
        store.insert(entity, value.astype(store.dtype))

    def get_component(self, entity: int, name: str):
        store = self._components[name]
        return store.values[store.row_of[entity]]

    def query(self, *names: str) -> Batch:
        """Entities having ALL named components, columns as dense arrays
        (the batched equivalent of bevy's par_for_each_mut)."""
        stores = [self._components.get(n) for n in names]
        if any(s is None for s in stores):
            return Batch(self, np.zeros(0, np.int64), {n: np.zeros(0, np.int64) for n in names})
        common = set(stores[0].row_of)
        for s in stores[1:]:
            common &= set(s.row_of)
        ents = np.array(sorted(common), np.int64)
        rows = {
            n: np.array([s.row_of[int(e)] for e in ents], np.int64)
            for n, s in zip(names, stores)
        }
        return Batch(self, ents, rows)


System = Callable[[World], None]


class Scheduler:
    def __init__(self) -> None:
        self._systems: Dict[Stage, List[System]] = {s: [] for s in Stage}
        self._startup_done = False

    def add_system(self, system: System, stage: Stage = Stage.UPDATE) -> None:
        self._systems[stage].append(system)

    def add_startup_system(self, system: System, stage: Stage = Stage.STARTUP) -> None:
        assert stage in _STARTUP
        self._systems[stage].append(system)

    def run(self, world: World) -> None:
        if not self._startup_done:
            for s in _STARTUP:
                for sys_fn in self._systems[s]:
                    sys_fn(world)
            self._startup_done = True
        for s in _FRAME:
            for sys_fn in self._systems[s]:
                sys_fn(world)
