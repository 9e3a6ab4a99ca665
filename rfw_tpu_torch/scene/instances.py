"""Instance pools, SoA per mesh.

Reference: crates/rfw-scene/src/instances_3d.rs:10-322 — one `InstanceList3D`
per mesh holding SoA `matrices`/`skin_ids`/`flags` behind an
`Arc<UnsafeCell<..>>` that trades safety for speed. The TPU rebuild keeps the
SoA pool and the per-slot TRANSFORMED dirty bit but drops shared mutability:
handles write through the list, and the changed mask is drained by the
per-frame sync (the functional device side never sees partial writes).

Host copy of `rfw_tpu/scene/instances.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from rfw_tpu_torch.backend.structs import InstancesView2D, InstancesView3D
from rfw_tpu_torch.mathx import compose_trs


_GROW = 16


class InstanceList3D:
    """Per-mesh SoA instance pool with capacity-padded growth (shape changes
    stay rare, so the device arena seldom reallocates — same motive as the
    reference wgpu arenas, backends/wgpu/src/list.rs:245-366)."""

    def __init__(self) -> None:
        self.matrices = np.zeros((0, 4, 4), np.float32)
        self.skin_ids = np.zeros(0, np.int32)
        self.active = np.zeros(0, bool)
        self.changed = np.zeros(0, bool)
        self.morph_weights: Optional[np.ndarray] = None  # (cap,K) lazily
        self._free: List[int] = []
        self.any_changed = False

    def __len__(self) -> int:
        return int(self.active.sum())

    @property
    def capacity(self) -> int:
        return self.matrices.shape[0]

    def _grow(self) -> None:
        cap = self.capacity
        new_cap = max(_GROW, cap * 2)
        self.matrices = np.concatenate(
            [self.matrices, np.tile(np.eye(4, dtype=np.float32), (new_cap - cap, 1, 1))]
        )
        self.skin_ids = np.concatenate([self.skin_ids, np.full(new_cap - cap, -1, np.int32)])
        self.active = np.concatenate([self.active, np.zeros(new_cap - cap, bool)])
        self.changed = np.concatenate([self.changed, np.zeros(new_cap - cap, bool)])
        if self.morph_weights is not None:
            self.morph_weights = np.concatenate(
                [self.morph_weights,
                 np.zeros((new_cap - cap, self.morph_weights.shape[1]), np.float32)]
            )
        self._free.extend(range(new_cap - 1, cap - 1, -1))

    def allocate(self) -> "InstanceHandle3D":
        if not self._free:
            self._grow()
        idx = self._free.pop()
        self.active[idx] = True
        self.matrices[idx] = np.eye(4, dtype=np.float32)
        self.skin_ids[idx] = -1
        self.changed[idx] = True
        self.any_changed = True
        return InstanceHandle3D(self, idx)

    def erase(self, idx: int) -> None:
        if not self.active[idx]:
            raise KeyError(f"instance {idx} not active")
        self.active[idx] = False
        self.changed[idx] = True
        self.any_changed = True
        self._free.append(idx)

    def set_matrix(self, idx: int, matrix: np.ndarray) -> None:
        self.matrices[idx] = matrix
        self.changed[idx] = True
        self.any_changed = True

    def set_skin(self, idx: int, skin_id: int) -> None:
        self.skin_ids[idx] = skin_id
        self.changed[idx] = True
        self.any_changed = True

    def set_morph_weights(self, idx: int, w: np.ndarray) -> None:
        w = np.asarray(w, np.float32).reshape(-1)
        if self.morph_weights is None or self.morph_weights.shape[1] < w.shape[0]:
            mw = np.zeros((self.capacity, w.shape[0]), np.float32)
            if self.morph_weights is not None:
                mw[:, : self.morph_weights.shape[1]] = self.morph_weights
            self.morph_weights = mw
        if np.array_equal(self.morph_weights[idx, : w.shape[0]], w):
            return
        self.morph_weights[idx, : w.shape[0]] = w
        self.changed[idx] = True
        self.any_changed = True

    def active_matrices(self) -> np.ndarray:
        return self.matrices[self.active]

    def view(self, local_aabb_min: np.ndarray, local_aabb_max: np.ndarray) -> InstancesView3D:
        """Lower to the backend view: active slots only, dense."""
        sel = self.active
        return InstancesView3D(
            matrices=np.ascontiguousarray(self.matrices[sel]),
            skin_ids=np.ascontiguousarray(self.skin_ids[sel]),
            changed=np.ascontiguousarray(self.changed[sel]),
            local_aabb_min=np.asarray(local_aabb_min, np.float32),
            local_aabb_max=np.asarray(local_aabb_max, np.float32),
            morph_weights=(None if self.morph_weights is None
                           else np.ascontiguousarray(self.morph_weights[sel])),
        )

    def reset_changed(self) -> None:
        self.changed[:] = False
        self.any_changed = False


@dataclass
class InstanceHandle3D:
    """Write-through handle (reference InstanceHandle3D)."""

    _list: InstanceList3D
    index: int

    def set_matrix(self, matrix: np.ndarray) -> "InstanceHandle3D":
        self._list.set_matrix(self.index, np.asarray(matrix, np.float32))
        return self

    def set_morph_weights(self, w: np.ndarray) -> "InstanceHandle3D":
        self._list.set_morph_weights(self.index, w)
        return self

    def transform(self) -> "TransformGuard":
        """Builder-style batched transform edit (reference Transform guard,
        instances_3d.rs — accumulate T/R/S, write once on Drop):

            with h.transform() as t:
                t.translate((1, 0, 0)).rotate_y(0.3).scale(2.0)
        """
        return TransformGuard(self)

    def set_trs(self, translation, rotation, scale) -> "InstanceHandle3D":
        m = compose_trs(
            np.asarray(translation, np.float32),
            np.asarray(rotation, np.float32),
            np.asarray(scale, np.float32),
        )
        return self.set_matrix(m)

    def set_skin(self, skin_id: int) -> "InstanceHandle3D":
        self._list.set_skin(self.index, skin_id)
        return self

    def get_matrix(self) -> np.ndarray:
        return self._list.matrices[self.index].copy()

    def remove(self) -> None:
        self._list.erase(self.index)


class InstanceList2D:
    """2D twin (reference instances_2d.rs)."""

    def __init__(self) -> None:
        self.matrices = np.zeros((0, 4, 4), np.float32)
        self.active = np.zeros(0, bool)
        self.changed = np.zeros(0, bool)
        self._free: List[int] = []
        self.any_changed = False

    def __len__(self) -> int:
        return int(self.active.sum())

    def _grow(self) -> None:
        cap = self.matrices.shape[0]
        new_cap = max(_GROW, cap * 2)
        self.matrices = np.concatenate(
            [self.matrices, np.tile(np.eye(4, dtype=np.float32), (new_cap - cap, 1, 1))]
        )
        self.active = np.concatenate([self.active, np.zeros(new_cap - cap, bool)])
        self.changed = np.concatenate([self.changed, np.zeros(new_cap - cap, bool)])
        self._free.extend(range(new_cap - 1, cap - 1, -1))

    def allocate(self) -> "InstanceHandle2D":
        if not self._free:
            self._grow()
        idx = self._free.pop()
        self.active[idx] = True
        self.matrices[idx] = np.eye(4, dtype=np.float32)
        self.changed[idx] = True
        self.any_changed = True
        return InstanceHandle2D(self, idx)

    def erase(self, idx: int) -> None:
        self.active[idx] = False
        self.changed[idx] = True
        self.any_changed = True
        self._free.append(idx)

    def set_matrix(self, idx: int, matrix: np.ndarray) -> None:
        self.matrices[idx] = matrix
        self.changed[idx] = True
        self.any_changed = True

    def view(self) -> InstancesView2D:
        sel = self.active
        return InstancesView2D(
            matrices=np.ascontiguousarray(self.matrices[sel]),
            changed=np.ascontiguousarray(self.changed[sel]),
        )

    def reset_changed(self) -> None:
        self.changed[:] = False
        self.any_changed = False


@dataclass
class InstanceHandle2D:
    _list: InstanceList2D
    index: int

    def set_matrix(self, matrix: np.ndarray) -> "InstanceHandle2D":
        self._list.set_matrix(self.index, np.asarray(matrix, np.float32))
        return self

    def remove(self) -> None:
        self._list.erase(self.index)


class TransformGuard:
    """Accumulates TRS edits and writes the composed matrix exactly once on
    context exit — one dirty-bit flip per batch of edits (reference's
    Drop-guard Transform, crates/rfw-scene/src/instances_3d.rs)."""

    def __init__(self, handle: InstanceHandle3D) -> None:
        self._h = handle
        self._t = np.zeros(3, np.float32)
        self._r = np.array([0, 0, 0, 1], np.float32)
        self._s = np.ones(3, np.float32)

    def translate(self, t) -> "TransformGuard":
        self._t = self._t + np.asarray(t, np.float32)
        return self

    def rotate(self, quat) -> "TransformGuard":
        from rfw_tpu_torch.mathx import quat_mul, quat_normalize

        self._r = quat_normalize(quat_mul(np.asarray(quat, np.float32), self._r))
        return self

    def rotate_y(self, angle: float) -> "TransformGuard":
        h = 0.5 * float(angle)
        return self.rotate(np.array([0, np.sin(h), 0, np.cos(h)], np.float32))

    def scale(self, s) -> "TransformGuard":
        s = np.asarray(s, np.float32)
        self._s = self._s * (np.full(3, s, np.float32) if s.ndim == 0 else s)
        return self

    def __enter__(self) -> "TransformGuard":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self._h.set_matrix(compose_trs(self._t, self._r, self._s))
