"""Axis-aligned bounding boxes, batch-first (reference: external rtbvh `Aabb`).

An Aabb batch is a pair of float32 arrays ``(min: (...,3), max: (...,3))``.
Empty boxes use +inf/-inf sentinels like rtbvh.

Host copy of `rfw_tpu/mathx/aabb.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Aabb(NamedTuple):
    min: np.ndarray  # (..., 3) float32
    max: np.ndarray  # (..., 3) float32

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self.min + self.max)

    @property
    def extent(self) -> np.ndarray:
        return self.max - self.min

    def area(self) -> np.ndarray:
        """Surface area (for SAH)."""
        e = np.maximum(self.max - self.min, 0.0)
        return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0])


def aabb_empty(shape: tuple = ()) -> Aabb:
    return Aabb(
        np.full(shape + (3,), np.inf, dtype=np.float32),
        np.full(shape + (3,), -np.inf, dtype=np.float32),
    )


def aabb_from_points(p: np.ndarray, axis: int = -2) -> Aabb:
    return Aabb(p.min(axis=axis).astype(np.float32), p.max(axis=axis).astype(np.float32))


def aabb_union(a: Aabb, b: Aabb) -> Aabb:
    return Aabb(np.minimum(a.min, b.min), np.maximum(a.max, b.max))


def aabb_transform(box: Aabb, m: np.ndarray) -> Aabb:
    """Transform AABBs by matrices -> world AABBs of the 8 corners.

    box: (...,3)/(...,3); m: (...,4,4). Used for TLAS refit from instance
    matrices (reference gpu-rt/src/lib.rs:1570-1581 builds TLAS from
    transformed instance bounds)."""
    mn, mx = box.min, box.max
    # (...,8,3) corners
    corners = np.stack(
        [
            np.stack([np.where(bit & 1, mx[..., 0], mn[..., 0]),
                      np.where(bit & 2, mx[..., 1], mn[..., 1]),
                      np.where(bit & 4, mx[..., 2], mn[..., 2])], axis=-1)
            for bit in range(8)
        ],
        axis=-2,
    ).astype(np.float32)
    world = np.einsum("...ij,...nj->...ni", m[..., :3, :3], corners) + m[..., None, :3, 3]
    return Aabb(world.min(axis=-2).astype(np.float32), world.max(axis=-2).astype(np.float32))
