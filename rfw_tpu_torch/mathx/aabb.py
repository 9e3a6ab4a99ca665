"""Axis-aligned bounding boxes, batch-first (host copy of
`rfw_tpu/mathx/aabb.py`). An Aabb batch is a pair of float32 arrays
``(min: (...,3), max: (...,3))``."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Aabb(NamedTuple):
    min: np.ndarray  # (..., 3) float32
    max: np.ndarray  # (..., 3) float32


def aabb_transform(box: Aabb, m: np.ndarray) -> Aabb:
    """Transform AABBs by matrices -> world AABBs of the 8 corners.

    box: (...,3)/(...,3); m: (...,4,4)."""
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
