"""Light SoA views (host copy of `rfw_tpu/backend/lights.py`): point,
spot, directional and area lights as parallel float32 arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _empty(n: int, tail: tuple = ()) -> np.ndarray:
    return np.zeros((n,) + tail, dtype=np.float32)


@dataclass
class PointLightsView:
    position: np.ndarray  # (N,3)
    energy: np.ndarray  # (N,3)  radiant intensity (rgb)
    changed: np.ndarray  # (N,) bool

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def empty() -> "PointLightsView":
        return PointLightsView(_empty(0, (3,)), _empty(0, (3,)), np.zeros(0, bool))


@dataclass
class SpotLightsView:
    position: np.ndarray  # (N,3)
    direction: np.ndarray  # (N,3) normalized
    energy: np.ndarray  # (N,3)
    cos_inner: np.ndarray  # (N,)
    cos_outer: np.ndarray  # (N,)
    changed: np.ndarray  # (N,) bool

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def empty() -> "SpotLightsView":
        return SpotLightsView(
            _empty(0, (3,)), _empty(0, (3,)), _empty(0, (3,)), _empty(0), _empty(0),
            np.zeros(0, bool),
        )


@dataclass
class DirectionalLightsView:
    direction: np.ndarray  # (N,3) normalized, pointing *from* the light
    energy: np.ndarray  # (N,3) irradiance (rgb)
    changed: np.ndarray  # (N,) bool

    @property
    def count(self) -> int:
        return self.direction.shape[0]

    @staticmethod
    def empty() -> "DirectionalLightsView":
        return DirectionalLightsView(_empty(0, (3,)), _empty(0, (3,)), np.zeros(0, bool))


@dataclass
class AreaLightsView:
    """One entry per emissive triangle per instance, world-space (reference
    AreaLight struct + extraction at rfw-scene/src/lib.rs:575-648)."""

    position: np.ndarray  # (N,3) triangle centroid
    normal: np.ndarray  # (N,3) geometric normal
    energy: np.ndarray  # (N,3) emitted radiance * area (integrated power proxy)
    radiance: np.ndarray  # (N,3) emitted radiance (rgb)
    area: np.ndarray  # (N,)
    v0: np.ndarray  # (N,3)
    v1: np.ndarray  # (N,3)
    v2: np.ndarray  # (N,3)
    inst_id: np.ndarray  # (N,) i32
    mesh_id: np.ndarray  # (N,) i32
    tri_id: np.ndarray  # (N,) i32  (triangle index within the mesh)
    changed: np.ndarray  # (N,) bool

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def empty() -> "AreaLightsView":
        z3 = _empty(0, (3,))
        zi = np.zeros(0, np.int32)
        return AreaLightsView(
            z3, z3, z3, z3, _empty(0), z3, z3, z3, zi, zi, zi, np.zeros(0, bool)
        )
