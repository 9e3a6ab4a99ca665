"""2D overlay meshes (copy of `rfw_tpu/models/mesh2d.py`; reference crates/rfw-scene/src/objects_2d/mod.rs:10-94).

Vertex2D = position(x, y, layer) + uv + per-vertex rgba color; drawn by the
backend's 2D compositor after tonemapping.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from rfw_tpu_torch.backend.structs import INVALID_ID, MeshView2D


@dataclass
class Mesh2D:
    positions: np.ndarray  # (V,3) f32
    uvs: np.ndarray  # (V,2) f32
    colors: np.ndarray  # (V,4) f32
    texture_id: int = INVALID_ID
    name: str = ""

    @staticmethod
    def new(
        positions: np.ndarray,
        uvs: np.ndarray | None = None,
        colors: np.ndarray | None = None,
        texture_id: int = INVALID_ID,
        name: str = "",
    ) -> "Mesh2D":
        positions = np.ascontiguousarray(positions, np.float32)
        n = positions.shape[0]
        if positions.shape[1] == 2:  # allow (V,2), layer 0
            positions = np.concatenate([positions, np.zeros((n, 1), np.float32)], axis=1)
        if uvs is None:
            uvs = np.zeros((n, 2), np.float32)
        if colors is None:
            colors = np.ones((n, 4), np.float32)
        return Mesh2D(
            positions,
            np.ascontiguousarray(uvs, np.float32),
            np.ascontiguousarray(colors, np.float32),
            texture_id,
            name,
        )

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    def view(self) -> MeshView2D:
        return MeshView2D(
            positions=self.positions,
            uvs=self.uvs,
            colors=self.colors,
            texture_id=self.texture_id,
            name=self.name,
        ).validate()
