"""Light containers + shadow projections + area-light extraction.

Reference: `Lights` = four TrackedStorages (rfw-scene/src/lib.rs:100-118);
per-type shadow projection matrices + 256B-aligned `LightInfo`
(src/lights/mod.rs:8-279); area-light extraction scans emissive-material
mesh ranges and instantiates one AreaLight per emissive triangle per
instance, back-writing `light_id` into the triangles (src/lib.rs:575-648).

TPU re-design: extraction is a *vectorized gather* over the packed triangle
arena rather than nested loops, and the result is SoA (AreaLightsView).
Shadow matrices remain host-side (they are per-light scalars).

Host copy of `rfw_tpu/scene/lights.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from rfw_tpu_torch.backend.lights import (
    AreaLightsView,
    DirectionalLightsView,
    PointLightsView,
    SpotLightsView,
)
from rfw_tpu_torch.mathx import look_at_rh, normalize, orthographic_rh, perspective_rh
from rfw_tpu_torch.utils.collections import TrackedStorage


@dataclass
class PointLight:
    position: np.ndarray
    energy: np.ndarray  # rgb radiant intensity

    def cube_matrices(self, near: float = 0.1, far: float = 100.0) -> np.ndarray:
        """Six 90-degree view-projections (+X -X +Y -Y +Z -Z) for omni shadow
        rendering (reference PointLight cube matrices, rfw-backend/src/
        lights.rs:137-180). Returns (6, 4, 4) f32."""
        p = self.position.astype(np.float32)
        proj = perspective_rh(np.pi / 2.0, 1.0, near, far)
        dirs = np.array(
            [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
            np.float32,
        )
        mats = [
            (proj @ look_at_rh(p, p + d, _up_for(d))).astype(np.float32) for d in dirs
        ]
        return np.stack(mats)


@dataclass
class SpotLight:
    position: np.ndarray
    direction: np.ndarray
    energy: np.ndarray
    inner_angle: float  # degrees
    outer_angle: float  # degrees

    @property
    def cos_inner(self) -> float:
        return float(np.cos(np.deg2rad(self.inner_angle)))

    @property
    def cos_outer(self) -> float:
        return float(np.cos(np.deg2rad(self.outer_angle)))

    def shadow_matrix(self, near: float = 0.1, far: float = 100.0) -> np.ndarray:
        """Perspective from outer cone (reference lights/mod.rs spot pm)."""
        fov = 2.0 * np.arccos(np.clip(self.cos_outer, -1, 1))
        proj = perspective_rh(float(fov), 1.0, near, far)
        view = look_at_rh(self.position, self.position + self.direction, _up_for(self.direction))
        return (proj @ view).astype(np.float32)


@dataclass
class DirectionalLight:
    direction: np.ndarray
    energy: np.ndarray

    def shadow_matrix(self, scene_min: np.ndarray, scene_max: np.ndarray) -> np.ndarray:
        """Ortho fitted to the scene AABB (reference directional pm)."""
        center = 0.5 * (scene_min + scene_max)
        radius = 0.5 * float(np.linalg.norm(scene_max - scene_min)) + 1e-3
        d = normalize(self.direction.astype(np.float32))
        eye = center - d * radius * 1.5
        view = look_at_rh(eye, center, _up_for(d))
        proj = orthographic_rh(-radius, radius, -radius, radius, 0.01, 4.0 * radius)
        return (proj @ view).astype(np.float32)


def area_light_shadow_matrix(
    position: np.ndarray, normal: np.ndarray, near: float = 0.1, far: float = 100.0
) -> np.ndarray:
    """150-degree perspective along the emitter normal (reference area-light
    pm, rfw-scene/src/lights/mod.rs area impl)."""
    p = position.astype(np.float32)
    n = normalize(normal.astype(np.float32))
    proj = perspective_rh(float(np.deg2rad(150.0)), 1.0, near, far)
    view = look_at_rh(p, p + n, _up_for(n))
    return (proj @ view).astype(np.float32)


def pack_light_info(pm: np.ndarray, position: np.ndarray, rng: float) -> np.ndarray:
    """256-byte-aligned LightInfo {pm: mat4, pos: vec3, range: f32, pad}
    (reference LightInfo, rfw-scene/src/lights/mod.rs:8-279 and its
    size/alignment test :280-287). Returns a (64,) f32 block (256 bytes)."""
    out = np.zeros(64, np.float32)
    out[:16] = np.asarray(pm, np.float32).reshape(16)
    out[16:19] = np.asarray(position, np.float32).reshape(3)
    out[19] = np.float32(rng)
    return out


def _up_for(direction: np.ndarray) -> np.ndarray:
    d = normalize(np.asarray(direction, np.float32))
    return (
        np.array([0, 1, 0], np.float32)
        if abs(float(d[1])) < 0.99
        else np.array([1, 0, 0], np.float32)
    )


class Lights:
    """Four tracked light pools (reference Lights container)."""

    def __init__(self) -> None:
        self.point: TrackedStorage[PointLight] = TrackedStorage()
        self.spot: TrackedStorage[SpotLight] = TrackedStorage()
        self.directional: TrackedStorage[DirectionalLight] = TrackedStorage()
        # area lights are derived (extraction), stored dense
        self.area: AreaLightsView = AreaLightsView.empty()
        self.area_changed = False

    # ---- lowering ------------------------------------------------------
    def point_view(self) -> PointLightsView:
        items = [l for _, l in self.point]
        if not items:
            return PointLightsView.empty()
        return PointLightsView(
            position=np.stack([l.position for l in items]).astype(np.float32),
            energy=np.stack([l.energy for l in items]).astype(np.float32),
            changed=np.ones(len(items), bool),
        )

    def spot_view(self) -> SpotLightsView:
        items = [l for _, l in self.spot]
        if not items:
            return SpotLightsView.empty()
        return SpotLightsView(
            position=np.stack([l.position for l in items]).astype(np.float32),
            direction=np.stack([normalize(l.direction) for l in items]).astype(np.float32),
            energy=np.stack([l.energy for l in items]).astype(np.float32),
            cos_inner=np.array([l.cos_inner for l in items], np.float32),
            cos_outer=np.array([l.cos_outer for l in items], np.float32),
            changed=np.ones(len(items), bool),
        )

    def directional_view(self) -> DirectionalLightsView:
        items = [l for _, l in self.directional]
        if not items:
            return DirectionalLightsView.empty()
        return DirectionalLightsView(
            direction=np.stack([normalize(l.direction) for l in items]).astype(np.float32),
            energy=np.stack([l.energy for l in items]).astype(np.float32),
            changed=np.ones(len(items), bool),
        )

    @property
    def any_changed(self) -> bool:
        return (
            self.point.any_changed
            or self.spot.any_changed
            or self.directional.any_changed
            or self.area_changed
        )

    def reset_changed(self) -> None:
        self.point.reset_changed()
        self.spot.reset_changed()
        self.directional.reset_changed()
        self.area_changed = False


def extract_area_lights(
    emissive_mask_per_tri: np.ndarray,  # (T,) bool over a mesh's triangles
    radiance_per_tri: np.ndarray,  # (T,3) material emission
    tri_verts: np.ndarray,  # (T,3,3) object-space corners
    instance_matrices: np.ndarray,  # (I,4,4)
    mesh_id: int,
    inst_ids: np.ndarray,  # (I,) global instance ids
) -> Tuple[AreaLightsView, np.ndarray]:
    """Vectorized area-light extraction for one mesh (reference
    update_lights, rfw-scene/src/lib.rs:575-648).

    Returns (lights, light_id_per_tri) where light_id_per_tri is the
    *per-mesh-triangle* id of the light for the FIRST instance (-1 for
    non-emissive); the packed per-instance lights enumerate instances in
    order so light_id for instance k of triangle t = base_of_k + rank(t).
    """
    sel = np.nonzero(emissive_mask_per_tri)[0]
    n_e = len(sel)
    n_i = instance_matrices.shape[0]
    if n_e == 0 or n_i == 0:
        return AreaLightsView.empty(), np.full(len(emissive_mask_per_tri), -1, np.int32)

    v = tri_verts[sel]  # (E,3,3)
    # world transform per instance: (I,1,3,3) x (E,3,3)
    rot = instance_matrices[:, None, :3, :3]  # (I,1,3,3)
    trans = instance_matrices[:, None, None, :3, 3]  # (I,1,1,3)
    wv = np.einsum("ieab,ekb->ieka", np.broadcast_to(rot, (n_i, n_e, 3, 3)), v) + trans
    wv = wv.reshape(n_i * n_e, 3, 3).astype(np.float32)

    e1 = wv[:, 1] - wv[:, 0]
    e2 = wv[:, 2] - wv[:, 0]
    cr = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cr, axis=-1)
    nrm = cr / np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True), 1e-20)
    center = wv.mean(axis=1)
    radiance = np.tile(radiance_per_tri[sel], (n_i, 1)).astype(np.float32)

    lights = AreaLightsView(
        position=center.astype(np.float32),
        normal=nrm.astype(np.float32),
        energy=(radiance * area[:, None] * np.pi).astype(np.float32),
        radiance=radiance,
        area=area.astype(np.float32),
        v0=wv[:, 0], v1=wv[:, 1], v2=wv[:, 2],
        inst_id=np.repeat(inst_ids.astype(np.int32), n_e),
        mesh_id=np.full(n_i * n_e, mesh_id, np.int32),
        tri_id=np.tile(sel.astype(np.int32), n_i),
        changed=np.ones(n_i * n_e, bool),
    )
    light_id = np.full(len(emissive_mask_per_tri), -1, np.int32)
    light_id[sel] = np.arange(n_e, dtype=np.int32)
    return lights, light_id
