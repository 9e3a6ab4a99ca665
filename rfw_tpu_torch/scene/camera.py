"""Cameras + frustum culling.

Reference: crates/rfw-scene/src/camera/mod.rs — `Camera3D` (pos/dir/fov/
aperture/focal distance/near/far/speed) with `get_view()` computing the
p1/right/up screen-corner parameterization + spread_angle (:78-117), the
relative/target translation helpers (:160-186), and `Camera2D::
from_width_height` (:300-345); frustum planes in camera/frustrum.rs:1-246.

Host copy of `rfw_tpu/scene/camera.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from rfw_tpu_torch.backend.structs import CameraView2D, CameraView3D
from rfw_tpu_torch.mathx import (
    look_at_rh,
    normalize,
    orthographic_rh,
    perspective_rh,
)


@dataclass
class Camera3D:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = field(default_factory=lambda: np.array([0, 0, -1], np.float32))
    fov: float = 60.0  # degrees, vertical
    aperture: float = 0.0001
    focal_distance: float = 1.0
    near_plane: float = 0.01
    far_plane: float = 1e5
    speed: float = 1.0

    # ---- view ----------------------------------------------------------
    def get_view(self, width: int, height: int) -> CameraView3D:
        """Ray-gen parameterization (reference get_view :78-117):
        dir(x,y) = normalize(p1 + r*right + s*up - pos) with r,s in [0,1)."""
        pos = self.position.astype(np.float32)
        z = normalize(self.direction.astype(np.float32))
        world_up = np.array([0, 1, 0], np.float32)
        if abs(float(np.dot(z, world_up))) > 0.999:
            world_up = np.array([0, 0, 1], np.float32)
        x = normalize(np.cross(z, world_up))
        y = np.cross(x, z)

        aspect = width / max(height, 1)
        fov_rad = np.deg2rad(self.fov)
        half_h = float(np.tan(0.5 * fov_rad))
        half_w = half_h * aspect
        fd = max(self.focal_distance, 1e-4)

        center = pos + z * fd
        p1 = center - x * half_w * fd + y * half_h * fd  # top-left
        right = 2.0 * half_w * fd * x  # spans full width
        up = -2.0 * half_h * fd * y  # spans full height, downward with +py

        spread_angle = fov_rad / max(height, 1)
        return CameraView3D(
            pos=pos,
            right=right.astype(np.float32),
            up=up.astype(np.float32),
            p1=p1.astype(np.float32),
            direction=z,
            lens_size=float(self.aperture),
            spread_angle=float(spread_angle),
            inv_width=1.0 / max(width, 1),
            inv_height=1.0 / max(height, 1),
            near_plane=float(self.near_plane),
            far_plane=float(self.far_plane),
            aspect_ratio=float(aspect),
            fov=float(fov_rad),
        )

    def view_matrix(self) -> np.ndarray:
        return look_at_rh(self.position, self.position + self.direction, np.array([0, 1, 0], np.float32))

    def projection(self, width: int, height: int) -> np.ndarray:
        return perspective_rh(
            np.deg2rad(self.fov), width / max(height, 1), self.near_plane, self.far_plane
        )

    def view_projection(self, width: int, height: int) -> np.ndarray:
        return (self.projection(width, height) @ self.view_matrix()).astype(np.float32)

    # ---- movement (reference :160-186) ---------------------------------
    def translate_relative(self, delta: np.ndarray) -> None:
        """Move in camera space: x = strafe, y = up, z = forward."""
        delta = np.asarray(delta, np.float32) * self.speed
        z = normalize(self.direction)
        up = np.array([0, 1, 0], np.float32)
        x = normalize(np.cross(z, up))
        y = np.cross(x, z)
        self.position = (self.position + x * delta[0] + y * delta[1] + z * delta[2]).astype(
            np.float32
        )

    def translate_target(self, delta: np.ndarray) -> None:
        """Rotate the view direction by yaw/pitch deltas."""
        delta = np.asarray(delta, np.float32)
        z = normalize(self.direction)
        up = np.array([0, 1, 0], np.float32)
        x = normalize(np.cross(z, up))
        y = np.cross(x, z)
        self.direction = normalize(z + x * delta[0] + y * delta[1]).astype(np.float32)

    def look_at(self, origin: np.ndarray, target: np.ndarray) -> "Camera3D":
        self.position = np.asarray(origin, np.float32)
        self.direction = normalize(np.asarray(target, np.float32) - self.position)
        return self


@dataclass
class Camera2D:
    """Pixel-space 2D overlay camera (reference Camera2D :300-345)."""

    matrix: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))

    @staticmethod
    def from_width_height(width: int, height: int, scale: float = 1.0) -> "Camera2D":
        w = max(width, 1) / scale
        h = max(height, 1) / scale
        # pixel coords (0,0) top-left -> NDC; y flipped
        m = orthographic_rh(0.0, w, h, 0.0, -1.0, 1.0)
        return Camera2D(matrix=m)

    def get_view(self) -> CameraView2D:
        return CameraView2D(matrix=self.matrix.astype(np.float32))


# ----------------------------------------------------------------- frustum
class FrustumResult(Enum):
    OUTSIDE = 0
    INTERSECT = 1
    INSIDE = 2


class Frustum:
    """Six planes extracted from a view-projection matrix
    (reference FrustrumG, camera/frustrum.rs)."""

    def __init__(self, vp: np.ndarray) -> None:
        m = np.asarray(vp, np.float32)
        rows = [m[3] + m[0], m[3] - m[0], m[3] + m[1], m[3] - m[1], m[3] + m[2], m[3] - m[2]]
        planes = np.stack(rows)  # (6,4): n.x,n.y,n.z,d
        n = np.linalg.norm(planes[:, :3], axis=-1, keepdims=True)
        self.planes = planes / np.maximum(n, 1e-12)

    def point(self, p: np.ndarray) -> FrustumResult:
        d = self.planes[:, :3] @ np.asarray(p, np.float32) + self.planes[:, 3]
        return FrustumResult.INSIDE if (d >= 0).all() else FrustumResult.OUTSIDE

    def sphere(self, center: np.ndarray, radius: float) -> FrustumResult:
        d = self.planes[:, :3] @ np.asarray(center, np.float32) + self.planes[:, 3]
        if (d < -radius).any():
            return FrustumResult.OUTSIDE
        if (d >= radius).all():
            return FrustumResult.INSIDE
        return FrustumResult.INTERSECT

    def aabb(self, mn: np.ndarray, mx: np.ndarray) -> FrustumResult:
        mn = np.asarray(mn, np.float32)
        mx = np.asarray(mx, np.float32)
        n = self.planes[:, :3]
        # p-vertex / n-vertex test
        pv = np.where(n > 0, mx, mn)
        nv = np.where(n > 0, mn, mx)
        d_pv = np.sum(n * pv, axis=-1) + self.planes[:, 3]
        d_nv = np.sum(n * nv, axis=-1) + self.planes[:, 3]
        if (d_pv < 0).any():
            return FrustumResult.OUTSIDE
        if (d_nv >= 0).all():
            return FrustumResult.INSIDE
        return FrustumResult.INTERSECT

    def aabb_batch(self, mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
        """Vectorized visibility over (N,3) boxes -> bool visible array."""
        n = self.planes[:, :3]  # (6,3)
        pv = np.where(n[None] > 0, mx[:, None, :], mn[:, None, :])  # (N,6,3)
        d_pv = np.sum(n[None] * pv, axis=-1) + self.planes[None, :, 3]
        return ~(d_pv < 0).any(axis=-1)
