"""3D camera (host copy of `Camera3D` from `rfw_tpu/scene/camera.py`):
pos/dir/fov/aperture/focal distance/near/far, with `get_view()` computing
the p1/right/up screen-corner parameterization and the spread angle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import numpy as np

from rfw_tpu_torch.backend.structs import CameraView3D
from rfw_tpu_torch.mathx import normalize


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

    def look_at(self, origin: np.ndarray, target: np.ndarray) -> "Camera3D":
        self.position = np.asarray(origin, np.float32)
        self.direction = normalize(np.asarray(target, np.float32) - self.position)
        return self
