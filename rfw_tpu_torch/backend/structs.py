"""SoA data views crossing the scene->renderer boundary (host numpy).

Copy of the parts of `rfw_tpu/backend/structs.py` the renderer needs:
the material block and the camera view. The JAX package registers
`DeviceMaterials` as a pytree; here it is a plain dataclass whose fields are
numpy arrays on the host and tensors after `rfw_tpu_torch.convert`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _check(arr: np.ndarray, shape_tail: tuple, dtype, name: str) -> None:
    if arr.dtype != dtype:
        raise TypeError(f"{name}: expected dtype {dtype}, got {arr.dtype}")
    if arr.shape[1:] != shape_tail:
        raise TypeError(f"{name}: expected trailing shape {shape_tail}, got {arr.shape[1:]}")


# Material flag bits (reference MaterialFlags)
MATFLAG_HAS_DIFFUSE_MAP = 1 << 0
MATFLAG_HAS_NORMAL_MAP = 1 << 1
MATFLAG_HAS_ROUGHNESS_MAP = 1 << 2
MATFLAG_HAS_METALLIC_MAP = 1 << 3
MATFLAG_HAS_EMISSIVE_MAP = 1 << 4
MATFLAG_HAS_SHEEN_MAP = 1 << 5
MATFLAG_EMISSIVE = 1 << 6


@dataclass
class DeviceMaterials:
    """SoA materials.

    color/specular/absorption: (N,4) f32; params: (N,16) f32 columns
    metallic, subsurface, specular_f, roughness, specular_tint, anisotropic,
    sheen, sheen_tint, clearcoat, clearcoat_gloss, transmission, eta,
    custom0..3; flags: (N,) i32 bitfield; tex: (N,6) i32 texture
    ids (diffuse, normal, metallic_roughness, emissive, sheen, custom),
    -1 = none.
    """

    color: np.ndarray
    specular: np.ndarray
    absorption: np.ndarray
    params: np.ndarray
    flags: np.ndarray
    tex: np.ndarray

    @property
    def count(self) -> int:
        return self.color.shape[0]

    def validate(self) -> "DeviceMaterials":
        _check(self.color, (4,), np.float32, "mat.color")
        _check(self.specular, (4,), np.float32, "mat.specular")
        _check(self.absorption, (4,), np.float32, "mat.absorption")
        _check(self.params, (16,), np.float32, "mat.params")
        _check(self.tex, (6,), np.int32, "mat.tex")
        if self.flags.dtype != np.int32:
            raise TypeError("mat.flags must be int32")
        return self


@dataclass
class CameraView3D:
    """Ray-generation-ready camera: a primary ray for pixel (x, y) with
    jitter (u, v) is ``dir = normalize(p1 + r*right + s*up - pos)`` where
    ``r = (x+u) * inv_width``, ``s = (y+v) * inv_height``."""

    pos: np.ndarray  # (3,)
    right: np.ndarray  # (3,)  spans the full screen width
    up: np.ndarray  # (3,)   spans the full screen height
    p1: np.ndarray  # (3,)   top-left corner of the virtual screen
    direction: np.ndarray  # (3,)
    lens_size: float
    spread_angle: float
    inv_width: float
    inv_height: float
    near_plane: float
    far_plane: float
    aspect_ratio: float
    fov: float  # radians, full vertical fov

    def as_array(self) -> np.ndarray:
        """Flatten to the (24,) f32 view vector `render_sample` takes."""
        return np.concatenate(
            [
                self.pos, self.right, self.up, self.p1, self.direction,
                np.array(
                    [
                        self.lens_size, self.spread_angle, self.inv_width,
                        self.inv_height, self.near_plane, self.far_plane,
                        self.aspect_ratio, self.fov, 0.0,
                    ],
                    dtype=np.float32,
                ),
            ]
        ).astype(np.float32)
