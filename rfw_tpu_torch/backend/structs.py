"""SoA data views crossing the scene->backend boundary (host numpy).

Copy of `rfw_tpu/backend/structs.py`: mesh, instance, skin, texture,
material and camera views, each structure-of-arrays numpy on the host.
The JAX package registers `DeviceMaterials` as a pytree; here it is a
plain dataclass whose fields are numpy arrays on the host and tensors
after `rfw_tpu_torch.convert`. Dtype/shape invariants are asserted in
``validate()`` methods.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

INVALID_ID = -1  # reference MeshId3D INVALID (structs.rs:61-188)


def _check(arr: np.ndarray, shape_tail: tuple, dtype, name: str) -> None:
    if arr.dtype != dtype:
        raise TypeError(f"{name}: expected dtype {dtype}, got {arr.dtype}")
    if arr.shape[1:] != shape_tail:
        raise TypeError(f"{name}: expected trailing shape {shape_tail}, got {arr.shape[1:]}")


# --------------------------------------------------------------------- meshes
@dataclass
class MeshView3D:
    """SoA 3D mesh view (reference MeshData3D + RTTriangle content).

    `indices[t] = (i0,i1,i2)` into the vertex arrays; `tri_material[t]` is the
    per-triangle material id (reference RTTriangle.mat_id); `tri_light[t]` is
    the area-light id back-written by light extraction (reference
    rfw-scene/src/lib.rs:575-648), -1 if not emissive.
    `ranges` are per-material sub-meshes (reference VertexMesh :272-304):
    rows of (first_tri, tri_count, material_id).
    """

    positions: np.ndarray  # (V,3) f32
    normals: np.ndarray  # (V,3) f32
    uvs: np.ndarray  # (V,2) f32
    tangents: np.ndarray  # (V,4) f32  (xyz tangent, w handedness)
    indices: np.ndarray  # (T,3) i32
    tri_material: np.ndarray  # (T,)  i32
    tri_light: np.ndarray  # (T,)  i32   (-1 = not a light)
    ranges: np.ndarray  # (R,3) i32   first_tri, tri_count, material_id
    joints: Optional[np.ndarray] = None  # (V,4) i32
    weights: Optional[np.ndarray] = None  # (V,4) f32
    aabb_min: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    aabb_max: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    name: str = ""
    morph_targets: Optional[np.ndarray] = None  # (K,V,3) f32 position deltas
    morph_normals: Optional[np.ndarray] = None  # (K,V,3) f32 NORMAL deltas
    morph_tangents: Optional[np.ndarray] = None  # (K,V,3) f32 TANGENT deltas

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def has_skin(self) -> bool:
        return self.joints is not None and self.weights is not None

    @property
    def has_morphs(self) -> bool:
        return self.morph_targets is not None and len(self.morph_targets) > 0

    def validate(self) -> "MeshView3D":
        _check(self.positions, (3,), np.float32, "positions")
        _check(self.normals, (3,), np.float32, "normals")
        _check(self.uvs, (2,), np.float32, "uvs")
        _check(self.tangents, (4,), np.float32, "tangents")
        _check(self.indices, (3,), np.int32, "indices")
        _check(self.ranges, (3,), np.int32, "ranges")
        if self.tri_material.dtype != np.int32 or self.tri_light.dtype != np.int32:
            raise TypeError("tri_material/tri_light must be int32")
        if self.has_skin:
            _check(self.joints, (4,), np.int32, "joints")
            _check(self.weights, (4,), np.float32, "weights")
        if self.has_morphs:
            if (self.morph_targets.dtype != np.float32
                    or self.morph_targets.shape[1:] != self.positions.shape):
                raise TypeError("morph_targets must be (K,V,3) float32")
        return self


@dataclass
class MeshView2D:
    """2D overlay mesh (reference MeshData2D: Vertex2D = pos3 + uv + color)."""

    positions: np.ndarray  # (V,3) f32 (z = layer)
    uvs: np.ndarray  # (V,2) f32
    colors: np.ndarray  # (V,4) f32
    texture_id: int = INVALID_ID
    name: str = ""

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    def validate(self) -> "MeshView2D":
        _check(self.positions, (3,), np.float32, "positions2d")
        _check(self.uvs, (2,), np.float32, "uvs2d")
        _check(self.colors, (4,), np.float32, "colors2d")
        return self


# ------------------------------------------------------------------ instances
@dataclass
class InstancesView3D:
    """Per-mesh instance batch (reference InstancesData3D): world matrices and
    skin ids; `changed` flags which slots the backend must re-upload."""

    matrices: np.ndarray  # (I,4,4) f32
    skin_ids: np.ndarray  # (I,) i32  (-1 = none)
    changed: np.ndarray  # (I,) bool
    local_aabb_min: np.ndarray  # (3,) f32 — the mesh AABB, for TLAS refit
    local_aabb_max: np.ndarray  # (3,) f32
    morph_weights: Optional[np.ndarray] = None  # (I,K) f32 per-instance
    #   morph-target weights (glTF node weights), None when the mesh has none

    @property
    def count(self) -> int:
        return self.matrices.shape[0]


@dataclass
class InstancesView2D:
    matrices: np.ndarray  # (I,4,4) f32
    changed: np.ndarray  # (I,) bool

    @property
    def count(self) -> int:
        return self.matrices.shape[0]


# -------------------------------------------------------------------- skins
@dataclass
class SkinView:
    """Joint matrices ready for LBS (reference SkinData — joint_matrices)."""

    joint_matrices: np.ndarray  # (J,4,4) f32


# ------------------------------------------------------------------ textures
@dataclass
class TextureView:
    """RGBA8 texture with a full mip chain, flattened mips-first.

    The reference stores BGRA8 u32 texels with mip offsets computed by
    ``offset_for_level`` (structs.rs:208-248). Here each mip is a separate
    (h,w,4) uint8 array; the device backend packs them into a mip pyramid
    layout suited to gather-based sampling.
    """

    mips: List[np.ndarray]  # [(H,W,4) u8, (H/2,W/2,4) u8, ...]
    #: color data (albedo/emissive) stored gamma-encoded; False for linear
    #: data (normal maps, metallic-roughness) which must NOT be sRGB-decoded
    srgb: bool = True

    @property
    def width(self) -> int:
        return self.mips[0].shape[1]

    @property
    def height(self) -> int:
        return self.mips[0].shape[0]

    @property
    def mip_levels(self) -> int:
        return len(self.mips)


# ----------------------------------------------------------------- materials
#: Disney parameter block column layout, one row per material. Replaces the
#: reference's 8-bit-packed `parameters: [u32;4]` (structs.rs:414-477) with
#: plain float columns (same 16 logical parameters).
MATERIAL_PARAM_NAMES = (
    "metallic", "subsurface", "specular_f", "roughness",
    "specular_tint", "anisotropic", "sheen", "sheen_tint",
    "clearcoat", "clearcoat_gloss", "transmission", "eta",
    "custom0", "custom1", "custom2", "custom3",
)

# Material flag bits (reference MaterialFlags, rfw-scene/src/material/mod.rs:17-84)
MATFLAG_HAS_DIFFUSE_MAP = 1 << 0
MATFLAG_HAS_NORMAL_MAP = 1 << 1
MATFLAG_HAS_ROUGHNESS_MAP = 1 << 2
MATFLAG_HAS_METALLIC_MAP = 1 << 3
MATFLAG_HAS_EMISSIVE_MAP = 1 << 4
MATFLAG_HAS_SHEEN_MAP = 1 << 5
MATFLAG_EMISSIVE = 1 << 6


@dataclass
class DeviceMaterials:
    """SoA device materials (reference DeviceMaterial array).

    color/specular/absorption: (N,4) f32 (rgb + pad/roughness in w as in the
    reference packing); params: (N,16) f32 columns per MATERIAL_PARAM_NAMES;
    flags: (N,) i32 bitfield; tex: (N,6) i32 texture ids
    (diffuse, normal, metallic_roughness, emissive, sheen, custom), -1 = none.
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


# ------------------------------------------------------------------- cameras
@dataclass
class CameraView3D:
    """Ray-generation-ready camera (reference CameraView3D, structs.rs:486-776).

    Screen corners parameterization: a primary ray for pixel (x, y) with
    jitter (u, v) is  ``dir = normalize(p1 + r*right + s*up - pos)`` where
    ``r = (x+u) * inv_width``, ``s = (y+v) * inv_height``. Lens rays sample a
    9-bladed aperture like the reference's `generate_lens_ray`.
    """

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
        """Flatten to a (24,) f32 vector for device upload."""
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


@dataclass
class CameraView2D:
    """2D overlay camera: a single ortho matrix (reference CameraView2D)."""

    matrix: np.ndarray  # (4,4) f32
