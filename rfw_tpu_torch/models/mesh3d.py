"""3D mesh IR + vectorized geometry processing.

Re-implements the geometry pipeline of the reference's ``Mesh3D::new``
(crates/rfw-scene/src/objects_3d/mod.rs:52-504) TPU-first: the reference
loops per-triangle with rayon (smooth normals :180-208, tangents :210-266,
per-material ranges :283-329); here everything is batched numpy scatter/
gather so the *same code shape* jits on device when needed.

A `Mesh3D` owns the authoring-side arrays and lowers to a
:class:`rfw_tpu_torch.backend.structs.MeshView3D` for the backend boundary.
Triangles are sorted by material id at build time so per-material ranges
are contiguous — this also feeds the wavefront shader's material-sorted
queues for free.

Host copy of `rfw_tpu/models/mesh3d.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from rfw_tpu_torch.backend.structs import MeshView3D


def _smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (reference objects_3d/mod.rs:180-208).

    The unnormalized face cross product has magnitude 2*area, giving the
    area weighting for free when accumulated.
    """
    v0 = positions[indices[:, 0]]
    e1 = positions[indices[:, 1]] - v0
    e2 = positions[indices[:, 2]] - v0
    face_n = np.cross(e1, e2)
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, indices[:, k], face_n)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    out = np.where(norm > 1e-12, out / np.maximum(norm, 1e-12), np.array([0, 1, 0], np.float32))
    return out.astype(np.float32)


def _tangents(
    positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray, indices: np.ndarray
) -> np.ndarray:
    """Per-vertex tangents: accumulate per-face UV-space tangents, then
    Gram-Schmidt against the normal, handedness in w
    (reference objects_3d/mod.rs:210-266)."""
    v = positions[indices]  # (T,3,3)
    t = uvs[indices]  # (T,3,2)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    du1 = t[:, 1, 0] - t[:, 0, 0]
    dv1 = t[:, 1, 1] - t[:, 0, 1]
    du2 = t[:, 2, 0] - t[:, 0, 0]
    dv2 = t[:, 2, 1] - t[:, 0, 1]
    det = du1 * dv2 - du2 * dv1
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1.0, det), 0.0)[:, None]
    tan = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r
    bitan = (e2 * du1[:, None] - e1 * du2[:, None]) * r

    acc_t = np.zeros_like(positions)
    acc_b = np.zeros_like(positions)
    for k in range(3):
        np.add.at(acc_t, indices[:, k], tan)
        np.add.at(acc_b, indices[:, k], bitan)

    # Gram-Schmidt: t' = normalize(t - n * dot(n, t))
    ndt = np.sum(normals * acc_t, axis=-1, keepdims=True)
    t_ortho = acc_t - normals * ndt
    tlen = np.linalg.norm(t_ortho, axis=-1, keepdims=True)
    # Fall back to an arbitrary tangent frame where UVs are degenerate.
    fallback = np.cross(normals, np.where(np.abs(normals[:, 2:3]) < 0.9,
                                          np.array([0, 0, 1], np.float32),
                                          np.array([1, 0, 0], np.float32)))
    t_ortho = np.where(tlen > 1e-8, t_ortho / np.maximum(tlen, 1e-12), fallback)
    handed = np.where(np.sum(np.cross(normals, t_ortho) * acc_b, axis=-1) < 0.0, -1.0, 1.0)
    return np.concatenate([t_ortho, handed[:, None]], axis=-1).astype(np.float32)


@dataclass
class Mesh3D:
    """Authoring-side mesh; arrays as in MeshView3D plus bookkeeping."""

    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    tangents: np.ndarray
    indices: np.ndarray  # (T,3) i32, sorted by material
    tri_material: np.ndarray  # (T,) i32
    tri_light: np.ndarray  # (T,) i32
    ranges: np.ndarray  # (R,3) i32 (first_tri, count, material_id)
    joints: Optional[np.ndarray] = None
    weights: Optional[np.ndarray] = None
    aabb_min: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    aabb_max: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    name: str = ""
    #: (K,V,3) per-target position deltas (glTF morph targets; reference
    #: carries node weights, rfw-scene/src/graph/mod.rs:100-114)
    morph_targets: Optional[np.ndarray] = None
    morph_normals: Optional[np.ndarray] = None  # (K,V,3) NORMAL deltas
    morph_tangents: Optional[np.ndarray] = None  # (K,V,3) TANGENT xyz deltas

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def has_skin(self) -> bool:
        return self.joints is not None

    @property
    def has_morphs(self) -> bool:
        return self.morph_targets is not None and len(self.morph_targets) > 0

    def view(self) -> MeshView3D:
        return MeshView3D(
            positions=self.positions,
            normals=self.normals,
            uvs=self.uvs,
            tangents=self.tangents,
            indices=self.indices,
            tri_material=self.tri_material,
            tri_light=self.tri_light,
            ranges=self.ranges,
            joints=self.joints,
            weights=self.weights,
            aabb_min=self.aabb_min,
            aabb_max=self.aabb_max,
            name=self.name,
            morph_targets=self.morph_targets,
            morph_normals=self.morph_normals,
            morph_tangents=self.morph_tangents,
        ).validate()

    # Triangle corner getters used by BVH build / light extraction.
    def tri_vertices(self) -> np.ndarray:
        """(T,3,3) world==object-space triangle corners."""
        return self.positions[self.indices]

    def tri_centroids(self) -> np.ndarray:
        return self.tri_vertices().mean(axis=1)

    def tri_areas(self) -> np.ndarray:
        v = self.tri_vertices()
        return 0.5 * np.linalg.norm(
            np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1
        ).astype(np.float32)

    def tri_normals(self) -> np.ndarray:
        v = self.tri_vertices()
        n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def build_mesh3d(
    positions: np.ndarray,
    indices: np.ndarray,
    normals: Optional[np.ndarray] = None,
    uvs: Optional[np.ndarray] = None,
    material_ids: Optional[np.ndarray] = None,
    joints: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    name: str = "",
    morph_targets: Optional[np.ndarray] = None,
    morph_normals: Optional[np.ndarray] = None,
    morph_tangents: Optional[np.ndarray] = None,
) -> Mesh3D:
    """Construct a Mesh3D, deriving missing attributes (reference Mesh3D::new).

    material_ids: per-triangle (T,) int32; scalar or None -> all 0.
    Triangles are stably sorted by material id and per-material ranges
    recorded (reference `ranges` VertexMesh list :283-329).
    """
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    nv, nt = positions.shape[0], indices.shape[0]

    if material_ids is None:
        material_ids = np.zeros(nt, np.int32)
    elif np.isscalar(material_ids):
        material_ids = np.full(nt, material_ids, np.int32)
    else:
        material_ids = np.ascontiguousarray(material_ids, np.int32)

    # Sort triangles by material (stable) for contiguous ranges.
    order = np.argsort(material_ids, kind="stable").astype(np.int64)
    indices = indices[order]
    material_ids = material_ids[order]

    if normals is None:
        normals = _smooth_normals(positions, indices)
    else:
        normals = np.ascontiguousarray(normals, np.float32)

    if uvs is None:
        uvs = np.zeros((nv, 2), np.float32)
    else:
        uvs = np.ascontiguousarray(uvs, np.float32)

    tangents = _tangents(positions, normals, uvs, indices)

    # Per-material ranges.
    if nt:
        mats, first = np.unique(material_ids, return_index=True)
        counts = np.diff(np.append(first, nt))
        ranges = np.stack([first, counts, mats], axis=-1).astype(np.int32)
    else:
        ranges = np.zeros((0, 3), np.int32)

    aabb_min = positions.min(axis=0) if nv else np.zeros(3, np.float32)
    aabb_max = positions.max(axis=0) if nv else np.zeros(3, np.float32)

    return Mesh3D(
        positions=positions,
        normals=normals,
        uvs=uvs,
        tangents=tangents,
        indices=indices,
        tri_material=material_ids,
        tri_light=np.full(nt, -1, np.int32),
        ranges=ranges,
        joints=None if joints is None else np.ascontiguousarray(joints, np.int32),
        weights=None if weights is None else np.ascontiguousarray(weights, np.float32),
        aabb_min=aabb_min.astype(np.float32),
        aabb_max=aabb_max.astype(np.float32),
        name=name,
        morph_targets=(None if morph_targets is None
                       else np.ascontiguousarray(morph_targets, np.float32)),
        morph_normals=(None if morph_normals is None
                       else np.ascontiguousarray(morph_normals, np.float32)),
        morph_tangents=(None if morph_tangents is None
                        else np.ascontiguousarray(morph_tangents, np.float32)),
    )
