"""Procedural primitives (host copy of `rfw_tpu/models/primitives.py`,
3D primitives only): Quad3D, Plane, an icosphere (20*4^q triangles) and a
box. All vectorized; subdivision is a batched midpoint split.
"""

from __future__ import annotations

import numpy as np

from rfw_tpu_torch.mathx import normalize
from rfw_tpu_torch.models.mesh3d import Mesh3D, build_mesh3d


def quad3d(
    normal=(0.0, 0.0, 1.0),
    position=(0.0, 0.0, 0.0),
    width: float = 1.0,
    height: float = 1.0,
    material_id: int = 0,
) -> Mesh3D:
    """Two-triangle quad facing `normal` (reference Quad3D)."""
    n = normalize(np.asarray(normal, np.float32))
    ref = np.array([0, 1, 0], np.float32) if abs(n[1]) < 0.9 else np.array([1, 0, 0], np.float32)
    t = normalize(np.cross(ref, n))
    b = np.cross(n, t)
    c = np.asarray(position, np.float32)
    hw, hh = width * 0.5, height * 0.5
    pos = np.stack([c - t * hw - b * hh, c + t * hw - b * hh,
                    c + t * hw + b * hh, c - t * hw + b * hh])
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    nrm = np.tile(n, (4, 1))
    return build_mesh3d(pos, idx, normals=nrm, uvs=uv, material_ids=material_id, name="quad")


def plane(
    up=(0.0, 1.0, 0.0),
    position=(0.0, 0.0, 0.0),
    size=(1.0, 1.0),
    material_id: int = 0,
) -> Mesh3D:
    """Horizontal-ish plane facing `up` (reference Plane)."""
    return quad3d(normal=up, position=position, width=size[0], height=size[1],
                  material_id=material_id)


_ICOSA_T = (1.0 + np.sqrt(5.0)) / 2.0
_ICOSA_VERTS = np.array(
    [
        [-1, _ICOSA_T, 0], [1, _ICOSA_T, 0], [-1, -_ICOSA_T, 0], [1, -_ICOSA_T, 0],
        [0, -1, _ICOSA_T], [0, 1, _ICOSA_T], [0, -1, -_ICOSA_T], [0, 1, -_ICOSA_T],
        [_ICOSA_T, 0, -1], [_ICOSA_T, 0, 1], [-_ICOSA_T, 0, -1], [-_ICOSA_T, 0, 1],
    ],
    np.float32,
)
_ICOSA_FACES = np.array(
    [
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ],
    np.int32,
)


def sphere(
    position=(0.0, 0.0, 0.0),
    radius: float = 1.0,
    material_id: int = 0,
    quality: int = 2,
) -> Mesh3D:
    """Icosphere: `quality` subdivision levels, 20*4^q triangles
    (reference Sphere Quality::Icosahedron(q=0)..Perfect(q=5))."""
    verts = normalize(_ICOSA_VERTS)
    faces = _ICOSA_FACES
    for _ in range(quality):
        # Batched midpoint subdivision with edge dedup.
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        e_sorted = np.sort(e, axis=1)
        uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
        mids = normalize(0.5 * (verts[uniq[:, 0]] + verts[uniq[:, 1]]))
        base = verts.shape[0]
        mid_idx = (base + inv).reshape(3, -1).T.astype(np.int32)  # (F,3): m01, m12, m20
        verts = np.concatenate([verts, mids])
        f0, f1, f2 = faces[:, 0], faces[:, 1], faces[:, 2]
        m01, m12, m20 = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
        faces = np.concatenate(
            [
                np.stack([f0, m01, m20], -1),
                np.stack([f1, m12, m01], -1),
                np.stack([f2, m20, m12], -1),
                np.stack([m01, m12, m20], -1),
            ]
        ).astype(np.int32)

    n = verts.astype(np.float32)
    pos = (n * radius + np.asarray(position, np.float32)).astype(np.float32)
    # Spherical UVs.
    uv = np.stack(
        [0.5 + np.arctan2(n[:, 2], n[:, 0]) / (2 * np.pi), 0.5 - np.arcsin(np.clip(n[:, 1], -1, 1)) / np.pi],
        axis=-1,
    ).astype(np.float32)
    return build_mesh3d(pos, faces, normals=n, uvs=uv, material_ids=material_id, name="sphere")


def cube(
    position=(0.0, 0.0, 0.0), size=(1.0, 1.0, 1.0), material_id: int = 0
) -> Mesh3D:
    """Axis-aligned box with face normals (not in the reference primitive set,
    but needed for Cornell-box scenes)."""
    c = np.asarray(position, np.float32)
    h = 0.5 * np.asarray(size, np.float32)
    # 6 faces * 4 verts
    face_defs = [
        ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((-1, 0, 0), (0, 1, 0), (0, 0, -1)),
        ((0, 1, 0), (0, 0, 1), (1, 0, 0)),
        ((0, -1, 0), (0, 0, -1), (1, 0, 0)),
        ((0, 0, 1), (0, 1, 0), (-1, 0, 0)),
        ((0, 0, -1), (0, 1, 0), (1, 0, 0)),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for f, (n, u, v) in enumerate(face_defs):
        n = np.asarray(n, np.float32)
        u = np.asarray(u, np.float32)
        v = np.asarray(v, np.float32)
        origin = c + n * h
        uu = u * h
        vv = v * h
        pos += [origin - uu - vv, origin + uu - vv, origin + uu + vv, origin - uu + vv]
        nrm += [n] * 4
        uv += [[0, 1], [1, 1], [1, 0], [0, 0]]
        base = 4 * f
        idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return build_mesh3d(
        np.array(pos, np.float32), np.array(idx, np.int32),
        normals=np.array(nrm, np.float32), uvs=np.array(uv, np.float32),
        material_ids=material_id, name="cube",
    )
