"""The benchmark's own linear-blend skinning, plain numpy in float32, for the
posed meshes the reference renders (`laws/skin.py`). It follows rfw-rs's
`SkinnedMesh3D::apply` (crates/rfw-backend/src/structs.rs:785-877) and
imports nothing of the program:

  * a vertex's matrix is the blend of its joints' matrices by its weights;
  * positions go through the blended matrix;
  * normals through its inverse-transpose, renormalised;
  * tangents through the blend itself, renormalised, their handedness
    flipped where the blend mirrors (a negative determinant).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def skin(positions: np.ndarray, normals: np.ndarray, tangents: np.ndarray,
         joints: np.ndarray, weights: np.ndarray,
         joint_matrices: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(positions (V,3), normals (V,3), tangents (V,4), w = handedness) of
    the rest pose's vertices posed by `joint_matrices` (J,4,4). Every
    vertex has a weight: the blend is never all zero."""
    jm = np.asarray(joint_matrices, np.float32)
    m = np.zeros((joints.shape[0], 4, 4), np.float32)
    for k in range(joints.shape[1]):  # the blend of each vertex's joints
        m += weights[:, k, None, None] * jm[joints[:, k]]
    rot = m[:, :3, :3]
    pos = np.einsum("vab,vb->va", rot, positions) + m[:, :3, 3]
    nrm = _unit(np.einsum("vba,vb->va", np.linalg.inv(rot), normals))
    tan = _unit(np.einsum("vab,vb->va", rot, tangents[:, :3]))
    handed = tangents[:, 3] * np.where(np.linalg.det(rot) < 0, -1.0, 1.0)
    return (pos.astype(np.float32), nrm.astype(np.float32),
            np.concatenate([tan, handed[:, None]], axis=1).astype(np.float32))
