"""Batch-first transform & quaternion math (numpy, float32).

Host-side copy of `rfw_tpu/mathx/transform.py`, reduced to what the
renderer's scene building needs. Matrices are row-major ``(..., 4, 4)``
float32 acting on column vectors (``p' = M @ p``).
"""

from __future__ import annotations

import numpy as np


def mat4_identity(shape: tuple = ()) -> np.ndarray:
    m = np.zeros(shape + (4, 4), dtype=np.float32)
    m[..., 0, 0] = m[..., 1, 1] = m[..., 2, 2] = m[..., 3, 3] = 1.0
    return m


def normalize(v: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, eps)


def quat_identity(shape: tuple = ()) -> np.ndarray:
    q = np.zeros(shape + (4,), dtype=np.float32)
    q[..., 3] = 1.0  # (x, y, z, w) — glTF convention
    return q


def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    x, y, z, w = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.empty(q.shape[:-1] + (3, 3), dtype=np.float32)
    m[..., 0, 0] = 1 - 2 * (yy + zz)
    m[..., 0, 1] = 2 * (xy - wz)
    m[..., 0, 2] = 2 * (xz + wy)
    m[..., 1, 0] = 2 * (xy + wz)
    m[..., 1, 1] = 1 - 2 * (xx + zz)
    m[..., 1, 2] = 2 * (yz - wx)
    m[..., 2, 0] = 2 * (xz - wy)
    m[..., 2, 1] = 2 * (yz + wx)
    m[..., 2, 2] = 1 - 2 * (xx + yy)
    return m


def compose_trs(t: np.ndarray, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """T·R·S -> (...,4,4) (glam Mat4::from_scale_rotation_translation)."""
    rot = quat_to_mat3(r)
    m = mat4_identity(np.broadcast_shapes(t.shape[:-1], r.shape[:-1], s.shape[:-1]))
    m[..., :3, :3] = rot * s[..., None, :]
    m[..., :3, 3] = t
    return m


def look_at_rh(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    f = normalize(np.asarray(center, np.float32) - np.asarray(eye, np.float32))
    s = normalize(np.cross(f, up))
    u = np.cross(s, f)
    m = mat4_identity(f.shape[:-1])
    m[..., 0, :3] = s
    m[..., 1, :3] = u
    m[..., 2, :3] = -f
    m[..., 0, 3] = -np.sum(s * eye, axis=-1)
    m[..., 1, 3] = -np.sum(u * eye, axis=-1)
    m[..., 2, 3] = np.sum(f * eye, axis=-1)
    return m


def perspective_rh(fov_y_rad: float, aspect: float, near: float, far: float) -> np.ndarray:
    """RH, depth 0..1 (glam perspective_rh)."""
    f = 1.0 / np.tan(0.5 * fov_y_rad)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m


def orthographic_rh(l: float, r: float, b: float, t: float, near: float, far: float) -> np.ndarray:
    m = mat4_identity()
    m[0, 0] = 2.0 / (r - l)
    m[1, 1] = 2.0 / (t - b)
    m[2, 2] = 1.0 / (near - far)
    m[0, 3] = -(r + l) / (r - l)
    m[1, 3] = -(t + b) / (t - b)
    m[2, 3] = near / (near - far)
    return m


def inverse_transpose3(m: np.ndarray) -> np.ndarray:
    """Normal matrix: inverse-transpose of the upper 3x3."""
    return np.linalg.inv(m[..., :3, :3]).swapaxes(-1, -2).astype(np.float32)
