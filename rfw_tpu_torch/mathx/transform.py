"""Batch-first transform & quaternion math (numpy, float32).

Matrices are row-major ``(..., 4, 4)`` float32 acting on column vectors
(``p' = M @ p``), matching glam's math as used by the reference scene graph
(crates/rfw-scene/src/graph/mod.rs:540-630 matrix propagation).

Host copy of `rfw_tpu/mathx/transform.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
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


# ---------------------------------------------------------------- quaternions
def quat_identity(shape: tuple = ()) -> np.ndarray:
    q = np.zeros(shape + (4,), dtype=np.float32)
    q[..., 3] = 1.0  # (x, y, z, w) — glTF convention
    return q


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return normalize(q)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = (a[..., i] for i in range(4))
    bx, by, bz, bw = (b[..., i] for i in range(4))
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    ).astype(np.float32)


def quat_slerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Batched spherical lerp; `t` broadcasts over leading axes.

    Used by animation channel sampling (reference gltf rotation channels)."""
    a = quat_normalize(a)
    b = quat_normalize(b)
    d = np.sum(a * b, axis=-1, keepdims=True)
    b = np.where(d < 0.0, -b, b)
    d = np.abs(d)
    t = np.asarray(t, dtype=np.float32)[..., None]
    # For nearly-parallel quats fall back to nlerp.
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    sin_theta = np.sin(theta)
    near = sin_theta < 1e-5
    w_a = np.where(near, 1.0 - t, np.sin((1.0 - t) * theta) / np.where(near, 1.0, sin_theta))
    w_b = np.where(near, t, np.sin(t * theta) / np.where(near, 1.0, sin_theta))
    return quat_normalize(w_a * a + w_b * b)


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
    """T·R·S -> (...,4,4); matches glam Mat4::from_scale_rotation_translation
    used by the reference node local matrices (graph/mod.rs Node::update_matrix)."""
    rot = quat_to_mat3(r)
    m = mat4_identity(np.broadcast_shapes(t.shape[:-1], r.shape[:-1], s.shape[:-1]))
    m[..., :3, :3] = rot * s[..., None, :]
    m[..., :3, 3] = t
    return m


# ---------------------------------------------------------------- projections
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
    """RH, depth 0..1 (matches glam perspective_rh used in light/camera matrices)."""
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


# ---------------------------------------------------------------- application
def transform_points(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """(...,4,4) @ (...,N,3) -> (...,N,3) with w=1."""
    out = np.einsum("...ij,...nj->...ni", m[..., :3, :3], p) + m[..., None, :3, 3]
    return out.astype(np.float32)


def transform_vectors(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate/scale only (w=0)."""
    return np.einsum("...ij,...nj->...ni", m[..., :3, :3], v).astype(np.float32)


def inverse_transpose3(m: np.ndarray) -> np.ndarray:
    """Normal matrix: inverse-transpose of the upper 3x3
    (reference backends/wgpu/src/lib.rs:508-541 computes this per instance)."""
    return np.linalg.inv(m[..., :3, :3]).swapaxes(-1, -2).astype(np.float32)
