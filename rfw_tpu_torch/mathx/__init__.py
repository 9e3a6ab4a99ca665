"""Vectorized math foundation (reference crates/rfw-math — glam re-export + SIMD).

The reference leans on glam Vec3/Mat4 + hand-rolled SSE (rfw-math/src/lib.rs:1-33);
on TPU everything is batched numpy/jnp, so this module provides *batch-first*
transform, quaternion, and AABB helpers shared by the host scene layer and the
device render layer. All functions take numpy arrays and broadcast over
leading axes.

Host copy of `rfw_tpu/mathx/__init__.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from rfw_tpu_torch.mathx.transform import (
    compose_trs,
    look_at_rh,
    mat4_identity,
    normalize,
    orthographic_rh,
    perspective_rh,
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_slerp,
    quat_to_mat3,
    transform_points,
    transform_vectors,
    inverse_transpose3,
)
from rfw_tpu_torch.mathx.aabb import Aabb, aabb_empty, aabb_from_points, aabb_transform, aabb_union
