"""Batch-first numpy transform and AABB helpers for host-side scene
building (counterpart of `rfw_tpu.mathx`)."""

from rfw_tpu_torch.mathx.transform import (
    compose_trs,
    inverse_transpose3,
    look_at_rh,
    mat4_identity,
    normalize,
    orthographic_rh,
    perspective_rh,
    quat_identity,
    quat_to_mat3,
)
from rfw_tpu_torch.mathx.aabb import Aabb, aabb_transform
