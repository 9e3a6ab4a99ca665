"""Two-phase traversal, phase A: each ray's K nearest TLAS instance entries.

Counterpart of `rfw_tpu/render/twophase.py` (its `TlasEntries` and
`dense_tlas_entries`). Phase A tells each bounce ray which instances it
enters, nearest first; phase B (`ops.traverse_items`) then walks each
(ray, instance) item in that instance's BLAS alone. For an instance arena
of at most `ops.traverse_items.DENSE_A_MAX_INST` rows phase A is the dense
(R, I) slab scan here; above it, the tree walk of `ops.traverse_entries`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rfw_tpu_torch.ops.traverse import _safe_inv, _t_limit
from rfw_tpu_torch.render.intersect import T_MAX, T_MIN

#: elements of one (rays, instances) plane of the dense scan: rays are
#: taken in chunks of CHUNK_ELEMS // I so that the scan's few live planes
#: stay near 64 MB each, whatever the ray count
CHUNK_ELEMS = 1 << 24


class TlasEntries(NamedTuple):
    t_entry: torch.Tensor  # (R,K) f32 slab entry t, ascending; +inf = none
    inst: torch.Tensor  # (R,K) i32 instance id; -1 = none


def dense_tlas_entries(inst_min, inst_max, ray_o, ray_d, t_limit=T_MAX,
                       K: int = 8) -> TlasEntries:
    """Phase A without a tree: slab-test every instance box against every
    ray and keep the K nearest entries per ray (`torch.topk` in place of
    `lax.top_k`; equal entry t may come out in another order).

    The entry t is clamped at 0, so a ray that starts inside a box enters
    it at 0, and a dead lane (t_limit 0) collects nothing. Padding rows
    carry inverted boxes (+inf/-inf), which would slab as a hit, and are
    gated out by a validity test. The scan runs in ray chunks of
    CHUNK_ELEMS // I rays, so its peak memory does not grow with R."""
    R = ray_o.shape[0]
    I = inst_min.shape[0]
    dev = ray_o.device
    t_lim = _t_limit(t_limit, R, dev)
    ts = torch.full((R, K), float("inf"), dtype=torch.float32, device=dev)
    ins = torch.full((R, K), -1, dtype=torch.int32, device=dev)
    k = min(K, I)
    if R == 0 or k == 0:
        return TlasEntries(ts, ins)
    valid_box = torch.all(inst_min <= inst_max, dim=1)  # (I,)
    inv_d = _safe_inv(ray_d)
    step = max(1, CHUNK_ELEMS // I)
    for r0 in range(0, R, step):
        o = ray_o[r0:r0 + step]
        iv = inv_d[r0:r0 + step]
        tn = tf = None
        # per-axis accumulation keeps every intermediate (r, I), never (r, I, 3)
        for a in range(3):
            t0 = (inst_min[None, :, a] - o[:, None, a]) * iv[:, None, a]
            t1 = (inst_max[None, :, a] - o[:, None, a]) * iv[:, None, a]
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            del t0, t1
            tn = lo if tn is None else torch.maximum(tn, lo)
            tf = hi if tf is None else torch.minimum(tf, hi)
            del lo, hi
        te = torch.clamp(tn, min=0.0)
        hit = (valid_box[None] & (tn <= tf) & (tf > T_MIN)
               & (te < t_lim[r0:r0 + step, None]))
        del tn, tf
        te = torch.where(hit, te, float("inf"))
        del hit
        vals, idx = torch.topk(te, k, dim=1, largest=False, sorted=True)
        ts[r0:r0 + step, :k] = vals
        ins[r0:r0 + step, :k] = torch.where(torch.isfinite(vals),
                                            idx.to(torch.int32), -1)
    return TlasEntries(ts, ins)
