"""Ray-scene intersection types and the brute-force oracle.

Counterpart of `rfw_tpu/render/intersect.py`: the `Hit` record every
traversal returns, the t range, and an O(R*T) Möller-Trumbore oracle used
by the tests. The BVH walk itself lives in `rfw_tpu_torch.ops.traverse`
(the CUDA kernel and its plain torch version).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

T_MIN = 1e-5
T_MAX = 1e26


class Hit(NamedTuple):
    t: torch.Tensor  # (R,) f32 — min(t_limit, T_MAX) on miss
    prim: torch.Tensor  # (R,) i32 global triangle id, -1 on miss
    inst: torch.Tensor  # (R,) i32 instance id, -1 on miss
    u: torch.Tensor  # (R,) f32 barycentric
    v: torch.Tensor  # (R,) f32


def brute_force_closest(
    ray_o: torch.Tensor, ray_d: torch.Tensor,
    v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
    t_min: float = T_MIN, t_max: float = T_MAX,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closest hit of R rays against T world-space triangles, O(R*T).

    Returns (t, prim, u, v); prim == -1 for a miss. Batched over triangles
    to bound memory."""
    R = ray_o.shape[0]
    dev = ray_o.device
    best_t = torch.full((R,), t_max, dtype=torch.float32, device=dev)
    best_p = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(R, dtype=torch.float32, device=dev)
    best_v = torch.zeros(R, dtype=torch.float32, device=dev)
    chunk = max(1, 8_000_000 // max(R, 1))
    rows = torch.arange(R, device=dev)
    d = ray_d[:, None, :]
    for s in range(0, v0.shape[0], chunk):
        tv0, te1, te2 = v0[s:s + chunk], e1[s:s + chunk], e2[s:s + chunk]
        pvec = torch.linalg.cross(d.expand(-1, te2.shape[0], -1),
                                  te2[None].expand(R, -1, -1), dim=-1)
        det = torch.sum(te1[None] * pvec, dim=-1)
        ok_det = torch.abs(det) > 1e-12
        inv_det = torch.where(ok_det, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
        tvec = ray_o[:, None, :] - tv0[None]
        u = torch.sum(tvec * pvec, dim=-1) * inv_det
        qvec = torch.linalg.cross(tvec, te1[None].expand(R, -1, -1), dim=-1)
        v = torch.sum(d * qvec, dim=-1) * inv_det
        t = torch.sum(te2[None] * qvec, dim=-1) * inv_det
        hit = (ok_det & (u >= -1e-7) & (v >= -1e-7) & (u + v <= 1 + 1e-7)
               & (t > t_min) & (t < best_t[:, None]))
        t_masked = torch.where(hit, t, float("inf"))
        j = torch.argmin(t_masked, dim=1)
        better = t_masked[rows, j] < best_t
        best_t = torch.where(better, t[rows, j], best_t)
        best_p = torch.where(better, (s + j).to(torch.int32), best_p)
        best_u = torch.where(better, u[rows, j], best_u)
        best_v = torch.where(better, v[rows, j], best_v)
    return best_t, best_p, best_u, best_v
