"""Device-side TLAS: a complete 8-ary Morton-ordered tree built with torch
ops on the tensors' device — the per-frame TLAS of the instance-only sync
for large instance pools.

Counterpart of `rfw_tpu/accel/tlas_device.py`. The host path
(`pack.repack_instances`) runs a binned-SAH build and an 8-wide collapse
per frame. Here the tree topology is fixed (a complete 8-ary tree over the
Morton-sorted instance order, instances padded to a power of 8), so the
build is a sort and segmented min/max reductions, with no data-dependent
control flow.

Output is the 8-wide supernode encoding the traversal kernels read
(render/pack.build_widen):
  box (S,48): child c lanes 6c..6c+5 = min3|max3 (+inf/-inf = never hit)
  code (S,8): >= 0 internal child node index (TLAS-local), < 0 leaf with
              instance id = -code-1
  cnt  (S,8): leaf instance count (1 for real leaves, 0 padding)
Root is node 0.

The result is bit-identical to the JAX function's on the CPU: the corner
transform rounds as XLA's CPU dot does (a chain of fused multiply-adds,
emulated in float64 here, so the CPU and the card agree too), and the
Morton order is a stable sort, as `jnp.argsort` is.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rfw_tpu_torch.accel.lbvh import morton_codes

_INF = float("inf")


def _pow8_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 8
    return max(p, 8)


def fma_matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m (..., 3, 3) applied to v (..., 3) in float32, rounded as
    fma(m2, v2, fma(m1, v1, m0 * v0)) per row: XLA's CPU dot for a
    3-term contraction. Each fused step is computed in float64 (the
    product of two float32 values is exact there) and rounded once."""
    m64, v64 = m.double(), v.double()
    acc = (m[..., 0] * v[..., None, 0]).double()
    for k in (1, 2):
        acc = (m64[..., k] * v64[..., None, k] + acc).float().double()
    return acc.float()


def build_tlas8_device(
    inst_matrix: torch.Tensor,  # (I,4,4) object->world
    local_min: torch.Tensor,  # (I,3) per-instance mesh AABB
    local_max: torch.Tensor,  # (I,3)
    pad_nodes: int = 0,  # pad the node arrays to this many rows (0 = exact)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(I) instances -> (S,48) box, (S,8) code, (S,8) cnt on the inputs'
    device."""
    I = inst_matrix.shape[0]
    P = _pow8_at_least(I)
    dev = inst_matrix.device
    f32, i32 = torch.float32, torch.int32

    # world AABBs of the 8 transformed corners
    bit = torch.arange(8, device=dev)
    corners = torch.stack([
        torch.where((bit & (1 << j)) != 0, local_max[:, None, j], local_min[:, None, j])
        for j in range(3)
    ], dim=-1)  # (I,8,3)
    wc = (fma_matvec(inst_matrix[:, None, :3, :3], corners)
          + inst_matrix[:, None, :3, 3])
    wmin = wc.amin(dim=1)
    wmax = wc.amax(dim=1)

    # Morton order over centroids (stable, as jnp.argsort)
    centroid = 0.5 * (wmin + wmax)
    scene_min = wmin.amin(dim=0)
    scene_max = wmax.amax(dim=0)
    codes = morton_codes(centroid, scene_min, scene_max)
    order = torch.argsort(codes, stable=True)

    # pad to a power of 8 with never-hit leaves
    pad = P - I
    inst_sorted = torch.cat([order.to(i32), torch.full((pad,), -1, dtype=i32, device=dev)])
    lmin = torch.cat([wmin[order], torch.full((pad, 3), _INF, dtype=f32, device=dev)])
    lmax = torch.cat([wmax[order], torch.full((pad, 3), -_INF, dtype=f32, device=dev)])

    # bottom-up complete 8-ary levels of sizes P/8, P/64, ..., 1; the node
    # array is level-order with the root first
    sizes = []
    s = P // 8
    while s >= 1:
        sizes.append(s)
        s //= 8
    sizes = sizes[::-1]  # [1, 8, ..., P/8]
    offsets = [0]
    for s in sizes[:-1]:
        offsets.append(offsets[-1] + s)
    n_nodes = sum(sizes)

    boxes = torch.zeros((n_nodes, 48), dtype=f32, device=dev)
    codes8 = torch.full((n_nodes, 8), -1, dtype=i32, device=dev)
    cnts = torch.zeros((n_nodes, 8), dtype=i32, device=dev)

    # deepest internal level: children are instance leaves
    deep_off, deep_n = offsets[-1], sizes[-1]
    ch_min = lmin.reshape(deep_n, 8, 3)
    ch_max = lmax.reshape(deep_n, 8, 3)
    leaf_inst = inst_sorted.reshape(deep_n, 8)
    cnt_rows = (leaf_inst >= 0).to(i32)
    boxes[deep_off:deep_off + deep_n] = torch.cat([ch_min, ch_max], dim=-1).reshape(deep_n, 48)
    codes8[deep_off:deep_off + deep_n] = torch.where(leaf_inst >= 0, -(leaf_inst + 1), -1)
    cnts[deep_off:deep_off + deep_n] = cnt_rows

    # interior levels: children are the 8 nodes of the level below
    any_leaf = (cnt_rows.sum(dim=1) > 0)[:, None]
    nmin = torch.where(any_leaf, ch_min.amin(dim=1), _INF)
    nmax = torch.where(any_leaf, ch_max.amax(dim=1), -_INF)
    child_off = deep_off
    for li in range(len(sizes) - 2, -1, -1):
        off, n = offsets[li], sizes[li]
        cm = nmin.reshape(n, 8, 3)
        cx = nmax.reshape(n, 8, 3)
        boxes[off:off + n] = torch.cat([cm, cx], dim=-1).reshape(n, 48)
        child_ids = child_off + torch.arange(n * 8, dtype=i32, device=dev).reshape(n, 8)
        # empty children keep code -1 (their +inf boxes never pass the
        # slab test, so the walk never dereferences them)
        live = cx[:, :, 0] > -_INF
        codes8[off:off + n] = torch.where(live, child_ids, -1)
        any_live = live.any(dim=1)[:, None]
        nmin = torch.where(any_live, cm.amin(dim=1), _INF)
        nmax = torch.where(any_live, cx.amax(dim=1), -_INF)
        child_off = off

    if pad_nodes and pad_nodes > n_nodes:
        extra = pad_nodes - n_nodes
        boxes = torch.cat([boxes, torch.full((extra, 48), _INF, dtype=f32, device=dev)])
        codes8 = torch.cat([codes8, torch.full((extra, 8), -1, dtype=i32, device=dev)])
        cnts = torch.cat([cnts, torch.zeros((extra, 8), dtype=i32, device=dev)])
    return boxes, codes8, cnts


def tlas8_node_count(n_instances: int) -> int:
    """Static node count build_tlas8_device produces for I instances."""
    P = _pow8_at_least(n_instances)
    total, s = 0, P // 8
    while s >= 1:
        total += s
        s //= 8
    return total
