"""Host-side binned-SAH BVH builder: counterpart of
`rfw_tpu/accel/bvh_cpu.py`. As there, the build and the refit call the
native C++ library (`rfw_tpu_torch.native`, the same source and result as
`rfw_tpu`'s) unless `RFW_NO_NATIVE=1` is set or the build's caller
passes `use_native=False`; the numpy path is a copy of that package's, so its
nodes are bit-identical to `rfw_tpu`'s numpy build. The two builders give
the same node arrays and leaf sets; `prim_order` may differ inside a leaf.

Flat SoA node layout (BLAS and TLAS alike):

  node_min/node_max : (N,3) f32   node AABB
  node_left         : (N,) i32    internal: left child index (right = left+1)
                                  leaf: first index into `prim_order`
  node_count        : (N,) i32    0 = internal, >0 = leaf primitive count
  prim_order        : (P,) i32    primitive ids reordered so leaves are
                                  contiguous ranges

Build is iterative (explicit stack) with 16-bin SAH over the centroid
extent, falling back to median split when SAH finds no cut. Vectorized
numpy per node; O(n log n) total.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from rfw_tpu_torch import native

N_BINS = 16
MAX_LEAF = 8
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0
#: BLAS leaf capacity for the render path ("treelet" leaves): every leaf's
#: triangles start at a TREELET-aligned slot of the triangle arena
#: (render/pack.py), and ops/traverse.py stores a precomputed
#: world->unit-triangle affine per slot. Must be a power of two <= 128
#: (count packs into the low bits of the leaf code).
TREELET = 64


@dataclass
class BvhNodes:
    node_min: np.ndarray  # (N,3) f32
    node_max: np.ndarray  # (N,3) f32
    node_left: np.ndarray  # (N,) i32
    node_right: np.ndarray  # (N,) i32  (internal only; SAH layout: left+1)
    node_count: np.ndarray  # (N,) i32
    prim_order: np.ndarray  # (P,) i32

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    def sah_cost(self) -> float:
        """Total SAH cost (for build-quality comparisons)."""
        ext = np.maximum(self.node_max - self.node_min, 0)
        area = 2 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0])
        root = max(float(area[0]), 1e-12)
        is_leaf = self.node_count > 0
        c = np.where(is_leaf, INTERSECT_COST * self.node_count, TRAVERSAL_COST)
        return float(np.sum(c * area / root))


def _surface_areas(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    e = np.maximum(mx - mn, 0)
    return 2 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0])


def build_bvh_sah(
    aabb_min: np.ndarray, aabb_max: np.ndarray, max_leaf: int = MAX_LEAF,
    use_native: bool = True,
) -> BvhNodes:
    """Build from per-primitive AABBs -> flat BVH.

    Works for triangles (BLAS) and instance bounds (TLAS) alike. Uses the
    native builder unless `use_native=False` or `RFW_NO_NATIVE=1`; this
    numpy path is the reference."""
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    n = aabb_min.shape[0]
    if n > 0 and native.enabled(use_native):
        return native.build_bvh_sah_native(aabb_min, aabb_max, max_leaf)
    if n == 0:
        # inverted (unhittable) box: the zero-filled encoding made an
        # internal node whose children are itself at a point box — a ray
        # through the origin would cycle forever in the lockstep walk
        return BvhNodes(
            node_min=np.full((1, 3), np.inf, np.float32),
            node_max=np.full((1, 3), -np.inf, np.float32),
            node_left=np.zeros(1, np.int32),
            node_right=np.zeros(1, np.int32),
            node_count=np.zeros(1, np.int32),
            prim_order=np.zeros(0, np.int32),
        )
    centroids = 0.5 * (aabb_min + aabb_max)

    order = np.arange(n, dtype=np.int32)
    cap = max(2 * n, 2)
    nmin = np.empty((cap, 3), np.float32)
    nmax = np.empty((cap, 3), np.float32)
    nleft = np.zeros(cap, np.int32)
    nright = np.zeros(cap, np.int32)
    ncount = np.zeros(cap, np.int32)
    n_nodes = 1

    stack = [(0, 0, n)]  # (node_idx, start, end)
    while stack:
        node, start, end = stack.pop()
        ids = order[start:end]
        bmin = aabb_min[ids]
        bmax = aabb_max[ids]
        nmin[node] = bmin.min(axis=0)
        nmax[node] = bmax.max(axis=0)
        count = end - start

        def make_leaf() -> None:
            nleft[node] = start
            ncount[node] = count

        if count <= max_leaf:
            make_leaf()
            continue

        cent = centroids[ids]
        cmin = cent.min(axis=0)
        cmax = cent.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))

        mid = -1
        if extent[axis] >= 1e-12:
            # 16-bin SAH on the widest centroid axis.
            scale = N_BINS * (1.0 - 1e-6) / extent[axis]
            bin_id = ((cent[:, axis] - cmin[axis]) * scale).astype(np.int32)
            counts = np.bincount(bin_id, minlength=N_BINS)
            bins_min = np.full((N_BINS, 3), np.inf, np.float32)
            bins_max = np.full((N_BINS, 3), -np.inf, np.float32)
            np.minimum.at(bins_min, bin_id, bmin)
            np.maximum.at(bins_max, bin_id, bmax)
            lmin = np.minimum.accumulate(bins_min, axis=0)
            lmax = np.maximum.accumulate(bins_max, axis=0)
            rmin = np.minimum.accumulate(bins_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bins_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]

            la = _surface_areas(lmin[:-1], lmax[:-1])
            ra = _surface_areas(rmin[1:], rmax[1:])
            cost = la * lcnt[:-1] + ra * rcnt[1:]
            valid = (lcnt[:-1] > 0) & (rcnt[1:] > 0)
            if valid.any():
                # Note: no SAH early-out leaf here — leaves must never exceed
                # max_leaf (traversal unrolls exactly max_leaf prim tests, and
                # the TLAS requires singleton leaves).
                cost = np.where(valid, cost, np.inf)
                best = int(np.argmin(cost))
                go_left = bin_id <= best
                nl = int(go_left.sum())
                if 0 < nl < count:
                    order[start:end] = np.concatenate([ids[go_left], ids[~go_left]])
                    mid = start + nl

        if mid < 0:
            # Median split fallback: partition by centroid on the axis.
            half = count // 2
            sel = np.argpartition(cent[:, axis], half)
            order[start:end] = ids[sel]
            mid = start + half

        left = n_nodes
        n_nodes += 2
        nleft[node] = left
        nright[node] = left + 1
        ncount[node] = 0
        stack.append((left + 1, mid, end))
        stack.append((left, start, mid))

    return BvhNodes(
        node_min=np.ascontiguousarray(nmin[:n_nodes]),
        node_max=np.ascontiguousarray(nmax[:n_nodes]),
        node_left=np.ascontiguousarray(nleft[:n_nodes]),
        node_right=np.ascontiguousarray(nright[:n_nodes]),
        node_count=np.ascontiguousarray(ncount[:n_nodes]),
        prim_order=order,
    )


def triangle_aabbs(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mn = np.minimum(np.minimum(v0, v1), v2)
    mx = np.maximum(np.maximum(v0, v1), v2)
    return mn.astype(np.float32), mx.astype(np.float32)


def refit_bvh(bvh: BvhNodes, aabb_min: np.ndarray, aabb_max: np.ndarray) -> BvhNodes:
    """Refit node bounds bottom-up for deformed primitives, keeping topology
    (reference gpu-rt refit_bvh :1345-1384 semantics). Host-side; the
    native refit unless `RFW_NO_NATIVE=1`, else the numpy path of
    `rfw_tpu.accel.bvh_cpu.refit_bvh`."""
    if bvh.num_nodes > 0 and native.enabled():
        out = BvhNodes(
            bvh.node_min.copy(), bvh.node_max.copy(), bvh.node_left,
            bvh.node_right, bvh.node_count, bvh.prim_order,
        )
        native.refit_bvh_native(out, aabb_min, aabb_max)
        return out
    n = bvh.num_nodes
    nmin = bvh.node_min.copy()
    nmax = bvh.node_max.copy()
    # Process nodes in reverse index order: children always have higher
    # indices than parents in our layout.
    for i in range(n - 1, -1, -1):
        if bvh.node_count[i] > 0:
            ids = bvh.prim_order[bvh.node_left[i] : bvh.node_left[i] + bvh.node_count[i]]
            nmin[i] = aabb_min[ids].min(axis=0)
            nmax[i] = aabb_max[ids].max(axis=0)
        else:
            l, r = bvh.node_left[i], bvh.node_right[i]
            nmin[i] = np.minimum(nmin[l], nmin[r])
            nmax[i] = np.maximum(nmax[l], nmax[r])
    return BvhNodes(nmin, nmax, bvh.node_left, bvh.node_right, bvh.node_count, bvh.prim_order)
