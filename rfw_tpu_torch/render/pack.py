"""Flatten scene data into packed arenas ("TraceScene").

Host numpy copy of `rfw_tpu/render/pack.py` (with deformed meshes and the
instance-only repack), kept bit-identical to it so both renderers trace
the same arenas. All cross-array offsets are pre-applied
at pack time, so the traversal never consults an offset table —

  * BLAS child indices are rebased into one global node arena;
  * BLAS leaf `first` indices point into one global prim arena;
  * the prim arena stores *global* triangle ids;
  * TLAS leaves store instance ids.

Triangles are stored as (v0, e1, e2) ready for Moller-Trumbore, alongside
shading indices into a packed vertex arena.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from rfw_tpu_torch.accel.bvh_cpu import (
    TREELET, BvhNodes, build_bvh_sah, refit_bvh, triangle_aabbs,
)
from rfw_tpu_torch.mathx import Aabb, aabb_transform, inverse_transpose3
from rfw_tpu_torch.models.mesh3d import Mesh3D

#: supernode collapse depth: 8-wide supernodes (the JAX package's default
#: `RFW_WIDE_ARITY`; the traversal kernel is written for arity 8)
WIDE_DEPTH = 3


class TraceScene(NamedTuple):
    """Packed SoA arenas for two-level traversal: numpy from the packer,
    tensors after `rfw_tpu_torch.convert.from_numpy_scene`."""

    # TLAS over instances
    tlas_min: np.ndarray  # (Nt,3)
    tlas_max: np.ndarray
    tlas_left: np.ndarray  # (Nt,)
    tlas_right: np.ndarray
    tlas_count: np.ndarray
    tlas_prim: np.ndarray  # (I,) instance ids

    # instances
    inst_matrix: np.ndarray  # (I,4,4) object->world
    inst_inv: np.ndarray  # (I,4,4) world->object
    inst_normal: np.ndarray  # (I,3,3) inverse-transpose for normals
    inst_mesh: np.ndarray  # (I,) mesh slot
    inst_aabb_min: np.ndarray  # (I,3) world-space instance bounds (padding
    inst_aabb_max: np.ndarray  # (I,3)  rows are inverted: +inf/-inf)

    # BLAS node arena (offsets pre-applied)
    blas_min: np.ndarray  # (Nb,3)
    blas_max: np.ndarray
    blas_left: np.ndarray
    blas_right: np.ndarray
    blas_count: np.ndarray
    blas_root: np.ndarray  # (I,) root node index per *instance*

    # Wide-node mirrors (fast traversal path): per INTERNAL node, both
    # children's AABBs + encoded child links, so one gather per visited
    # node replaces ~10 and leaves are intersected inline.
    #   wide_f: (N,12) = [lmin,lmax,rmin,rmax]
    #   wide_i: (N,4)  = [l_code, r_code, l_count, r_count]
    #     code >= 0: internal child node index (wide index space)
    #     code <  0: leaf; TLAS: instance id = -code-1 (count ignored);
    #                BLAS: first tri = -code-1, count = *_count
    tlas_wide_f: np.ndarray
    tlas_wide_i: np.ndarray
    blas_wide_f: np.ndarray
    blas_wide_i: np.ndarray
    blas_wide_root: np.ndarray  # (I,) wide root per instance

    # 8-wide supernode mirrors (the traversal kernel): see build_wide8
    tlas8_box: np.ndarray  # (St,48)
    tlas8_code: np.ndarray  # (St,8)
    tlas8_cnt: np.ndarray  # (St,8)
    blas8_box: np.ndarray  # (Sb,48)
    blas8_code: np.ndarray  # (Sb,8)
    blas8_cnt: np.ndarray  # (Sb,8)
    blas8_root: np.ndarray  # (I,) supernode root per instance

    # triangle arena
    tri_v0: np.ndarray  # (T,3)
    tri_e1: np.ndarray
    tri_e2: np.ndarray
    tri_i0: np.ndarray  # (T,) vertex arena indices
    tri_i1: np.ndarray
    tri_i2: np.ndarray
    tri_mat: np.ndarray  # (T,)
    tri_light: np.ndarray  # (T,)
    tri_mesh: np.ndarray  # (T,) owning mesh slot
    tri_lodf: np.ndarray  # (T,) sqrt(uv_area/world_area) — texture LOD factor
    #   (reference Mesh3D per-tri LOD, objects_3d/mod.rs:355-358)

    # vertex arena (shading attributes)
    vtx_normal: np.ndarray  # (V,3)
    vtx_uv: np.ndarray  # (V,2)
    vtx_tangent: np.ndarray  # (V,4)

    # baked per-triangle shading record: ONE gather by hit.prim replaces the
    # ~12 indirected vertex-attribute gathers the shading basis would need.
    # Layout: [n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2) tan(3) handed(1)
    #          e1(3) e2(3) lodf(1) centroid_obj(3) mat(1) light(1) pad(1)]
    # = 32 lanes (mat/light are exact f32 ints so the shading basis decodes
    # them from this one gather instead of two more full-front row gathers)
    tri_shade: np.ndarray  # (T,32) f32

    # per-mesh [lo, hi) slice of the triangle arena, indexed by mesh SLOT
    # (absent slots: [0, 0)). Both ends are TREELET-aligned
    # (_align_leaf_tris pads every mesh chunk), which is what lets the
    # dense items tier test whole treelet groups behind one scalar
    # in-range gate (ops.traverse_items).
    mesh_tri_range: np.ndarray  # (M,2) i32

    @property
    def num_instances(self) -> int:
        return self.inst_matrix.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]


def build_wide_nodes(bvh: BvhNodes, tlas: bool, leaf_base_offset: int = 0):
    """Convert flat BvhNodes to the wide 'children-in-parent' layout.

    Internal nodes only; child links re-indexed into the wide (internal-only)
    space. Leaf children encode as code = -(payload+1) where payload is the
    instance id (TLAS) or the first-triangle index (BLAS, plus
    leaf_base_offset for arena packing). A single-leaf root gets a synthetic
    internal root with an empty right child.
    """
    n = bvh.num_nodes
    is_internal = bvh.node_count == 0
    if not is_internal.any():
        # root is a leaf: synthesize one internal node
        wf = np.full((1, 12), 0.0, np.float32)
        wf[0, 0:3] = bvh.node_min[0]
        wf[0, 3:6] = bvh.node_max[0]
        wf[0, 6:9] = np.inf   # empty right child
        wf[0, 9:12] = -np.inf
        payload = (bvh.prim_order[bvh.node_left[0]] if tlas
                   else bvh.node_left[0] + leaf_base_offset)
        wi = np.zeros((1, 4), np.int32)
        wi[0, 0] = -(int(payload) + 1)
        wi[0, 1] = -1  # leaf code pointing at payload 0 with count 0
        wi[0, 2] = int(bvh.node_count[0])
        wi[0, 3] = 0
        return wf, wi, 0

    # map old internal index -> wide index (dense over internals)
    wide_idx = np.cumsum(is_internal) - 1  # valid where is_internal
    internals = np.nonzero(is_internal)[0]
    l = bvh.node_left[internals]
    r = bvh.node_right[internals]
    wf = np.empty((len(internals), 12), np.float32)
    wf[:, 0:3] = bvh.node_min[l]
    wf[:, 3:6] = bvh.node_max[l]
    wf[:, 6:9] = bvh.node_min[r]
    wf[:, 9:12] = bvh.node_max[r]

    def code(child):
        child_internal = bvh.node_count[child] == 0
        internal_code = wide_idx[child]
        if tlas:
            payload = np.where(
                child_internal, 0,
                bvh.prim_order[np.minimum(bvh.node_left[child],
                                          max(len(bvh.prim_order) - 1, 0))],
            )
        else:
            payload = bvh.node_left[child] + leaf_base_offset
        return np.where(child_internal, internal_code, -(payload + 1)).astype(np.int32)

    wi = np.empty((len(internals), 4), np.int32)
    wi[:, 0] = code(l)
    wi[:, 1] = code(r)
    wi[:, 2] = bvh.node_count[l]
    wi[:, 3] = bvh.node_count[r]
    root_wide = int(wide_idx[0]) if is_internal[0] else 0
    return wf, wi, root_wide


def _cap_rows(n: int, mult: int = 256, linear: bool = False) -> int:
    """Power-of-two row capacity (>= mult): keeps packed-arena shapes — and
    therefore every downstream jit/Mosaic compile — stable while dynamic
    content (skinned BLAS rebuilds, instance churn) fluctuates under the
    cap. The reference's wgpu arenas are capacity-padded for the same
    reason (backends/wgpu/src/list.rs update_ranges)."""
    if linear:
        return max(mult, -(-n // mult) * mult)
    c = mult
    while c < n:
        c *= 2
    return c


def _pad_rows(a: np.ndarray, mult: int = 256, fill=0,
              linear: bool = False) -> np.ndarray:
    n = a.shape[0]
    pad = _cap_rows(n, mult, linear) - n
    if pad == 0:
        return a
    return np.concatenate(
        [a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0
    )


def _tri_lod_factor(mesh: Mesh3D, po: np.ndarray) -> np.ndarray:
    """Per-triangle sqrt(uv_area / world_area): multiplied by the ray
    footprint to pick a mip level (reference objects_3d/mod.rs:355-358)."""
    uv = mesh.uvs[mesh.indices[po]]  # (t,3,2)
    e1 = uv[:, 1] - uv[:, 0]
    e2 = uv[:, 2] - uv[:, 0]
    uv_area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    v = mesh.positions[mesh.indices[po]]
    w_area = 0.5 * np.linalg.norm(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
    return np.sqrt(uv_area / np.maximum(w_area, 1e-12)).astype(np.float32)


def _align_leaf_tris(bvh: BvhNodes, n_tris: int, align: int = TREELET):
    """Align every leaf's first-triangle offset to `align` by inserting gaps
    in the reordered triangle arena, so every leaf ("treelet") owns one
    aligned block of TREELET triangle slots. Returns (aligned_bvh, gather, new_size):
    `gather` maps padded arena position -> reordered-arena position (-1 =
    filler; fillers are degenerate triangles that can never be hit).
    new_size is a multiple of `align`."""
    is_leaf = bvh.node_count > 0
    leaves = np.nonzero(is_leaf)[0]
    order = leaves[np.argsort(bvh.node_left[leaves], kind="stable")]
    new_left = bvh.node_left.copy()
    cursor = 0
    spans = []
    for li in order:
        first = int(bvh.node_left[li])
        count = int(bvh.node_count[li])
        aligned = -(-cursor // align) * align
        new_left[li] = aligned
        spans.append((aligned, first, count))
        cursor = aligned + count
    new_size = max(-(-cursor // align) * align, align) if n_tris else 0
    gather = np.full(new_size, -1, np.int64)
    for aligned, first, count in spans:
        gather[aligned:aligned + count] = np.arange(first, first + count)
    aligned_bvh = BvhNodes(
        node_min=bvh.node_min, node_max=bvh.node_max,
        node_left=new_left.astype(np.int32), node_right=bvh.node_right,
        node_count=bvh.node_count, prim_order=bvh.prim_order,
    )
    return aligned_bvh, gather, new_size


def _pad_gather(ordered: np.ndarray, gather: np.ndarray, fill=0):
    """Scatter a leaf-ordered per-triangle array into the 8-aligned arena."""
    out = np.full((gather.shape[0],) + ordered.shape[1:], fill, ordered.dtype)
    valid = gather >= 0
    if ordered.shape[0]:
        out[valid] = ordered[gather[valid]]
    return out


def pack_trace_scene(
    meshes: Sequence[Tuple[int, Mesh3D, Optional[BvhNodes]]],
    instances: Sequence[Tuple[int, np.ndarray]],
    deformed_positions: Optional[dict] = None,
    built_blas_out: Optional[dict] = None,
    deformed_attrs: Optional[dict] = None,
) -> TraceScene:
    """Build a TraceScene.

    meshes: (mesh_slot, mesh, optional prebuilt BLAS) — BLAS built here if None.
    instances: (mesh_slot, (I,4,4) world matrices).
    deformed_positions: {mesh_slot: (V,3)} skinned vertex override (BLAS is
    then rebuilt for those meshes).
    deformed_attrs: {mesh_slot: (normals (V,3), tangents (V,4))} skinned
    shading-attribute override — baked into tri_shade so posed characters
    shade with posed normals (reference structs.rs:785-877 transforms
    normals/tangents through the blended joint inverse-transpose).
    built_blas_out: optional dict filled with {slot: BvhNodes} for every
    BLAS built here — callers cache them to skip rebuilds next pack.
    """
    deformed_positions = deformed_positions or {}
    deformed_attrs = deformed_attrs or {}
    depth8 = WIDE_DEPTH
    arity8 = 1 << depth8

    # ---- per-mesh: triangles + BLAS ---------------------------------------
    mesh_index = {}
    blas_arrays: List[BvhNodes] = []
    tri_chunks = []
    vtx_chunks = []
    wide_f_chunks = []
    wide_i_chunks = []
    wide8_box_chunks = []
    wide8_code_chunks = []
    wide8_cnt_chunks = []
    wide8_offset = 0
    node_offset = 0
    tri_offset = 0
    vtx_offset = 0
    wide_offset = 0
    mesh_info = {}  # slot -> (node_root, aabb_min, aabb_max, wide_root)
    mesh_tri_spans = {}  # slot -> (lo, hi) triangle-arena slice

    for slot, mesh, prebuilt in meshes:
        pos = deformed_positions.get(slot, mesh.positions)
        i0, i1, i2 = mesh.indices[:, 0], mesh.indices[:, 1], mesh.indices[:, 2]
        v0 = pos[i0]
        e1 = pos[i1] - v0
        e2 = pos[i2] - v0
        bvh = prebuilt
        if bvh is not None and slot in deformed_positions:
            # skinned/deformed mesh with cached topology: REFIT instead of a
            # full SAH rebuild (reference gpu-rt lib.rs:1345-1384 refits
            # per-mesh BVHs per frame). Topology comes from the first build;
            # bounds tighten bottom-up to the new pose.
            mn, mx = triangle_aabbs(v0, v0 + e1, v0 + e2)
            bvh = refit_bvh(bvh, mn, mx)
        elif bvh is None:
            mn, mx = triangle_aabbs(v0, v0 + e1, v0 + e2)
            bvh = build_bvh_sah(mn, mx, max_leaf=TREELET)
            if built_blas_out is not None:
                built_blas_out[slot] = bvh

        # TREELET-align leaf triangle ranges (see _align_leaf_tris)
        bvh, gather, _padded = _align_leaf_tris(bvh, len(i0))

        # Rebase node child/leaf indices into global arenas.
        is_leaf = bvh.node_count > 0
        left = np.where(is_leaf, bvh.node_left + tri_offset, bvh.node_left + node_offset)
        right = np.where(is_leaf, 0, bvh.node_right + node_offset)
        blas_arrays.append(
            BvhNodes(bvh.node_min, bvh.node_max, left.astype(np.int32),
                     right.astype(np.int32), bvh.node_count, bvh.prim_order)
        )

        # Triangle arena in *BVH leaf order* (prim_order applied, leaf gaps
        # filled with degenerate triangles) so leaves are contiguous and no
        # extra indirection is needed at trace time.
        po = bvh.prim_order.astype(np.int64)
        nrm, tangents = deformed_attrs.get(slot, (mesh.normals, mesh.tangents))
        shade = np.concatenate([
            nrm[i0[po]], nrm[i1[po]], nrm[i2[po]],
            mesh.uvs[i0[po]], mesh.uvs[i1[po]], mesh.uvs[i2[po]],
            tangents[i0[po]],  # xyz + handedness
            e1[po], e2[po],
            _tri_lod_factor(mesh, po)[:, None],
            # lanes 26:29 — object-space centroid: the potential-pick MIS
            # reconstruction anchors the hit emitter's score at the same
            # centroid the sampler scored (wavefront._light_potentials)
            v0[po] + (e1[po] + e2[po]) / 3.0,
            np.zeros((len(po), 3), np.float32),
        ], axis=1).astype(np.float32)  # (t,32)
        # lanes 29/30 — material id + light id as exact f32 ints: the
        # shading basis decodes them from the ONE tri_shade gather it
        # already pays instead of two more full-front row gathers
        mat_p = _pad_gather(mesh.tri_material[po], gather)
        light_p = _pad_gather(mesh.tri_light[po], gather, fill=-1)
        shade_p = _pad_gather(shade, gather)
        shade_p[:, 29] = mat_p.astype(np.float32)
        shade_p[:, 30] = light_p.astype(np.float32)
        tri_chunks.append(
            dict(
                shade=shade_p,
                v0=_pad_gather(v0[po], gather), e1=_pad_gather(e1[po], gather),
                e2=_pad_gather(e2[po], gather),
                i0=_pad_gather((i0[po] + vtx_offset).astype(np.int32), gather),
                i1=_pad_gather((i1[po] + vtx_offset).astype(np.int32), gather),
                i2=_pad_gather((i2[po] + vtx_offset).astype(np.int32), gather),
                mat=mat_p,
                light=light_p,
                mesh=np.full(gather.shape[0], slot, np.int32),
                lodf=_pad_gather(_tri_lod_factor(mesh, po), gather),
            )
        )
        vtx_chunks.append(
            dict(normal=nrm, uv=mesh.uvs, tangent=tangents)
        )
        # wide mirror (leaf first-tri pre-offset into the packed arena)
        wf, wi, wroot = build_wide_nodes(bvh, tlas=False, leaf_base_offset=tri_offset)
        wi = wi.copy()
        internal_child = wi[:, :2] >= 0
        wi[:, :2] = np.where(internal_child, wi[:, :2] + wide_offset, wi[:, :2])
        wide_f_chunks.append(wf)
        wide_i_chunks.append(wi)

        # wide supernode mirror (arity = RFW_WIDE_ARITY, default 8)
        b8, c8, n8 = build_widen(bvh, tlas=False,
                                 leaf_base_offset=tri_offset, depth=depth8)
        c8 = np.where(c8 >= 0, c8 + wide8_offset, c8)
        wide8_box_chunks.append(b8)
        wide8_code_chunks.append(c8)
        wide8_cnt_chunks.append(n8)

        pos_mn = pos.min(axis=0) if len(pos) else np.zeros(3, np.float32)
        pos_mx = pos.max(axis=0) if len(pos) else np.zeros(3, np.float32)
        mesh_info[slot] = (node_offset, pos_mn.astype(np.float32), pos_mx.astype(np.float32),
                           wroot + wide_offset, wide8_offset)
        mesh_tri_spans[slot] = (tri_offset, tri_offset + gather.shape[0])
        node_offset += bvh.num_nodes
        tri_offset += gather.shape[0]  # TREELET-aligned padded arena size
        vtx_offset += pos.shape[0]
        wide_offset += wf.shape[0]
        wide8_offset += b8.shape[0]

    def cat(key, chunks, default_shape, dtype):
        arrs = [c[key] for c in chunks]
        if not arrs:
            return np.zeros(default_shape, dtype)
        return np.ascontiguousarray(np.concatenate(arrs)).astype(dtype)

    blas_min = cat("node_min", [b.__dict__ for b in blas_arrays], (0, 3), np.float32)
    blas_max = cat("node_max", [b.__dict__ for b in blas_arrays], (0, 3), np.float32)
    blas_left = cat("node_left", [b.__dict__ for b in blas_arrays], (0,), np.int32)
    blas_right = cat("node_right", [b.__dict__ for b in blas_arrays], (0,), np.int32)
    blas_count = cat("node_count", [b.__dict__ for b in blas_arrays], (0,), np.int32)

    # ---- instances + TLAS --------------------------------------------------
    inst_matrix_list = []
    inst_mesh_list = []
    for slot, mats in instances:
        if slot not in mesh_info:
            continue
        mats = np.asarray(mats, np.float32).reshape(-1, 4, 4)
        inst_matrix_list.append(mats)
        inst_mesh_list.append(np.full(mats.shape[0], slot, np.int32))

    if inst_matrix_list:
        inst_matrix = np.concatenate(inst_matrix_list)
        inst_mesh = np.concatenate(inst_mesh_list)
    else:
        inst_matrix = np.zeros((0, 4, 4), np.float32)
        inst_mesh = np.zeros(0, np.int32)

    n_inst = inst_matrix.shape[0]
    inst_inv = (
        np.linalg.inv(inst_matrix).astype(np.float32)
        if n_inst
        else np.zeros((0, 4, 4), np.float32)
    )
    inst_normal = (
        inverse_transpose3(inst_matrix) if n_inst else np.zeros((0, 3, 3), np.float32)
    )
    blas_root = np.array(
        [mesh_info[m][0] for m in inst_mesh], np.int32
    ) if n_inst else np.zeros(0, np.int32)
    blas_wide_root = np.array(
        [mesh_info[m][3] for m in inst_mesh], np.int32
    ) if n_inst else np.zeros(0, np.int32)
    blas8_root = np.array(
        [mesh_info[m][4] for m in inst_mesh], np.int32
    ) if n_inst else np.zeros(0, np.int32)

    # world-space instance bounds for TLAS
    if n_inst:
        local_min = np.stack([mesh_info[m][1] for m in inst_mesh])
        local_max = np.stack([mesh_info[m][2] for m in inst_mesh])
        wb = aabb_transform(Aabb(local_min, local_max), inst_matrix)
        inst_wmin, inst_wmax = wb.min.astype(np.float32), wb.max.astype(np.float32)
        tlas = build_bvh_sah(wb.min, wb.max, max_leaf=1)
        tlas_wf, tlas_wi, tlas_wroot = build_wide_nodes(tlas, tlas=True)
        assert tlas_wroot == 0
        tlas8_box, tlas8_code, tlas8_cnt = build_widen(
            tlas, tlas=True, depth=depth8)
    else:
        inst_wmin = np.zeros((0, 3), np.float32)
        inst_wmax = np.zeros((0, 3), np.float32)
        tlas = build_bvh_sah(np.zeros((0, 3)), np.zeros((0, 3)))
        tlas_wf = np.zeros((1, 12), np.float32)
        tlas_wi = np.full((1, 4), -1, np.int32)
        tlas8_box = np.full((1, 6 * arity8), np.inf, np.float32)
        tlas8_code = np.full((1, arity8), -1, np.int32)
        tlas8_cnt = np.zeros((1, arity8), np.int32)

    P = _pad_rows
    blas8_box_arr = (np.concatenate(wide8_box_chunks) if wide8_box_chunks
                     else np.full((1, 6 * arity8), np.inf, np.float32))
    # pad unused wide8 children with never-hit boxes so padded supernodes
    # are inert even if ever referenced
    blas8_box_pad = _cap_rows(blas8_box_arr.shape[0]) - blas8_box_arr.shape[0]
    if blas8_box_pad:
        empty = np.full((blas8_box_pad, 6 * arity8), np.inf, np.float32)
        empty[:, 3::6] = -np.inf
        empty[:, 4::6] = -np.inf
        empty[:, 5::6] = -np.inf
        blas8_box_arr = np.concatenate([blas8_box_arr, empty])

    return TraceScene(
        tlas_min=P(tlas.node_min), tlas_max=P(tlas.node_max),
        tlas_left=P(tlas.node_left), tlas_right=P(tlas.node_right),
        tlas_count=P(tlas.node_count), tlas_prim=P(tlas.prim_order),
        inst_matrix=P(inst_matrix), inst_inv=P(inst_inv),
        inst_normal=P(inst_normal), inst_mesh=P(inst_mesh, fill=-1),
        inst_aabb_min=P(inst_wmin, fill=np.inf),
        inst_aabb_max=P(inst_wmax, fill=-np.inf),
        blas_min=P(blas_min), blas_max=P(blas_max), blas_left=P(blas_left),
        blas_right=P(blas_right), blas_count=P(blas_count),
        blas_root=P(blas_root),
        tlas_wide_f=P(tlas_wf), tlas_wide_i=P(tlas_wi, fill=-1),
        blas_wide_f=P(np.concatenate(wide_f_chunks) if wide_f_chunks
                      else np.zeros((1, 12), np.float32)),
        blas_wide_i=P(np.concatenate(wide_i_chunks) if wide_i_chunks
                      else np.full((1, 4), -1, np.int32), fill=-1),
        blas_wide_root=P(blas_wide_root),
        tlas8_box=P(tlas8_box), tlas8_code=P(tlas8_code, fill=-1),
        tlas8_cnt=P(tlas8_cnt),
        blas8_box=blas8_box_arr,
        blas8_code=P(np.concatenate(wide8_code_chunks) if wide8_code_chunks
                     else np.full((1, arity8), -1, np.int32), fill=-1),
        blas8_cnt=P(np.concatenate(wide8_cnt_chunks) if wide8_cnt_chunks
                    else np.zeros((1, arity8), np.int32)),
        blas8_root=P(blas8_root),
        tri_v0=P(cat("v0", tri_chunks, (0, 3), np.float32), 8192, linear=True),
        tri_e1=P(cat("e1", tri_chunks, (0, 3), np.float32), 8192, linear=True),
        tri_e2=P(cat("e2", tri_chunks, (0, 3), np.float32), 8192, linear=True),
        tri_i0=P(cat("i0", tri_chunks, (0,), np.int32), 8192, linear=True),
        tri_i1=P(cat("i1", tri_chunks, (0,), np.int32), 8192, linear=True),
        tri_i2=P(cat("i2", tri_chunks, (0,), np.int32), 8192, linear=True),
        tri_mat=P(cat("mat", tri_chunks, (0,), np.int32), 8192, linear=True),
        tri_light=P(cat("light", tri_chunks, (0,), np.int32), 8192, fill=-1,
                    linear=True),
        tri_mesh=P(cat("mesh", tri_chunks, (0,), np.int32), 8192, linear=True),
        tri_lodf=P(cat("lodf", tri_chunks, (0,), np.float32), 8192, linear=True),
        vtx_normal=P(cat("normal", vtx_chunks, (0, 3), np.float32), 8192,
                     linear=True),
        vtx_uv=P(cat("uv", vtx_chunks, (0, 2), np.float32), 8192, linear=True),
        vtx_tangent=P(cat("tangent", vtx_chunks, (0, 4), np.float32), 8192,
                      linear=True),
        tri_shade=P(cat("shade", tri_chunks, (0, 32), np.float32), 8192,
                    linear=True),
        mesh_tri_range=_mesh_range_table(mesh_tri_spans),
    )


def _mesh_range_table(spans: dict) -> np.ndarray:
    """(M,2) i32 per-SLOT [lo, hi) triangle-arena ranges; absent slots
    get [0, 0) (the dense items tier then never selects them)."""
    m_cap = (max(spans) + 1) if spans else 1
    table = np.zeros((m_cap, 2), np.int32)
    for s, (lo, hi) in spans.items():
        table[s] = (lo, hi)
    return table


def repack_instances(
    base: TraceScene,
    meshes_info: Sequence[Tuple[int, np.ndarray, np.ndarray]],
    instances: Sequence[Tuple[int, np.ndarray]],
) -> TraceScene:
    """Instance/TLAS-only update: reuse all geometry arenas of `base`,
    replacing instance matrices and rebuilding the TLAS (the per-frame path
    for moving instances — reference gpu-rt rebuilds only the TLAS each
    synchronize, lib.rs:1570-1581).

    meshes_info: (slot, local_aabb_min, local_aabb_max) for every mesh;
    instances must cover the same mesh slots as the base pack (per-slot
    instance COUNTS may change only if the BLAS roots per instance are
    recomputed — they are, from mesh slots).
    """
    info = {slot: (mn, mx) for slot, mn, mx in meshes_info}
    # recover wide roots per mesh slot from the base pack (skip capacity
    # padding rows, marked inst_mesh == -1)
    slot_root = {}
    slot_wroot = {}
    for i in range(base.inst_matrix.shape[0]):
        m = int(base.inst_mesh[i])
        if m < 0:
            continue
        slot_root[m] = int(base.blas_root[i])
        slot_wroot[m] = int(base.blas_wide_root[i])

    mats_list, mesh_list = [], []
    for slot, mats in instances:
        if slot not in slot_root or slot not in info:
            continue
        mats = np.asarray(mats, np.float32).reshape(-1, 4, 4)
        mats_list.append(mats)
        mesh_list.append(np.full(mats.shape[0], slot, np.int32))
    if not mats_list:
        return base
    inst_matrix = np.concatenate(mats_list)
    inst_mesh = np.concatenate(mesh_list)
    inst_inv = np.linalg.inv(inst_matrix).astype(np.float32)
    inst_normal = inverse_transpose3(inst_matrix)
    blas_root = np.array([slot_root[int(m)] for m in inst_mesh], np.int32)
    blas_wide_root = np.array([slot_wroot[int(m)] for m in inst_mesh], np.int32)

    local_min = np.stack([info[int(m)][0] for m in inst_mesh])
    local_max = np.stack([info[int(m)][1] for m in inst_mesh])
    wb = aabb_transform(Aabb(local_min.astype(np.float32),
                             local_max.astype(np.float32)), inst_matrix)
    tlas = build_bvh_sah(wb.min, wb.max, max_leaf=1)
    tlas_wf, tlas_wi, _ = build_wide_nodes(tlas, tlas=True)
    # match the base pack's supernode arity (shape-derived, not env)
    base_depth = int(base.blas8_code.shape[1]).bit_length() - 1
    tlas8_box, tlas8_code, tlas8_cnt = build_widen(
        tlas, tlas=True, depth=base_depth)
    slot_root8 = {}
    for i in range(base.inst_matrix.shape[0]):
        m = int(base.inst_mesh[i])
        if m >= 0:
            slot_root8[m] = int(base.blas8_root[i])
    blas8_root = np.array([slot_root8[int(m)] for m in inst_mesh], np.int32)

    P = _pad_rows
    return base._replace(
        tlas_min=P(tlas.node_min), tlas_max=P(tlas.node_max),
        tlas_left=P(tlas.node_left), tlas_right=P(tlas.node_right),
        tlas_count=P(tlas.node_count), tlas_prim=P(tlas.prim_order),
        tlas_wide_f=P(tlas_wf), tlas_wide_i=P(tlas_wi, fill=-1),
        tlas8_box=P(tlas8_box), tlas8_code=P(tlas8_code, fill=-1),
        tlas8_cnt=P(tlas8_cnt),
        inst_matrix=P(inst_matrix), inst_inv=P(inst_inv),
        inst_normal=P(inst_normal), inst_mesh=P(inst_mesh, fill=-1),
        inst_aabb_min=P(wb.min.astype(np.float32), fill=np.inf),
        inst_aabb_max=P(wb.max.astype(np.float32), fill=-np.inf),
        blas_root=P(blas_root), blas_wide_root=P(blas_wide_root),
        blas8_root=P(blas8_root),
    )


def build_widen(bvh: BvhNodes, tlas: bool, leaf_base_offset: int = 0,
                depth: int = 3, root: int = 0):
    """Collapse the binary BVH into (1<<depth)-wide super nodes (`depth`
    levels at a time) for the traversal kernel: fewer dependent node
    visits per ray at more box tests per visit. The renderer uses depth=3
    (8-wide).

    Returns (box (S,6*arity) f32, code (S,arity) i32, cnt (S,arity) i32):
      child k occupies box[:, 6k:6k+6] = [min3 | max3];
      code >= 0: child super-node id; code < 0: leaf, payload = -code-1
        (TLAS: instance id; BLAS: first packed-triangle index, pre-offset);
      unused children carry empty boxes (+inf/-inf) and are never visited.

    `root` collapses the subtree rooted there (merged node arenas).

    """
    from collections import deque

    arity = 1 << depth

    n_count = bvh.node_count
    n_left = bvh.node_left
    n_right = bvh.node_right

    def leaf_payload(n: int) -> int:
        if tlas:
            return int(bvh.prim_order[n_left[n]])
        return int(n_left[n]) + leaf_base_offset

    # root is a leaf: single super node with one leaf child
    if n_count[root] > 0:
        box = np.empty((1, 6 * arity), np.float32)
        for k in range(arity):
            box[0, 6 * k : 6 * k + 3] = np.inf
            box[0, 6 * k + 3 : 6 * k + 6] = -np.inf
        box[0, 0:3] = bvh.node_min[root]
        box[0, 3:6] = bvh.node_max[root]
        code = np.full((1, arity), -1, np.int32)
        cnt = np.zeros((1, arity), np.int32)
        code[0, 0] = -(leaf_payload(root) + 1)
        cnt[0, 0] = int(n_count[root])
        return box, code, cnt

    super_of = {}
    order = []
    queue = deque()

    def sid(b: int) -> int:
        if b not in super_of:
            super_of[b] = len(order)
            order.append(b)
            queue.append(b)
        return super_of[b]

    sid(root)
    children = []
    while queue:
        b = queue.popleft()
        entries = []
        frontier = [(int(n_left[b]), 1), (int(n_right[b]), 1)]
        while frontier:
            n, dpt = frontier.pop()
            if n_count[n] > 0:
                entries.append(("leaf", n))
            elif dpt >= depth:
                entries.append(("int", n))
            else:
                frontier.append((int(n_left[n]), dpt + 1))
                frontier.append((int(n_right[n]), dpt + 1))
        children.append(entries)
        for kind, n in entries:
            if kind == "int":
                sid(n)

    S = len(order)
    box = np.empty((S, 6 * arity), np.float32)
    box[:, 0::6] = np.inf
    box[:, 1::6] = np.inf
    box[:, 2::6] = np.inf
    box[:, 3::6] = -np.inf
    box[:, 4::6] = -np.inf
    box[:, 5::6] = -np.inf
    code = np.full((S, arity), -1, np.int32)
    cnt = np.zeros((S, arity), np.int32)
    for si, entries in enumerate(children):
        for k, (kind, n) in enumerate(entries):
            box[si, 6 * k : 6 * k + 3] = bvh.node_min[n]
            box[si, 6 * k + 3 : 6 * k + 6] = bvh.node_max[n]
            if kind == "leaf":
                code[si, k] = -(leaf_payload(n) + 1)
                cnt[si, k] = int(n_count[n])
            else:
                code[si, k] = super_of[n]
    return box, code, cnt


def build_wide8(bvh: BvhNodes, tlas: bool, leaf_base_offset: int = 0):
    """8-wide supernode collapse (see build_widen)."""
    return build_widen(bvh, tlas, leaf_base_offset, depth=3)
