"""On-device dynamic geometry: LBS skinning, morphs and BVH refit.

Counterpart of `rfw_tpu/render/refit_device.py`. Reference semantics:
vertex skinning with normal/tangent inverse-transpose
(crates/rfw-backend/src/structs.rs:785-877) and per-mesh BVH refit
(backends/gpu-rt/src/lib.rs:1345-1384).

A skinned or morphed frame uploads joint matrices and morph weights (KBs)
and `apply_dynamic` runs on the scene's device:

  * LBS over rest vertices, normals through the blend-matrix cofactor
    (the inverse-transpose direction), tangents through the blend itself,
    handedness by the determinant's sign — the host
    `skin_mesh_attributes` in structure;
  * re-bakes the triangle arena slices (v0/e1/e2 and the 32-lane
    tri_shade shading record) with static uv, material and light columns;
  * refits every acceleration mirror bottom-up with a static topology
    schedule (host-built scatter maps and level index arrays): 2-ary BLAS
    nodes -> 2-wide blas_wide_f -> 8-wide blas8_box, then instance world
    AABBs -> 2-ary TLAS -> tlas_wide_f -> tlas8_box.
`instance_motion_update` refits the instance arrays and every TLAS mirror
from fresh instance matrices.

The plans (`build_unit_plan`, `build_tlas_plan`) are numpy, copies of the
JAX package's, rebuilt on the host after every full repack;
`plan_to_device` carries one to a device. The device half runs eagerly,
one small op per BVH level and per Jacobi sweep. It writes every updated
arena into fresh tensors (never into the input scene's, which other scenes
may share) and computes in float32 without matrix products, so the result
does not depend on TF32 settings.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rfw_tpu_torch.render.pack import TraceScene
from rfw_tpu_torch.utils import trace


class UnitPlan(NamedTuple):
    """Static per-deformable-unit metadata (one skinned/morphed mesh copy).

    Every index is LOCAL to the unit's arena slices unless named *_lo (the
    slice offsets into the global arenas). Sentinel convention: scatter
    maps use one-past-the-end rows, so fillers fall off the buffers.
    """

    # rest-pose vertex data
    rest_pos: np.ndarray  # (V,3) f32
    rest_nrm: np.ndarray  # (V,3)
    rest_tan: np.ndarray  # (V,4) xyz + handedness
    joints: np.ndarray  # (V,4) i32
    weights: np.ndarray  # (V,4) f32
    morph_pos: np.ndarray  # (M,V,3) position deltas (M may be 0)
    morph_nrm: np.ndarray  # (M,V,3) NORMAL deltas (zeros when absent)
    morph_tan: np.ndarray  # (M,V,3) TANGENT xyz deltas (zeros when absent)

    # triangle arena slice (rows are leaf-ordered, TREELET-aligned)
    tri_lo: np.ndarray  # () i32 global row offset
    r0: np.ndarray  # (Trows,) i32 local vertex id, -1 = alignment filler
    r1: np.ndarray
    r2: np.ndarray
    uv_cols: np.ndarray  # (Trows,6) f32 static tri_shade uv columns (9:15)
    ml_cols: np.ndarray  # (Trows,2) f32 static tri_shade mat/light id
    #   columns (29:31), pose-invariant
    lodf: np.ndarray  # (Trows,) f32 static texture-LOD factor (the
    #   reference computes LOD once from the REST pose,
    #   objects_3d/mod.rs:355-358)

    # 2-ary node slice
    node_lo: np.ndarray  # () i32
    leaf_of_row: np.ndarray  # (Trows,) i32 local leaf node id, N = filler
    levels: Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], ...]
    #   deepest-first internal levels: (ids, lchild, rchild) local
    node_shape: np.ndarray  # (N,0) zero-width carrier of the node count

    # 2-wide mirror slice
    wide_lo: np.ndarray  # () i32
    internals: np.ndarray  # (Nw,) i32 internal node local ids in wide order
    wide_l: np.ndarray  # (Nw,) i32 left child node local id
    wide_r: np.ndarray  # (Nw,) i32 right child node local id
    wide_syn: np.ndarray  # (1,0) if single-leaf-root synthetic else (0,0)

    # 8-wide mirror slice
    w8_lo: np.ndarray  # () i32
    row_to_w8: np.ndarray  # (Trows,) i32 s*8+k scatter target, S*8 = none
    levels8: Tuple[Tuple[np.ndarray, np.ndarray], ...]
    #   deepest-first internal child levels: (targets s*8+k, source s')
    w8_shape: np.ndarray  # (S,0) zero-width carrier of the supernode count

    # instances of this unit
    inst_rows: np.ndarray  # (Ii,) i32 global instance indices


class TlasPlan(NamedTuple):
    """TLAS refit metadata (topology from the last host build).

    Every array is padded to the scene's capacity, with one-past-the-end
    scatter sentinels, and the bottom-up propagation runs as `passes`
    Jacobi sweeps over all internal nodes: after k sweeps every node
    within k of the deepest leaf is right, so passes >= tree depth
    converges. The pass count is rounded up to a multiple of 4."""

    leaf_nodes: np.ndarray  # (Icap,) i32 leaf node id, sentinel Ncap
    leaf_inst: np.ndarray  # (Icap,) i32 instance id per leaf, 0-padded
    internals: np.ndarray  # (Ncap,) i32 internal node ids, sentinel Ncap
    int_l: np.ndarray  # (Ncap,) i32 left child, 0-padded
    int_r: np.ndarray  # (Ncap,) i32 right child, 0-padded
    wide_row: np.ndarray  # (Ncap,) i32 2-wide mirror row per internal,
    #   sentinel Nwcap
    wide_syn: np.ndarray  # (1,0) if single-leaf-root synthetic else (0,0)
    leaf8_targets: np.ndarray  # (Icap,) i32 s*8+k, sentinel Scap*8
    leaf8_inst: np.ndarray  # (Icap,) i32, 0-padded
    int8_targets: np.ndarray  # (Scap,) i32 s*8+k, sentinel Scap*8
    int8_sources: np.ndarray  # (Scap,) i32 source supernode, 0-padded
    passes_shape: np.ndarray  # (D,0) zero-width: Jacobi sweep count
    node_shape: np.ndarray  # (Ncap,0) zero-width shape carrier
    wide_shape: np.ndarray  # (Nwcap,0)
    w8_shape: np.ndarray  # (Scap,0)


# --------------------------------------------------------------- host plans
def _node_levels(left: np.ndarray, right: np.ndarray, count: np.ndarray):
    """Group INTERNAL nodes by depth, deepest first. Children always have
    higher indices than parents (bvh_cpu layout), so one forward pass
    computes depths."""
    n = len(count)
    depth = np.zeros(n, np.int32)
    internal = count == 0
    for i in range(n):
        if internal[i]:
            depth[left[i]] = depth[i] + 1
            depth[right[i]] = depth[i] + 1
    ids = np.nonzero(internal)[0]
    out = []
    if len(ids):
        for d in range(int(depth[ids].max()), -1, -1):
            lvl = ids[depth[ids] == d]
            if len(lvl):
                out.append((lvl.astype(np.int32),
                            left[lvl].astype(np.int32),
                            right[lvl].astype(np.int32)))
    return tuple(out)


def _wide8_levels(code: np.ndarray, cnt: np.ndarray):
    """The bottom-up internal-child schedule of an 8-wide mirror from
    (code, cnt) alone. A supernode's own box is the union of its 8 child
    boxes, so an internal child slot (s,k) -> s' refits as union(row s').
    Returns deepest-first levels of (targets = s*8+k, sources = s')."""
    S = code.shape[0]
    depth = np.zeros(S, np.int32)
    targets, sources, src_depth = [], [], []
    for s in range(S):
        for k in range(8):
            c = int(code[s, k])
            if c >= 0:
                depth[c] = depth[s] + 1
    for s in range(S):
        for k in range(8):
            c = int(code[s, k])
            if c >= 0:
                targets.append(s * 8 + k)
                sources.append(c)
                src_depth.append(depth[c])
    if not targets:
        return tuple()
    targets = np.asarray(targets, np.int32)
    sources = np.asarray(sources, np.int32)
    src_depth = np.asarray(src_depth, np.int32)
    out = []
    for d in range(int(src_depth.max()), -1, -1):
        m = src_depth == d
        if m.any():
            out.append((targets[m], sources[m]))
    return tuple(out)


def build_unit_plan(
    scene: TraceScene,
    ranges: dict,
    rest_pos: np.ndarray,
    rest_nrm: np.ndarray,
    rest_tan: np.ndarray,
    joints: Optional[np.ndarray],
    weights: Optional[np.ndarray],
    morph_targets: Optional[np.ndarray],
    morph_normals: Optional[np.ndarray] = None,
    morph_tangents: Optional[np.ndarray] = None,
) -> UnitPlan:
    """Extract one unit's static refit metadata from the packed scene.

    ranges: the pack's per-mesh arena ranges (pack_trace_scene
    mesh_ranges_out entry): tri/node/wide/w8 (lo, hi) pairs.
    """
    t_lo, t_hi = ranges["tri"]
    n_lo, n_hi = ranges["node"]
    w_lo, w_hi = ranges["wide"]
    s_lo, s_hi = ranges["w8"]
    rows = t_hi - t_lo
    N = n_hi - n_lo

    # 2-ary topology (local index space)
    count = scene.blas_count[n_lo:n_hi]
    left_g = scene.blas_left[n_lo:n_hi]
    right_g = scene.blas_right[n_lo:n_hi]
    is_leaf = count > 0
    # leaves: left = global arena first-row; internals: left = global node id
    left = np.where(is_leaf, left_g - t_lo, left_g - n_lo).astype(np.int32)
    right = np.where(is_leaf, 0, right_g - n_lo).astype(np.int32)

    leaf_of_row = np.full(rows, N, np.int32)
    for li in np.nonzero(is_leaf)[0]:
        lo = int(left[li])
        leaf_of_row[lo:lo + int(count[li])] = li

    levels = _node_levels(left, right, count)

    # real rows are exactly the rows some leaf covers; the gaps are the
    # TREELET-alignment fillers (degenerate, never hit)
    valid = leaf_of_row < N
    v_lo = ranges["vtx"][0]
    gi0 = scene.tri_i0[t_lo:t_hi].astype(np.int64) - v_lo
    gi1 = scene.tri_i1[t_lo:t_hi].astype(np.int64) - v_lo
    gi2 = scene.tri_i2[t_lo:t_hi].astype(np.int64) - v_lo
    r0 = np.where(valid, gi0, -1).astype(np.int32)
    r1 = np.where(valid, gi1, -1).astype(np.int32)
    r2 = np.where(valid, gi2, -1).astype(np.int32)

    # static shading columns come straight from the packed REST scene
    uv_cols = scene.tri_shade[t_lo:t_hi, 9:15].astype(np.float32)
    ml_cols = scene.tri_shade[t_lo:t_hi, 29:31].astype(np.float32)
    lodf = scene.tri_lodf[t_lo:t_hi].astype(np.float32)

    # 2-wide mirror: wide rows mirror internal nodes in node order
    internals = np.nonzero(~is_leaf)[0].astype(np.int32)
    wide_synthetic = len(internals) == 0
    if wide_synthetic:
        wide_l = np.zeros(1, np.int32)
        wide_r = np.zeros(1, np.int32)
        internals = np.zeros(1, np.int32)
        assert w_hi - w_lo == 1
    else:
        wide_l = left[internals]
        wide_r = right[internals]
        assert w_hi - w_lo == len(internals), (w_hi - w_lo, len(internals))

    # 8-wide mirror: leaf children scatter rows by payload range
    S = s_hi - s_lo
    code = scene.blas8_code[s_lo:s_hi].copy()
    cnt8 = scene.blas8_cnt[s_lo:s_hi]
    code = np.where(code >= 0, code - s_lo, code)
    row_to_w8 = np.full(rows, S * 8, np.int32)
    for s in range(S):
        for k in range(8):
            c = int(code[s, k])
            # leaf child: code = -(first+1); code==-1 is ambiguous (first
            # tri 0 vs unused slot) — cnt>0 disambiguates
            if c < 0 and (c != -1 or cnt8[s, k] > 0):
                first = -c - 1 - t_lo
                row_to_w8[first:first + int(cnt8[s, k])] = s * 8 + k
    levels8 = _wide8_levels(code, cnt8)

    V = rest_pos.shape[0]
    if joints is None:
        joints = np.zeros((V, 4), np.int32)
        weights = np.zeros((V, 4), np.float32)
    if morph_targets is None:
        morph_targets = np.zeros((0, V, 3), np.float32)
    M = morph_targets.shape[0]
    if morph_normals is None:
        morph_normals = np.zeros((M, V, 3), np.float32)
    if morph_tangents is None:
        morph_tangents = np.zeros((M, V, 3), np.float32)

    return UnitPlan(
        rest_pos=rest_pos.astype(np.float32),
        rest_nrm=rest_nrm.astype(np.float32),
        rest_tan=rest_tan.astype(np.float32),
        joints=joints.astype(np.int32),
        weights=weights.astype(np.float32),
        morph_pos=np.asarray(morph_targets, np.float32),
        morph_nrm=np.asarray(morph_normals, np.float32),
        morph_tan=np.asarray(morph_tangents, np.float32),
        tri_lo=np.int32(t_lo), r0=r0, r1=r1, r2=r2,
        uv_cols=uv_cols, ml_cols=ml_cols, lodf=lodf,
        node_lo=np.int32(n_lo), leaf_of_row=leaf_of_row, levels=levels,
        node_shape=np.zeros((N, 0), np.float32),
        wide_lo=np.int32(w_lo), internals=internals,
        wide_l=wide_l, wide_r=wide_r,
        wide_syn=np.zeros((1 if wide_synthetic else 0, 0), np.float32),
        w8_lo=np.int32(s_lo), row_to_w8=row_to_w8, levels8=levels8,
        w8_shape=np.zeros((S, 0), np.float32),
        inst_rows=np.zeros(0, np.int32),  # filled by caller
    )


def build_tlas_plan(scene: TraceScene, min_passes: int = 4) -> TlasPlan:
    """TLAS refit metadata from the packed (padded) scene arrays.

    Every output is padded to the scene's capacity. The logical tree is
    recovered by BFS from the root (padded rows masquerade as internal
    nodes pointing at node 0 and must not be touched)."""
    left_a = scene.tlas_left.astype(np.int32)
    right_a = scene.tlas_right.astype(np.int32)
    count_a = scene.tlas_count.astype(np.int32)
    Ncap = left_a.shape[0]
    Icap = scene.inst_mesh.shape[0]
    Nwcap = scene.tlas_wide_f.shape[0]
    Scap = scene.tlas8_code.shape[0]

    if int((scene.inst_mesh >= 0).sum()) == 0:
        # empty scene: node 0 is a padding row whose 0-children would
        # cycle the BFS — emit an all-sentinel no-op plan
        z = np.zeros((0, 0), np.float32)
        return TlasPlan(
            leaf_nodes=np.full(Icap, Ncap, np.int32),
            leaf_inst=np.zeros(Icap, np.int32),
            internals=np.full(Ncap, Ncap, np.int32),
            int_l=np.zeros(Ncap, np.int32),
            int_r=np.zeros(Ncap, np.int32),
            wide_row=np.full(Ncap, Nwcap, np.int32),
            wide_syn=z,
            leaf8_targets=np.full(Icap, Scap * 8, np.int32),
            leaf8_inst=np.zeros(Icap, np.int32),
            int8_targets=np.full(Scap, Scap * 8, np.int32),
            int8_sources=np.zeros(Scap, np.int32),
            passes_shape=np.zeros((4, 0), np.float32),
            node_shape=np.zeros((Ncap, 0), np.float32),
            wide_shape=np.zeros((Nwcap, 0), np.float32),
            w8_shape=np.zeros((Scap, 0), np.float32),
        )

    frontier = np.array([0], np.int32)
    leaf_nodes_l, leaf_inst_l, int_l = [], [], []
    depth = 0
    while frontier.size:
        depth += 1
        is_leaf = count_a[frontier] > 0
        leaves = frontier[is_leaf]
        if leaves.size:
            leaf_nodes_l.append(leaves)
            leaf_inst_l.append(scene.tlas_prim[left_a[leaves]])
        internal = frontier[~is_leaf]
        if internal.size:
            int_l.append(internal)
            frontier = np.concatenate([left_a[internal], right_a[internal]])
        else:
            frontier = np.zeros(0, np.int32)

    def pad_to(a, cap, fill):
        out = np.full(cap, fill, np.int32)
        out[: len(a)] = a
        return out

    leaf_nodes = (np.concatenate(leaf_nodes_l).astype(np.int32)
                  if leaf_nodes_l else np.zeros(0, np.int32))
    leaf_inst = (np.concatenate(leaf_inst_l).astype(np.int32)
                 if leaf_inst_l else np.zeros(0, np.int32))
    internals = (np.sort(np.concatenate(int_l)).astype(np.int32)
                 if int_l else np.zeros(0, np.int32))
    wide_synthetic = len(internals) == 0
    # 2-wide rows mirror internals in ascending node order
    wide_row = np.arange(len(internals), dtype=np.int32)

    # logical tlas8 prefix: BFS over internal-child codes from supernode 0
    code_a = scene.tlas8_code
    cnt_a = scene.tlas8_cnt
    seen = {0}
    stack = [0]
    while stack:
        s = stack.pop()
        for k in range(8):
            c = int(code_a[s, k])
            if c >= 0 and c not in seen:
                seen.add(c)
                stack.append(c)
    n_w8 = max(seen) + 1
    t8, i8, it8, is8 = [], [], [], []
    for s in range(n_w8):
        for k in range(8):
            c = int(code_a[s, k])
            if c >= 0:
                it8.append(s * 8 + k)
                is8.append(c)
            elif c != -1 or cnt_a[s, k] > 0:
                t8.append(s * 8 + k)
                i8.append(-c - 1)

    # Jacobi sweep count: tree depth rounded up to a multiple of 4;
    # callers pass their previous plan's count as min_passes (a high-water
    # mark). tlas8 collapses 3 levels per hop, so the count covers it too.
    passes = max(min_passes, -(-depth // 4) * 4)
    return TlasPlan(
        leaf_nodes=pad_to(leaf_nodes, Icap, Ncap),
        leaf_inst=pad_to(leaf_inst, Icap, 0),
        internals=pad_to(internals, Ncap, Ncap),
        int_l=pad_to(left_a[internals], Ncap, 0),
        int_r=pad_to(right_a[internals], Ncap, 0),
        wide_row=pad_to(wide_row, Ncap, Nwcap),
        wide_syn=np.zeros((1 if wide_synthetic else 0, 0), np.float32),
        leaf8_targets=pad_to(np.asarray(t8, np.int32), Icap, Scap * 8),
        leaf8_inst=pad_to(np.asarray(i8, np.int32), Icap, 0),
        int8_targets=pad_to(np.asarray(it8, np.int32), Scap, Scap * 8),
        int8_sources=pad_to(np.asarray(is8, np.int32), Scap, 0),
        passes_shape=np.zeros((passes, 0), np.float32),
        node_shape=np.zeros((Ncap, 0), np.float32),
        wide_shape=np.zeros((Nwcap, 0), np.float32),
        w8_shape=np.zeros((Scap, 0), np.float32),
    )


def plan_to_device(plan, device):
    """A UnitPlan or TlasPlan of numpy arrays -> the same plan of tensors
    on `device` (the counterpart of `jax.device_put(plan)`): scalar offsets
    become ints, integer arrays int64 index tensors, float arrays float32
    tensors (the zero-width shape carriers keep their shapes)."""
    def conv(x):
        if isinstance(x, tuple):
            return tuple(conv(e) for e in x)
        a = np.asarray(x)
        if a.ndim == 0:
            return int(a)
        dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return type(plan)(*[conv(getattr(plan, f)) for f in plan._fields])


# ------------------------------------------------------------- device apply
def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) by elementwise products and a sum."""
    return (m * v[..., None, :]).sum(dim=-1)


def _normalize_or(x: torch.Tensor, fallback: torch.Tensor, ok=None) -> torch.Tensor:
    """x / |x| where |x| > 1e-12 (and `ok`), else `fallback`."""
    ln = torch.linalg.norm(x, dim=-1, keepdim=True)
    keep = ln > 1e-12 if ok is None else ok[:, None] & (ln > 1e-12)
    return torch.where(keep, x / torch.clamp(ln, min=1e-12), fallback)


def _lbs_attributes(plan: UnitPlan, jm, morph_w):
    """Device LBS with host skin_mesh_attributes semantics: positions by
    the blended matrix, normals by its cofactor (inverse-transpose
    direction incl. det sign), tangents by the blend, handedness flip on
    mirrored blends. All-zero weights (or a degenerate blend) keep rest
    attributes."""
    p = plan.rest_pos
    base_n = plan.rest_nrm
    base_t4 = plan.rest_tan
    if plan.morph_pos.shape[0]:
        w = morph_w[:, None, None]
        p = p + (w * plan.morph_pos).sum(dim=0)
        # NORMAL/TANGENT morph deltas: displace, renormalize (glTF: morphs
        # apply before the skin). Zero deltas are exact no-ops.
        base_n = _normalize_or(base_n + (w * plan.morph_nrm).sum(dim=0), base_n)
        t = _normalize_or(base_t4[:, :3] + (w * plan.morph_tan).sum(dim=0),
                          base_t4[:, :3])
        base_t4 = torch.cat([t, base_t4[:, 3:4]], dim=1)
    if jm is None:
        return p, base_n, base_t4

    A = (plan.weights[:, :, None, None] * jm[plan.joints]).sum(dim=1)  # (V,4,4)
    has_w = plan.weights.sum(dim=-1) > 1e-8
    pos = _matvec(A[:, :3, :3], p) + A[:, :3, 3]
    pos = torch.where(has_w[:, None], pos, p)

    B = A[:, :3, :3]
    b0, b1, b2 = B[:, 0, :], B[:, 1, :], B[:, 2, :]
    cof_rows = torch.stack([_cross(b1, b2), _cross(b2, b0), _cross(b0, b1)],
                           dim=1)  # rows of det * inv(B)^T
    det = (b0 * _cross(b1, b2)).sum(dim=-1)
    ok = has_w & (torch.abs(det) > 1e-12)

    n = _matvec(cof_rows, base_n) * torch.sign(det)[:, None]
    n = _normalize_or(n, base_n, ok)
    t = _normalize_or(_matvec(B, base_t4[:, :3]), base_t4[:, :3], ok)
    handed = base_t4[:, 3:4] * torch.where((det < 0)[:, None], -1.0, 1.0)
    handed = torch.where(ok[:, None], handed, base_t4[:, 3:4])
    return pos, n, torch.cat([t, handed], dim=1)


def _scatter(n_rows: int, idx: torch.Tensor, src: torch.Tensor, reduce: str) -> torch.Tensor:
    """(n_rows, 3) of +inf ("amin") or -inf ("amax") with `src` rows
    reduced into rows `idx` (the `.at[idx].min/max` of a fresh buffer)."""
    fill = float("inf") if reduce == "amin" else -float("inf")
    out = torch.full((n_rows, 3), fill, dtype=torch.float32, device=src.device)
    return out.scatter_reduce_(0, idx[:, None].expand(-1, 3), src, reduce,
                               include_self=True)


def _refit_unit(out: dict, plan: UnitPlan, jm, morph_w):
    """Rebuild one unit's arena slices from posed vertices, writing them
    into the fresh arenas of `out`. Returns the unit's (obj_min, obj_max);
    the instance and TLAS refit happen in apply_dynamic once all units are
    in."""
    pos, nrm, tan4 = _lbs_attributes(plan, jm, morph_w)

    valid = (plan.r0 >= 0)[:, None]
    r0, r1, r2 = (torch.clamp(r, min=0) for r in (plan.r0, plan.r1, plan.r2))
    v0 = torch.where(valid, pos[r0], 0.0)
    p1 = torch.where(valid, pos[r1], 0.0)
    p2 = torch.where(valid, pos[r2], 0.0)
    e1 = p1 - v0
    e2 = p2 - v0

    # tri_shade record (render/pack.py layout: n0 n1 n2 uv0 uv1 uv2 tan
    # handed e1 e2 lodf centroid mat light pad1 = 32 lanes)
    t0 = tan4[r0]
    shade = torch.cat([
        nrm[r0], nrm[r1], nrm[r2], plan.uv_cols, t0[:, :3], t0[:, 3:4],
        e1, e2, plan.lodf[:, None],
        v0 + (e1 + e2) / 3.0,  # lanes 26:29 centroid (pack.py layout)
    ], dim=1)
    # pose-dependent lanes masked on filler rows; the static mat/light id
    # columns append afterwards so fillers keep the packed values
    shade = torch.where(valid, shade, 0.0)
    shade = torch.cat([shade, plan.ml_cols, torch.zeros_like(shade[:, :1])], dim=1)

    # ---- 2-ary node refit (leaf scatter + static level loop) -------------
    inf = float("inf")
    mn_row = torch.where(valid, torch.minimum(torch.minimum(v0, p1), p2), inf)
    mx_row = torch.where(valid, torch.maximum(torch.maximum(v0, p1), p2), -inf)
    N = plan.node_shape.shape[0]
    nmin = _scatter(N + 1, plan.leaf_of_row, mn_row, "amin")
    nmax = _scatter(N + 1, plan.leaf_of_row, mx_row, "amax")
    for ids, l, r in plan.levels:
        nmin[ids] = torch.minimum(nmin[l], nmin[r])
        nmax[ids] = torch.maximum(nmax[l], nmax[r])
    nmin = nmin[:N]
    nmax = nmax[:N]

    # ---- 2-wide mirror ---------------------------------------------------
    if plan.wide_syn.shape[0]:
        wf = torch.cat([nmin[0:1], nmax[0:1], torch.full_like(nmin[0:1], inf),
                        torch.full_like(nmin[0:1], -inf)], dim=1)
    else:
        wf = torch.cat([nmin[plan.wide_l], nmax[plan.wide_l],
                        nmin[plan.wide_r], nmax[plan.wide_r]], dim=1)

    # ---- 8-wide mirror (leaf scatter + bottom-up union levels) -----------
    S = plan.w8_shape.shape[0]
    mn8 = _scatter(S * 8 + 1, plan.row_to_w8, mn_row, "amin")[: S * 8]
    mx8 = _scatter(S * 8 + 1, plan.row_to_w8, mx_row, "amax")[: S * 8]
    for targets, sources in plan.levels8:
        mn8[targets] = mn8.view(S, 8, 3)[sources].amin(dim=1)
        mx8[targets] = mx8.view(S, 8, 3)[sources].amax(dim=1)
    box8 = torch.cat([mn8.view(S, 8, 3), mx8.view(S, 8, 3)], dim=2).reshape(S, 48)

    # ---- write the slices into the fresh global arenas -------------------
    for name, lo, val in (("tri_v0", plan.tri_lo, v0), ("tri_e1", plan.tri_lo, e1),
                          ("tri_e2", plan.tri_lo, e2), ("tri_shade", plan.tri_lo, shade),
                          ("blas_min", plan.node_lo, nmin),
                          ("blas_max", plan.node_lo, nmax),
                          ("blas_wide_f", plan.wide_lo, wf),
                          ("blas8_box", plan.w8_lo, box8)):
        out[name][lo:lo + val.shape[0]] = val
    obj_min = mn_row.amin(dim=0)
    obj_max = mx_row.amax(dim=0)
    return obj_min, obj_max


def _refit_tlas(scene: TraceScene, plan: TlasPlan, ibmin, ibmax) -> TraceScene:
    """Refit the TLAS mirrors from per-instance world boxes (full arrays,
    already updated for the deformed units).

    `passes` Jacobi sweeps over all internal nodes. Padding entries write
    into one-past-the-end sentinel rows, several of them into one row, but
    always the same value (instance 0's box, or node 0's), and no real row
    reads a sentinel row, so the order of those writes does not matter."""
    inf = float("inf")
    N = plan.node_shape.shape[0]
    passes = plan.passes_shape.shape[0]

    nmin = torch.full((N + 1, 3), inf, dtype=torch.float32, device=ibmin.device)
    nmax = torch.full((N + 1, 3), -inf, dtype=torch.float32, device=ibmin.device)
    nmin[plan.leaf_nodes] = ibmin[plan.leaf_inst]
    nmax[plan.leaf_nodes] = ibmax[plan.leaf_inst]
    for _ in range(passes):
        nmin[plan.internals] = torch.minimum(nmin[plan.int_l], nmin[plan.int_r])
        nmax[plan.internals] = torch.maximum(nmax[plan.int_l], nmax[plan.int_r])

    Nw = plan.wide_shape.shape[0]
    if plan.wide_syn.shape[0]:
        wf = scene.tlas_wide_f.clone()
        wf[0, 0:3] = nmin[0]
        wf[0, 3:6] = nmax[0]
    else:
        rows = torch.cat([nmin[plan.int_l], nmax[plan.int_l],
                          nmin[plan.int_r], nmax[plan.int_r]], dim=1)
        wf = torch.cat([scene.tlas_wide_f, torch.zeros_like(scene.tlas_wide_f[:1])])
        wf[plan.wide_row] = rows
        wf = wf[:Nw]

    S = plan.w8_shape.shape[0]
    mn8 = torch.full((S * 8 + 1, 3), inf, dtype=torch.float32, device=ibmin.device)
    mx8 = torch.full((S * 8 + 1, 3), -inf, dtype=torch.float32, device=ibmin.device)
    mn8[plan.leaf8_targets] = ibmin[plan.leaf8_inst]
    mx8[plan.leaf8_targets] = ibmax[plan.leaf8_inst]
    for _ in range(passes):
        mn8[plan.int8_targets] = mn8[: S * 8].view(S, 8, 3)[plan.int8_sources].amin(dim=1)
        mx8[plan.int8_targets] = mx8[: S * 8].view(S, 8, 3)[plan.int8_sources].amax(dim=1)
    box8 = torch.cat([mn8[: S * 8].view(S, 8, 3), mx8[: S * 8].view(S, 8, 3)],
                     dim=2).reshape(S, 48)

    return scene._replace(
        tlas_min=nmin[:N],
        tlas_max=nmax[:N],
        tlas_wide_f=wf,
        tlas8_box=box8,
        inst_aabb_min=ibmin,
        inst_aabb_max=ibmax,
    )


#: TraceScene fields `apply_dynamic` rewrites for the deformed units
UNIT_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "tri_shade",
               "blas_min", "blas_max", "blas_wide_f", "blas8_box")
#: TraceScene fields every TLAS refit rewrites
TLAS_FIELDS = ("tlas_min", "tlas_max", "tlas_wide_f", "tlas8_box",
               "inst_aabb_min", "inst_aabb_max")
#: TraceScene fields `instance_motion_update` rewrites
MOTION_FIELDS = TLAS_FIELDS + ("inst_matrix", "inst_inv", "inst_normal")


def _world_box(mats: torch.Tensor, lmin: torch.Tensor, lmax: torch.Tensor):
    """World box of local boxes under affine maps by the |R| center/extent
    identity (equivalent to the 8-corner hull, fewer ops)."""
    c = 0.5 * (lmin + lmax)
    e = 0.5 * (lmax - lmin)
    rot = mats[:, :3, :3]
    wc = _matvec(rot, c) + mats[:, :3, 3]
    we = _matvec(torch.abs(rot), e)
    return wc - we, wc + we


def apply_dynamic(
    scene: TraceScene,
    plans: Sequence[UnitPlan],
    tlas_plan: TlasPlan,
    poses: Sequence,  # per plan: (J,4,4) joint matrices or None
    morph_weights: Sequence,  # per plan: (M,) weights or None
) -> TraceScene:
    """One device update: skin/morph every unit, re-bake its arena slices,
    refit all BLAS mirrors, then the instance boxes and TLAS mirrors.
    Plans and poses are tensors on the scene's device (`plan_to_device`).
    Returns a new TraceScene; the input's tensors are not written. Counts
    the units (`dyn.units`) and the vertices skinned (`dyn.vertices`: those
    of the units with a pose) while a profiler records."""
    trace.count("dyn.units", len(plans))
    trace.count("dyn.vertices", sum(p.rest_pos.shape[0] for p, jm in zip(plans, poses)
                                    if jm is not None))
    out = {f: getattr(scene, f).clone() for f in UNIT_FIELDS}
    ibmin = scene.inst_aabb_min.clone()
    ibmax = scene.inst_aabb_max.clone()
    for plan, jm, mw in zip(plans, poses, morph_weights):
        omin, omax = _refit_unit(out, plan, jm, mw)
        if plan.inst_rows.shape[0]:
            n = plan.inst_rows.shape[0]
            wmin, wmax = _world_box(scene.inst_matrix[plan.inst_rows],
                                    omin.expand(n, 3), omax.expand(n, 3))
            ibmin[plan.inst_rows] = wmin
            ibmax[plan.inst_rows] = wmax
    with trace.span("rfw.sync.dynamics.tlas"):
        return _refit_tlas(scene._replace(**out), tlas_plan, ibmin, ibmax)


def instance_motion_update(
    scene: TraceScene,
    tlas_plan: TlasPlan,
    mats: torch.Tensor,  # (Icap,4,4) f32 object->world, padding rows = identity
    local_min: torch.Tensor,  # (Icap,3) per-instance LOCAL mesh AABB
    local_max: torch.Tensor,  # (Icap,3)
    live: torch.Tensor,  # (Icap,) bool, False on capacity padding rows
) -> TraceScene:
    """Instance-motion-only device update: fresh object->world matrices in,
    every TLAS mirror plus the instance arrays refit on the device.

    The reference gpu-rt rebuilds its TLAS from instance AABBs every
    synchronize (backends/gpu-rt/src/lib.rs:1570-1581), on the host. Here
    the binary/2-wide/8-ary TLAS topologies are kept from the last host
    build and only their boxes refit (always a valid bound): inverse and
    normal (inverse-transpose) matrices, world AABBs by the |R|·extent
    identity, then the shared `_refit_tlas` sweep. `torch.linalg.inv`
    differs from `jnp.linalg.inv` by a few ulps."""
    mats = mats.to(torch.float32)
    inv = torch.linalg.inv(mats)
    # affine inverse-transpose of the 3x3 block == transpose(inv[:3,:3])
    nrm = inv[:, :3, :3].transpose(1, 2).contiguous()
    wmin, wmax = _world_box(mats, local_min, local_max)
    inf = float("inf")
    ibmin = torch.where(live[:, None], wmin, inf)
    ibmax = torch.where(live[:, None], wmax, -inf)
    scene = scene._replace(inst_matrix=mats, inst_inv=inv, inst_normal=nrm)
    return _refit_tlas(scene, tlas_plan, ibmin, ibmax)


def apply_dynamic_jit():
    """`apply_dynamic` itself: `rfw_tpu` returns its jit-compiled form
    here; these eager torch updates need none."""
    return apply_dynamic


def instance_motion_jit():
    """`instance_motion_update` itself (see `apply_dynamic_jit`)."""
    return instance_motion_update
