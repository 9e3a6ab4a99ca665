"""Two-level BVH traversal: the CUDA kernel's wrappers and its plain version.

Counterpart of `rfw_tpu/ops/traverse.py`. The TPU kernel
`_traverse_kernel_factory` (closest hit and any hit) becomes the hand-written
CUDA kernel in `rfw_tpu_torch/csrc/traverse.cu`, built at first use by
`ops._build`. Beside it, in this module:

  * `prepare_scene` — counterpart of `prepare_pallas_scene`: node-major
    arrays for the kernel, built on the scene's device from a TraceScene;
  * `closest_hit` / `occluded` — counterparts of `pallas_closest_hit` /
    `pallas_occluded`. For tensors on the card they launch the kernel (or
    raise); for tensors on the CPU they run the plain version. With
    `stats=True` they also return the walk's per-ray counts (`WalkStats`);
  * `launch_shape` — the kernel's block, residency, registers and grid
    (`query_shape`, which the two-phase kernels' wrappers share with
    `stats_buffers` and `plain_stats`);
  * `closest_hit_plain` / `occluded_plain` — a vectorised torch lockstep
    walk over the same prepared arrays, one lane per ray, in the TPU
    kernels' visit order with their leaf test and tie rules. The kernels
    take children nearest first, so they visit fewer nodes (other per-ray
    counts) and agree with it on occlusion flags and on t, and on
    prim/inst/u/v up to exact-t ties. The CPU tests use it, and the smoke
    check compares the kernels with it on the card.
    The two-phase items walk (`ops.traverse_items`) is the same walk
    entered at an instance's BLAS root;
  * `LAUNCHES` — how many times each kernel was launched.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from rfw_tpu_torch.accel.bvh_cpu import TREELET
from rfw_tpu_torch.render.intersect import Hit, T_MAX, T_MIN
from rfw_tpu_torch.render.intersect import limit_of as _t_limit
from rfw_tpu_torch.render.intersect import safe_inv as _safe_inv
from rfw_tpu_torch.utils import trace

#: supernode widths the walks take (the pack's RFW_WIDE_ARITY)
ARITIES = (8, 16, 32)
STACK_DEPTH = 96
TSHIFT = TREELET.bit_length() - 1
#: per-ray iteration cap: a malformed BVH yields a wrong but finite result
MAX_ITERS = 1 << 19

#: kernel launches per kind; each wrapper adds one where it launches
LAUNCHES = {"closest": 0, "occluded": 0}


class WalkStats(NamedTuple):
    """Per-ray counts of one traversal call, each (R,) int32: internal-node
    visits, child box tests (the non-empty child slots of the visited
    nodes), treelet leaf visits and triangle slot tests (a visited leaf's
    `count`, also where an any-hit walk stops inside it; zero for the TLAS
    entries walk, which visits no treelet). `warp_ns` is the kernel's
    (warps, 2) int64 first and last %globaltimer of each launched warp, None
    for the plain walk. `full` is the call's count of stack pushes that
    found the stack full (a 0-d int32 tensor; such a push overwrites the
    top entry, which can lose a subtree).

    rfw_tpu's `stats=True` (`pallas_closest_hit`) stamps one while-iteration
    count per Pallas program, whose walk also visits the empty TLAS slots
    this port skips, so the two are not compared."""

    nodes: torch.Tensor
    boxes: torch.Tensor
    leaves: torch.Tensor
    tris: torch.Tensor
    warp_ns: Optional[torch.Tensor] = None
    full: Optional[torch.Tensor] = None


class PreparedScene(NamedTuple):
    """Node-major traversal arrays (all on one device).

    nodes: (S, 8A) i32 — A-wide supernode rows (A = `arity`, 8, 16 or 32),
      BLAS supernodes first, then the TLAS ones: 6A box-float bit patterns
      (child k: min3|max3 at 6k..6k+5), A child codes, A child counts. TLAS
      internal codes are offset by the BLAS supernode count.
    tris: (C*TREELET, 16) f32 — per triangle slot, the Woop affine in
      floats 0..11 (rows u, v, w of [r | b]); floats 12..15 are zero.
    insts: (I+1, 16) f32 — per instance the world->object 3x4 affine in
      floats 0..11; the last row is the identity (world space).
    roots: (max(I,1),) i32 — BLAS root supernode per instance.
    inst_min, inst_max: (I,3) f32 — world-space instance boxes, arena rows
      (padding rows inverted: +inf / -inf), for two-phase phase A.
    tlo, thi: (max(I,1),) i32 — per instance, the treelet range [tlo, thi)
      of its mesh in the triangle arena (0, 0 where unknown), for the
      dense items tier.
    tbox: (C, 8) f32 — per treelet, the box of the BLAS leaf that names it
      as two float4s (min3, 0 | max3, 0), all zero where no leaf names it;
      the dense items kernel's cull.
    tcount: (C,) i32 — per treelet, that leaf's slot count (its real
      triangles; the slots past it are all-zero Woop rows), 0 where no leaf
      names the treelet.
    arity: the supernode width A of the pack (`render.pack.wide_depth`).
    """

    nodes: torch.Tensor
    tris: torch.Tensor
    insts: torch.Tensor
    roots: torch.Tensor
    tlas_root: int
    n_inst: int  # instance rows; also the index of the identity row
    inst_min: torch.Tensor
    inst_max: torch.Tensor
    tlo: torch.Tensor
    thi: torch.Tensor
    tbox: torch.Tensor
    tcount: torch.Tensor
    arity: int


def _woop12(v0, e1, e2):
    """Per-triangle 3x4 world->unit-triangle affine (Woop's transform), as
    `rfw_tpu/ops/traverse.py::_woop12`: rows map a point p to (u, v, w)
    with p = v0 + u*e1 + v*e2 + w*n, n = cross(e1, e2). For a ray (o, d):
    o' = A@o + b, d' = A@d, t = -o'_w / d'_w, u = o'_u + t*d'_u. Degenerate
    (zero-area / padding) triangles get an all-zero affine, whose t is NaN
    and fails every comparison. Returns (T, 12)."""
    n = torch.linalg.cross(e1, e2, dim=-1)
    det = torch.sum(n * n, dim=-1, keepdim=True)  # |n|^2
    inv = torch.where(det > 0, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    r0 = torch.linalg.cross(e2, n, dim=-1) * inv
    r1 = torch.linalg.cross(n, e1, dim=-1) * inv
    r2 = n * inv
    b0 = -torch.sum(r0 * v0, dim=-1, keepdim=True)
    b1 = -torch.sum(r1 * v0, dim=-1, keepdim=True)
    b2 = -torch.sum(r2 * v0, dim=-1, keepdim=True)
    return torch.cat([r0, b0, r1, b1, r2, b2], dim=1)


def prepare_scene(scene) -> PreparedScene:
    """Build the kernel's node-major arrays from a TraceScene of tensors,
    on the scene's device. The supernode width is the pack's (8, 16 or 32
    children; another raises)."""
    arity = int(scene.blas8_code.shape[1])
    if arity not in ARITIES or scene.tlas8_code.shape[1] != arity:
        raise ValueError(f"supernode arity {arity} (TLAS "
                         f"{scene.tlas8_code.shape[1]}); the traversal takes {ARITIES}")
    dev = scene.tri_v0.device
    nb8 = int(scene.blas8_box.shape[0])
    t_code = scene.tlas8_code.to(torch.int32)
    t_code = torch.where(t_code >= 0, t_code + nb8, t_code)
    box8 = torch.cat([scene.blas8_box, scene.tlas8_box]).to(torch.float32)
    code8 = torch.cat([scene.blas8_code.to(torch.int32), t_code])
    cnt8 = torch.cat([scene.blas8_cnt, scene.tlas8_cnt]).to(torch.int32)
    nodes = torch.cat([box8.contiguous().view(torch.int32), code8, cnt8],
                      dim=1).contiguous()

    n_tri = int(scene.tri_v0.shape[0])
    if n_tri:
        w12 = _woop12(scene.tri_v0.float(), scene.tri_e1.float(),
                      scene.tri_e2.float())
    else:
        w12 = torch.zeros((TREELET, 12), dtype=torch.float32, device=dev)
    padt = -(-w12.shape[0] // TREELET) * TREELET - w12.shape[0]
    tris = torch.cat([w12, torch.zeros((w12.shape[0], 4), dtype=torch.float32,
                                       device=dev)], dim=1)
    if padt:  # pack TREELET-aligns; defensive for hand-built scenes
        tris = torch.cat([tris, torch.zeros((padt, 16), dtype=torch.float32,
                                            device=dev)])

    n_inst = int(scene.inst_matrix.shape[0])
    inv12 = scene.inst_inv[:, :3, :].reshape(-1, 12).to(torch.float32)
    ident = torch.tensor([[1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0]],
                         dtype=torch.float32, device=dev)
    inv12 = torch.cat([inv12, ident])
    insts = torch.cat([inv12, torch.zeros((inv12.shape[0], 4),
                                          dtype=torch.float32, device=dev)], dim=1)
    roots = (scene.blas8_root.to(torch.int32) if n_inst
             else torch.zeros(1, dtype=torch.int32, device=dev))

    # per-instance treelet range of its mesh (pack TREELET-aligns ranges)
    if n_inst:
        rng = scene.mesh_tri_range.to(torch.int32)
        im = scene.inst_mesh.to(torch.int32)
        idx = torch.clamp(im, 0, rng.shape[0] - 1).long()
        present = (im >= 0) & (im < rng.shape[0])
        tlo = torch.where(present, rng[idx, 0], 0) >> TSHIFT
        thi = torch.where(present, rng[idx, 1], 0) >> TSHIFT
    else:
        tlo = thi = torch.zeros(1, dtype=torch.int32, device=dev)
    tbox, tcount = _treelet_tables(box8[:nb8], code8[:nb8], cnt8[:nb8],
                                   tris.shape[0] // TREELET)
    return PreparedScene(nodes=nodes, tris=tris.contiguous(),
                         insts=insts.contiguous(), roots=roots.contiguous(),
                         tlas_root=nb8, n_inst=n_inst,
                         inst_min=scene.inst_aabb_min.to(torch.float32).contiguous(),
                         inst_max=scene.inst_aabb_max.to(torch.float32).contiguous(),
                         tlo=tlo.to(torch.int32).contiguous(),
                         thi=thi.to(torch.int32).contiguous(), tbox=tbox, tcount=tcount,
                         arity=arity)


def _treelet_tables(box, code, cnt, n_treelets: int):
    """Per treelet, the box and slot count of the BLAS leaf child that names
    it, from the A-wide BLAS supernode rows (box (S,6A) f32, code and cnt
    (S,A) i32): a child with code < 0 and cnt > 0 is a leaf whose payload -code-1
    is its first triangle row; its treelet and count are decoded as the
    walk decodes a leaf (csrc/bvh_common.cuh::visit). Returns (tbox
    (n_treelets, 8) f32, tcount (n_treelets,) i32)."""
    dev = box.device
    leaf = (code < 0) & (cnt > 0)
    last = (-code[leaf] - 1) + torch.clamp(cnt[leaf] - 1, max=TREELET - 1)
    tid = (last >> TSHIFT).long()
    ok = tid < n_treelets
    tid, lbox = tid[ok], box.reshape(-1, code.shape[1], 6)[leaf][ok]
    tbox = torch.zeros((n_treelets, 8), dtype=torch.float32, device=dev)
    tbox[tid, 0:3] = lbox[:, 0:3]
    tbox[tid, 4:7] = lbox[:, 3:6]
    tcount = torch.zeros(n_treelets, dtype=torch.int32, device=dev)
    tcount[tid] = ((last[ok] & (TREELET - 1)) + 1).to(torch.int32)
    return tbox, tcount


# ---------------------------------------------------------------- plain path
def _rebase(ps: PreparedScene, ins, wo, wd):
    """World rays (n,3) in the object space of instance rows `ins` (the
    identity row for -1 or out of range): (ox, oy, oz, dx, dy, dz)."""
    n_inst = ps.n_inst
    row = torch.where((ins < 0) | (ins >= n_inst), n_inst, ins).long()
    m = ps.insts[row]
    ox = m[:, 0] * wo[:, 0] + m[:, 1] * wo[:, 1] + m[:, 2] * wo[:, 2] + m[:, 3]
    oy = m[:, 4] * wo[:, 0] + m[:, 5] * wo[:, 1] + m[:, 6] * wo[:, 2] + m[:, 7]
    oz = m[:, 8] * wo[:, 0] + m[:, 9] * wo[:, 1] + m[:, 10] * wo[:, 2] + m[:, 11]
    dx = m[:, 0] * wd[:, 0] + m[:, 1] * wd[:, 1] + m[:, 2] * wd[:, 2]
    dy = m[:, 4] * wd[:, 0] + m[:, 5] * wd[:, 1] + m[:, 6] * wd[:, 2]
    dz = m[:, 8] * wd[:, 0] + m[:, 9] * wd[:, 1] + m[:, 10] * wd[:, 2]
    return ox, oy, oz, dx, dy, dz


def _leaf_slots(tris, first, count, obj, tcur):
    """The kernels' treelet leaf test for n rays at once: the treelet of
    the Woop rows `tris` (a prepared scene's) at triangle row `first` (n,),
    its first `count` (n,) slots, against the object-space rays `obj` =
    (ox, oy, oz, dx, dy, dz) of (n,) each, with hits limited to
    (T_MIN, tcur). Returns (ok, t, u, v), each (n, 64); a treelet that
    would run past the arena passes nothing."""
    treelets = tris.reshape(-1, TREELET, 16)
    ok_rows = first + count <= tris.shape[0]
    rec = treelets[torch.where(ok_rows, first >> TSHIFT, 0).long()]
    a = [rec[:, :, k] for k in range(12)]
    lox, loy, loz, ldx, ldy, ldz = (x[:, None] for x in obj)
    opu = a[0] * lox + a[1] * loy + a[2] * loz + a[3]
    opv = a[4] * lox + a[5] * loy + a[6] * loz + a[7]
    opw = a[8] * lox + a[9] * loy + a[10] * loz + a[11]
    dpu = a[0] * ldx + a[1] * ldy + a[2] * ldz
    dpv = a[4] * ldx + a[5] * ldy + a[6] * ldz
    dpw = a[8] * ldx + a[9] * ldy + a[10] * ldz
    t = -opw / dpw
    u = opu + t * dpu
    v = opv + t * dpv
    slot_ids = torch.arange(TREELET, device=first.device)
    ok = ((u >= -1e-7) & (v >= -1e-7) & (u + v <= 1 + 1e-7)
          & (t > T_MIN) & (t < tcur[:, None])
          & (slot_ids[None, :] < count[:, None]) & ok_rows[:, None])
    return ok, t, u, v


def _child_slab(bx, c, obj_o, inv):
    """Slab test of child c of boxes bx (n, A, 6) for rays with origins
    obj_o and inverse directions inv (3 tuples of (n,)): (tn, tf)."""
    tx0 = (bx[:, c, 0] - obj_o[0]) * inv[0]
    tx1 = (bx[:, c, 3] - obj_o[0]) * inv[0]
    ty0 = (bx[:, c, 1] - obj_o[1]) * inv[1]
    ty1 = (bx[:, c, 4] - obj_o[1]) * inv[1]
    tz0 = (bx[:, c, 2] - obj_o[2]) * inv[2]
    tz1 = (bx[:, c, 5] - obj_o[2]) * inv[2]
    tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                     torch.minimum(ty0, ty1)),
                       torch.minimum(tz0, tz1))
    tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                     torch.maximum(ty0, ty1)),
                       torch.maximum(tz0, tz1))
    return tn, tf


def node_arrays(ps: PreparedScene):
    """(boxes (S,A,6) f32, codes (S,A) i32, counts (S,A) i32) of the A-wide
    supernode rows."""
    S, A = ps.nodes.shape[0], ps.arity
    boxes = ps.nodes[:, :6 * A].contiguous().view(torch.float32)
    return boxes.reshape(S, A, 6), ps.nodes[:, 6 * A:7 * A], ps.nodes[:, 7 * A:8 * A]


def _plain_walk(ps: PreparedScene, ray_o, ray_d, t_limit, any_hit: bool,
                start_inst=None, stats=None):
    """Lockstep torch walk with the kernel's per-ray semantics. Each
    iteration advances every live ray by one node visit; rays that finish
    leave the active set.

    start_inst: None walks both levels from the TLAS root; an (R,) i32
    tensor walks each ray in the BLAS of its instance from that BLAS root
    (the two-phase items walk), and -1 marks an empty item that walks
    nothing. stats: a dict whose "nodes", "boxes", "leaves" and "tris"
    entries gain the internal-node visits, child box tests, treelet leaf
    visits and triangle slot tests the walk made, and whose "per_ray" entry
    becomes the same counts per ray (`WalkStats`, with the call's pushes
    that found the stack full, which "full" also gains)."""
    dev = ray_o.device
    R = ray_o.shape[0]
    i32 = torch.int32
    t_best = torch.clamp(_t_limit(t_limit, R, dev), max=T_MAX)
    prim = torch.full((R,), -1, dtype=i32, device=dev)
    hit_inst = torch.full((R,), -1, dtype=i32, device=dev)
    hit_u = torch.zeros(R, dtype=torch.float32, device=dev)
    hit_v = torch.zeros(R, dtype=torch.float32, device=dev)
    occluded = torch.zeros(R, dtype=torch.bool, device=dev)

    S = ps.nodes.shape[0]
    boxes, codes, cnts = node_arrays(ps)
    n_inst = ps.n_inst

    if start_inst is None:
        node = torch.full((R,), ps.tlas_root, dtype=i32, device=dev)
        inst = torch.full((R,), -1, dtype=i32, device=dev)
    else:
        inst = start_inst.to(i32)
        iid = torch.clamp(inst, 0, max(n_inst - 1, 0)).long()
        node = torch.where(inst >= 0, ps.roots[iid], -1)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    stack = torch.zeros((R, STACK_DEPTH, 2), dtype=i32, device=dev)
    act = torch.arange(R, device=dev)
    if stats is not None:
        per_ray = WalkStats(*(torch.zeros(R, dtype=i32, device=dev) for _ in range(4)))
        full = 0

    for _ in range(MAX_ITERS):
        if act.numel() == 0:
            break
        nd, s, ins = node[act], sp[act], inst[act]
        pop = nd == -1
        live = ~(pop & (s <= 0))
        if not bool(live.all()):
            act, nd, s, ins, pop = act[live], nd[live], s[live], ins[live], pop[live]
            if act.numel() == 0:
                break
        s = torch.where(pop, s - 1, s)
        popped = stack[act, torch.clamp(s, min=0)]
        nd = torch.where(pop, popped[:, 0], nd)
        ins = torch.where(pop, popped[:, 1], ins)

        # the ray in the current instance's object space
        ox, oy, oz, dx, dy, dz = _rebase(ps, ins, ray_o[act], ray_d[act])

        new_node = torch.full_like(nd, -1)
        new_inst = ins.clone()
        finished = torch.zeros_like(pop)

        # ---- treelet leaves: test the leaf's `count` slots
        leaf = (nd <= -2).nonzero().squeeze(1)
        if leaf.numel():
            lv = -nd[leaf] - 2
            first = (lv >> TSHIFT) << TSHIFT
            count = (lv & (TREELET - 1)) + 1
            rays = act[leaf]
            tcur = t_best[rays]
            ok, t, u, v = _leaf_slots(
                ps.tris, first, count,
                (ox[leaf], oy[leaf], oz[leaf], dx[leaf], dy[leaf], dz[leaf]), tcur)
            if stats is not None:
                in_arena = first + count <= ps.tris.shape[0]
                tested = torch.where(in_arena, count, 0).to(i32)
                per_ray.leaves.index_add_(0, rays, in_arena.to(i32))
                per_ray.tris.index_add_(0, rays, tested)
                stats["leaves"] = stats.get("leaves", 0) + int(in_arena.sum())
                stats["tris"] = stats.get("tris", 0) + int(tested.sum())
            if any_hit:
                hit = ok.any(dim=1)
                occluded[rays[hit]] = True
                finished[leaf[hit]] = True
            else:
                score = torch.where(ok, t, float("inf"))
                win = torch.argmin(score, dim=1)  # lowest slot among ties
                tmin = score.gather(1, win[:, None])[:, 0]
                hit = tmin < tcur
                hr = rays[hit]
                wsel = win[hit, None]
                t_best[hr] = tmin[hit]
                prim[hr] = (first[hit] + win[hit]).to(i32)
                hit_inst[hr] = ins[leaf[hit]]
                hit_u[hr] = u[hit].gather(1, wsel)[:, 0]
                hit_v[hr] = v[hit].gather(1, wsel)[:, 0]

        # ---- internal supernodes: push every hit child but the last,
        # descend into the last
        inner = ((nd >= 0) & (nd < S)).nonzero().squeeze(1)
        if inner.numel():
            nidx = nd[inner].long()
            bx, cd, cn = boxes[nidx], codes[nidx], cnts[nidx]
            obj_o = (ox[inner], oy[inner], oz[inner])
            inv = (_safe_inv(dx[inner]), _safe_inv(dy[inner]), _safe_inv(dz[inner]))
            rays = act[inner]
            tb = t_best[rays]
            cur_inst = ins[inner]
            in_tlas = cur_inst < 0
            next_code = torch.full_like(cur_inst, -1)
            next_inst = cur_inst.clone()
            spi = s[inner]
            if stats is not None:
                boxes_r = (~((cd < 0) & (cn == 0))).sum(dim=1).to(i32)
                per_ray.nodes.index_add_(0, rays, torch.ones_like(boxes_r))
                per_ray.boxes.index_add_(0, rays, boxes_r)
                stats["nodes"] = stats.get("nodes", 0) + int(inner.numel())
                stats["boxes"] = stats.get("boxes", 0) + int(boxes_r.sum())
            for c in range(ps.arity):
                code, cnt = cd[:, c], cn[:, c]
                tn, tf = _child_slab(bx, c, obj_o, inv)
                hitc = ((tn <= tf) & (tf > T_MIN) & (tn < tb)
                        & ~((code < 0) & (cnt == 0)))
                payload = -code - 1
                leaf_child = code < 0
                iid = torch.clamp(payload, 0, max(n_inst - 1, 0)).long()
                tlas_entry = ps.roots[iid]
                blas_entry = -(payload + torch.clamp(cnt - 1, max=TREELET - 1)) - 2
                e_code = torch.where(leaf_child,
                                     torch.where(in_tlas, tlas_entry, blas_entry), code)
                e_inst = torch.where(leaf_child & in_tlas, payload, cur_inst)
                push = hitc & (next_code != -1)
                if bool(push.any()):
                    slot = torch.clamp(spi[push], max=STACK_DEPTH - 1)
                    stack[rays[push], slot, 0] = next_code[push]
                    stack[rays[push], slot, 1] = next_inst[push]
                    if stats is not None:
                        full += int((spi[push] >= STACK_DEPTH).sum())
                spi = torch.where(push, torch.clamp(spi + 1, max=STACK_DEPTH), spi)
                next_code = torch.where(hitc, e_code, next_code)
                next_inst = torch.where(hitc, e_inst, next_inst)
            new_node[inner] = next_code
            new_inst[inner] = next_inst
            s[inner] = spi

        node[act] = new_node
        inst[act] = new_inst
        sp[act] = s
        if any_hit and bool(finished.any()):
            act = act[~finished]

    if stats is not None:
        stats["full"] = stats.get("full", 0) + full
        stats["per_ray"] = per_ray._replace(full=torch.tensor(full, dtype=i32, device=dev))
    if any_hit:
        return occluded
    return Hit(t_best, prim, hit_inst, hit_u, hit_v)


def closest_hit_plain(ps: PreparedScene, ray_o, ray_d, t_limit=T_MAX,
                      stats=None) -> Hit:
    """Plain torch closest hit (any device)."""
    return _plain_walk(ps, ray_o, ray_d, t_limit, any_hit=False, stats=stats)


def occluded_plain(ps: PreparedScene, ray_o, ray_d, t_limit,
                   stats=None) -> torch.Tensor:
    """Plain torch occlusion: True where geometry lies in (T_MIN, t_limit)."""
    return _plain_walk(ps, ray_o, ray_d, t_limit, any_hit=True, stats=stats)


# ---------------------------------------------------------------- CUDA path
def check_rays(ps: PreparedScene, ray_o, ray_d) -> None:
    """Raise unless the rays are contiguous (R,3) float32 tensors on a
    CUDA device, with every prepared array a contiguous tensor of its type
    on that device. The kernels of this package share these checks."""
    if ray_o.device.type != "cuda":
        raise ValueError(f"traversal runs on the CPU or a CUDA device, "
                         f"not {ray_o.device}")
    for name, a in (("ray_o", ray_o), ("ray_d", ray_d)):
        if a.dtype != torch.float32 or a.dim() != 2 or a.shape[1] != 3:
            raise ValueError(f"{name}: expected (R,3) float32, got "
                             f"{tuple(a.shape)} {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ray_o.shape != ray_d.shape:
        raise ValueError("ray_o and ray_d differ in shape")
    dev = ray_o.device
    if ray_d.device != dev:
        raise ValueError("ray_o and ray_d are on different devices")
    for name, a, dt in (("nodes", ps.nodes, torch.int32),
                        ("tris", ps.tris, torch.float32),
                        ("insts", ps.insts, torch.float32),
                        ("roots", ps.roots, torch.int32),
                        ("tlo", ps.tlo, torch.int32),
                        ("thi", ps.thi, torch.int32),
                        ("tbox", ps.tbox, torch.float32),
                        ("tcount", ps.tcount, torch.int32)):
        if a.device != dev or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"prepared scene {name} must be a contiguous "
                             f"{dt} tensor on {dev}")


def ptr(x):
    """A tensor's device pointer for ctypes (None for None)."""
    return ctypes.c_void_p(x.data_ptr()) if x is not None else None


def stream_of(dev) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `dev`, for ctypes."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def query_shape(library: str, fn: str, variant: int, stats: bool, n: int,
                device=None, arity=None) -> dict:
    """The launch shape of one instance of a persistent walk kernel
    (`csrc/bvh_common.cuh::info`), through `fn(variant, stats, n, out)` of
    the kernel library `library` (`fn(variant, stats, arity, n, out)` for
    the walks of an A-wide scene, given `arity`), on `device` (default: the
    current CUDA device): block threads, resident blocks per SM, SMs,
    registers per thread, local bytes per thread, static shared bytes per
    block, threads per SM, and the blocks launched for `n` rays."""
    from rfw_tpu_torch.ops._build import load_library

    lib = load_library(library)
    out = (ctypes.c_int * 8)()
    args = (int(variant), int(stats)) + (() if arity is None else (int(arity),))
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = getattr(lib, fn)(*args, int(n), out)
    if rc != 0:
        raise RuntimeError(f"{library} kernel query failed: cudaError {rc}")
    keys = ("block", "blocks_per_sm", "sms", "registers", "local_bytes", "shared_bytes",
            "threads_per_sm", "grid")
    return dict(zip(keys, out))


def launch_shape(any_hit: bool, stats: bool = False, n_rays: int = 0, device=None,
                 arity: int = 8) -> dict:
    """The launch shape of one instance of the K1/K2 kernel (`query_shape`)
    for an `arity`-wide scene."""
    return query_shape("traverse", "rfw_traverse_info", any_hit, stats, n_rays, device, arity)


def stats_buffers(shape: dict, n: int, dev):
    """Zeroed outputs of a counting launch of `shape` over n rays: the
    per-ray counts (n, 4) int32 and the per-warp spans (warps, 2) int64."""
    counts = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    warp_ns = torch.zeros((shape["grid"] * shape["block"] // 32, 2), dtype=torch.int64,
                          device=dev)
    return counts, warp_ns


def counters(dev) -> torch.Tensor:
    """The zeroed int32 pair a persistent walk launch takes: the warps' ray
    counter and the counting instance's count of full-stack pushes."""
    return torch.zeros(2, dtype=torch.int32, device=dev)


def kernel_stats(counts, warp_ns, next_ray) -> WalkStats:
    """The WalkStats of a counting launch from its outputs."""
    return WalkStats(*counts.unbind(1), warp_ns=warp_ns, full=next_ray[1])


def _launch(ps: PreparedScene, ray_o, ray_d, t_limit, any_hit: bool, stats: bool):
    from rfw_tpu_torch.ops._build import load_library

    check_rays(ps, ray_o, ray_d)
    lib = load_library("traverse")
    R = ray_o.shape[0]
    dev = ray_o.device
    tl = _t_limit(t_limit, R, dev)
    f32, i32 = torch.float32, torch.int32
    if any_hit:
        occ = torch.empty(R, dtype=torch.bool, device=dev)
        t = prim = inst = u = v = None
    else:
        t = torch.empty(R, dtype=f32, device=dev)
        prim = torch.empty(R, dtype=i32, device=dev)
        inst = torch.empty(R, dtype=i32, device=dev)
        u = torch.empty(R, dtype=f32, device=dev)
        v = torch.empty(R, dtype=f32, device=dev)
        occ = None
    counts = warp_ns = None
    if stats:
        counts, warp_ns = stats_buffers(launch_shape(any_hit, True, R, dev, ps.arity), R, dev)
    out = occ if any_hit else Hit(t, prim, inst, u, v)
    next_ray = counters(dev)
    if R > 0:
        with torch.cuda.device(dev):
            rc = lib.rfw_traverse(
                int(any_hit), ps.arity,
                ptr(ps.nodes), ps.nodes.shape[0],
                ptr(ps.tris), ps.tris.shape[0],
                ptr(ps.insts), ps.n_inst,
                ptr(ps.roots), ps.tlas_root,
                ptr(ray_o), ptr(ray_d), ptr(tl), R,
                ptr(t), ptr(prim), ptr(inst), ptr(u), ptr(v), ptr(occ),
                ptr(next_ray), ptr(counts), ptr(warp_ns),
                stream_of(dev),
            )
        if rc != 0:
            raise RuntimeError(f"traverse kernel launch failed: cudaError {rc}")
        LAUNCHES["occluded" if any_hit else "closest"] += 1
    if not stats:
        return out
    return out, kernel_stats(counts, warp_ns, next_ray)


def plain_stats(plain, *args):
    """plain(*args, stats=...)'s result and its per-ray counts (WalkStats)."""
    counts = {}
    out = plain(*args, stats=counts)
    return out, counts["per_ray"]


def closest_hit(ps: PreparedScene, ray_o, ray_d, t_limit=T_MAX, stats: bool = False):
    """Closest hit of (R,3) rays: the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU. With `stats`, (Hit, WalkStats)."""
    with trace.span("rfw.trace.closest"):
        if ray_o.device.type == "cpu":
            if stats:
                return plain_stats(closest_hit_plain, ps, ray_o, ray_d, t_limit)
            return closest_hit_plain(ps, ray_o, ray_d, t_limit)
        return _launch(ps, ray_o, ray_d, t_limit, any_hit=False, stats=stats)


def occluded(ps: PreparedScene, ray_o, ray_d, t_limit, stats: bool = False):
    """Occlusion of (R,3) rays within (T_MIN, t_limit): the CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU. With
    `stats`, (flags, WalkStats)."""
    with trace.span("rfw.trace.occluded"):
        if ray_o.device.type == "cpu":
            if stats:
                return plain_stats(occluded_plain, ps, ray_o, ray_d, t_limit)
            return occluded_plain(ps, ray_o, ray_d, t_limit)
        return _launch(ps, ray_o, ray_d, t_limit, any_hit=True, stats=stats)


# ------------------------------------------------- rfw_tpu's names for these
PallasScene = PreparedScene
prepare_pallas_scene = prepare_scene


def pallas_closest_hit(ps: PreparedScene, ray_o, ray_d, t_limit=T_MAX,
                       interpret: bool = False, stats: bool = False,
                       tri_hbm: bool = False):
    """`closest_hit` with `rfw_tpu`'s keywords: `interpret=True` runs the
    plain version on any device (the counterpart of Pallas interpret mode);
    `tri_hbm` changes nothing, since the kernel reads the triangle arena
    from global memory either way. Unlike `rfw_tpu`'s, `stats=True`
    returns (Hit, WalkStats), the port's per-ray counts, and leaves u as
    the barycentric u (`rfw_tpu` puts iteration counts in it)."""
    if interpret:
        if stats:
            return plain_stats(closest_hit_plain, ps, ray_o, ray_d, t_limit)
        return closest_hit_plain(ps, ray_o, ray_d, t_limit)
    return closest_hit(ps, ray_o, ray_d, t_limit, stats=stats)


def pallas_occluded(ps: PreparedScene, ray_o, ray_d, t_limit,
                    interpret: bool = False, tri_hbm: bool = False) -> torch.Tensor:
    """`occluded` with `rfw_tpu`'s keywords (see `pallas_closest_hit`):
    (R,) bool."""
    if interpret:
        return occluded_plain(ps, ray_o, ray_d, t_limit).to(torch.bool)
    return occluded(ps, ray_o, ray_d, t_limit).to(torch.bool)
