"""Ray-scene intersection: the `Hit` record, the brute-force oracle and the
lockstep two-level BVH traversal (`traversal="lockstep"`).

Counterpart of `rfw_tpu/render/intersect.py`: the `Hit` record every
traversal returns, the t range, an O(R*T) Möller-Trumbore oracle used by
the tests, and `bvh_closest_hit` / `bvh_occluded`, the oracle tier. Its
walk goes over the BINARY arenas (`tlas_*`, `blas_*` of the TraceScene),
one lane per ray, each ray with its own stack of STACK_DEPTH (node,
instance) entries, on the device of the tensors. A step pops, tests both
children of an internal node (the far one pushed when both hit), enters
an instance's BLAS at a TLAS leaf and tests up to MAX_LEAF triangles at a
BLAS leaf; the lanes at a leaf are gathered (a host read of their
indices each step), their triangles are tested in one batch and the
nearest accepted one wins, the lowest slot on an exact-t tie, which is
what the reference's triangle-by-triangle loop keeps.

Arithmetic: XLA's CPU code contracts a product that feeds an add into a
fused multiply-add, so the reference's dot products, cross products and
3x3 transforms round as FMA chains. `dot3`, `cross3` and
`accel.tlas_device.fma_matvec` compute the same chains (each fused step in
float64, where the product of two float32 values is exact, rounded once to
float32), so t, u, v come out as the reference's on the CPU. The loop reads "every ray done" on the host once every
CHECK_EVERY steps; the steps in between are no-ops for finished rays. The
kernel tier (`ops.traverse`) walks the 8-wide arena instead.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rfw_tpu_torch.accel.bvh_cpu import TREELET
from rfw_tpu_torch.accel.tlas_device import fma_matvec

T_MIN = 1e-5
T_MAX = 1e26
STACK_DEPTH = 64
MAX_LEAF = TREELET  # BLAS leaf capacity (treelet leaves, accel.bvh_cpu)
MAX_ITERS = 1 << 20  # safety cap: a malformed BVH gives a wrong but finite result
#: steps between two host reads of "every ray done"
CHECK_EVERY = 8


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


# ------------------------------------------------------------ arithmetic
def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) over 3 components as XLA's CPU code rounds it:
    fma(a2, b2, fma(a1, b1, a0 * b0))."""
    p = a.double() * b.double()  # exact products
    acc = p[..., 0].float().double()
    acc = (p[..., 1] + acc).float().double()
    return (p[..., 2] + acc).float()


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cross(a, b) as XLA's CPU code rounds it: x = fma(a1, b2, -(a2 b1))
    and its rotations (the second product rounded, the first exact)."""
    ad, bd = a.double(), b.double()
    exact = torch.stack([ad[..., 1] * bd[..., 2], ad[..., 2] * bd[..., 0],
                         ad[..., 0] * bd[..., 1]], dim=-1)
    rounded = torch.stack([a[..., 2] * b[..., 1], a[..., 0] * b[..., 2],
                           a[..., 1] * b[..., 0]], dim=-1)
    return (exact - rounded.double()).float()


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1 / d with |d| below 1e-20 replaced by +-1e-20."""
    return 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)


def limit_of(t_limit, n: int, device) -> torch.Tensor:
    """A scalar or (n,) t_limit as a contiguous (n,) float32 tensor."""
    tl = torch.as_tensor(t_limit, dtype=torch.float32, device=device)
    return torch.broadcast_to(tl, (n,)).contiguous()


def slab(o, inv_d, bmin, bmax):
    """Ray/box slab test over broadcast (..., 3) inputs; returns (hit,
    tnear), hit without a t limit (callers gate tnear themselves). An
    inverted (empty) box may slab as a hit; callers that meet one gate it."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(dim=-1)
    tfar = torch.maximum(t0, t1).amin(dim=-1)
    return (tnear <= tfar) & (tfar > T_MIN), tnear


def _moller_trumbore(o, d, v0, e1, e2):
    """Vectorized Möller-Trumbore over broadcast (..., 3) inputs; returns
    (ok, t, u, v) without the t range test."""
    pvec = cross3(d, e2)
    det = dot3(e1, pvec)
    inv_det = torch.where(det.abs() > 1e-12,
                          1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0
    u = dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    ok = (det.abs() > 1e-12) & (u >= -1e-7) & (v >= -1e-7) & (u + v <= 1 + 1e-7)
    return ok, t, u, v


def leaf_hits(o, d, v0, e1, e2, valid, t_best, t_lim):
    """The triangles of a leaf, batched along dim -2 of v0/e1/e2 (slot k)
    against rays o/d (..., 3) broadcast over it: per ray the nearest slot
    with `valid`, t in (T_MIN, t_best) and t < t_lim, the lowest slot on a
    tie. Returns (accept, slot, t, u, v), each without the slot dim."""
    ok, t, u, v = _moller_trumbore(o.unsqueeze(-2), d.unsqueeze(-2), v0, e1, e2)
    ok = (ok & valid & (t > T_MIN) & (t < t_best.unsqueeze(-1))
          & (t < t_lim.unsqueeze(-1)))
    k = torch.where(ok, t, float("inf")).argmin(dim=-1, keepdim=True)
    take = lambda x: x.gather(-1, k).squeeze(-1)  # noqa: E731
    return take(ok), k.squeeze(-1), take(t), take(u), take(v)


def leaf_lanes(scene, lane, first, count, o, d, t_best, t_lim):
    """The lanes `lane` (indices into per-lane (R,) / (R,3) arrays) each at
    a leaf of `count[lane]` triangles from arena row `first[lane]`: one
    batched test of up to MAX_LEAF rows of the scene's triangle arena.
    Returns (accept, prim, t, u, v) per lane of `lane`."""
    slots = torch.arange(MAX_LEAF, device=lane.device)
    tri = torch.clamp(first[lane, None] + slots, 0, scene.tri_v0.shape[0] - 1).long()
    acc, k, t, u, v = leaf_hits(o[lane], d[lane], scene.tri_v0[tri], scene.tri_e1[tri],
                                scene.tri_e2[tri], slots < count[lane, None],
                                t_best[lane], t_lim[lane])
    return acc, tri.gather(1, k[:, None]).squeeze(1).to(torch.int32), t, u, v


def put(full: torch.Tensor, lane: torch.Tensor, take: torch.Tensor, val) -> torch.Tensor:
    """A copy of `full` with rows `lane` set to `val` where `take`."""
    out = full.clone()
    out[lane] = torch.where(take, val, full[lane])
    return out


def run_steps(step, state, done_of, max_iters: int = MAX_ITERS):
    """Advance `state` by `step` until done_of(state) is all set or
    max_iters steps ran, reading the flag on the host every CHECK_EVERY
    steps (a step leaves a finished lane as it is)."""
    iters = 0
    while iters < max_iters and not bool(done_of(state).all()):
        for _ in range(min(CHECK_EVERY, max_iters - iters)):
            state = step(state)
        iters += CHECK_EVERY
    return state


# ------------------------------------------------------- lockstep walk
def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with idx clamped into the table (lanes whose index
    belongs to the other arena read a row they then discard)."""
    return table[idx.clamp(0, max(table.shape[0] - 1, 0)).long()]


class _Lane(NamedTuple):
    node: torch.Tensor  # (R,) current node, -1 => pop
    inst: torch.Tensor  # (R,) current instance (-1 = in the TLAS)
    sp: torch.Tensor  # (R,)
    stack_node: torch.Tensor  # (R, STACK_DEPTH)
    stack_inst: torch.Tensor  # (R, STACK_DEPTH)
    t: torch.Tensor
    prim: torch.Tensor
    hit_inst: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    done: torch.Tensor  # (R,) bool


def _traversal(scene, ray_o, ray_d, t_limit, any_hit: bool) -> Hit:
    """The lockstep two-level walk. any_hit=False: closest hit;
    any_hit=True: a ray stops at its first accepted hit."""
    R = ray_o.shape[0]
    dev = ray_o.device
    f32, i32 = torch.float32, torch.int32
    rows = torch.arange(R, device=dev)
    t_lim = torch.as_tensor(t_limit, dtype=f32, device=dev).expand(R)
    n_tri = scene.tri_v0.shape[0]

    def obj_ray(inst):
        """Each lane's ray in its current space (world where inst < 0)."""
        inv = _rows(scene.inst_inv, torch.clamp(inst, min=0))  # (R,4,4)
        o = fma_matvec(inv[:, :3, :3], ray_o) + inv[:, :3, 3]
        d = fma_matvec(inv[:, :3, :3], ray_d)
        in_tlas = (inst < 0)[:, None]
        return torch.where(in_tlas, ray_o, o), torch.where(in_tlas, ray_d, d)

    def step(s: _Lane) -> _Lane:
        # -- pop phase: lanes with node == -1 pop or finish
        need_pop = (s.node < 0) & ~s.done
        can_pop = need_pop & (s.sp > 0)
        sp = torch.where(can_pop, s.sp - 1, s.sp)
        top = torch.clamp(sp, min=0).long()
        node = torch.where(can_pop, s.stack_node[rows, top], s.node)
        inst = torch.where(can_pop, s.stack_inst[rows, top], s.inst)
        done = s.done | (need_pop & (s.sp == 0))
        active = ~done & (node >= 0)

        in_tlas = inst < 0
        o, d = obj_ray(inst)
        inv_d = safe_inv(d)

        # -- node fields from each lane's arena
        def field(tl, bl):
            return torch.where(in_tlas, _rows(tl, node), _rows(bl, node))

        count = field(scene.tlas_count, scene.blas_count)
        left = field(scene.tlas_left, scene.blas_left)
        right = field(scene.tlas_right, scene.blas_right)
        is_leaf = count > 0

        # -- internal nodes: test both children
        def box(tl, bl, idx):
            return torch.where(in_tlas[:, None], _rows(tl, idx), _rows(bl, idx))

        lhit, lt = slab(o, inv_d, box(scene.tlas_min, scene.blas_min, left),
                        box(scene.tlas_max, scene.blas_max, left))
        rhit, rt = slab(o, inv_d, box(scene.tlas_min, scene.blas_min, right),
                        box(scene.tlas_max, scene.blas_max, right))
        lhit, rhit = lhit & (lt < s.t), rhit & (rt < s.t)
        internal = active & ~is_leaf
        both = internal & lhit & rhit
        near_is_left = lt <= rt
        near = torch.where(near_is_left, left, right)
        far = torch.where(near_is_left, right, left)
        one = internal & (lhit ^ rhit)
        only = torch.where(lhit, left, right)

        # push the far child where both hit
        slot = torch.clamp(sp, max=STACK_DEPTH - 1).long()
        stack_node, stack_inst = s.stack_node.clone(), s.stack_inst.clone()
        stack_node[rows, slot] = torch.where(both, far, s.stack_node[rows, slot])
        stack_inst[rows, slot] = torch.where(both, inst, s.stack_inst[rows, slot])
        sp = torch.where(both, torch.clamp(sp + 1, max=STACK_DEPTH), sp)
        next_node = torch.where(internal, torch.where(both, near, torch.where(one, only, -1)),
                                node)

        # -- TLAS leaves: descend into the instance
        tlas_leaf = active & is_leaf & in_tlas
        if scene.tlas_prim.shape[0]:
            inst_id = _rows(scene.tlas_prim, left)
        else:
            inst_id = torch.zeros(R, dtype=i32, device=dev)
        new_inst = torch.where(tlas_leaf, inst_id, inst)
        if scene.blas_root.shape[0]:
            root = _rows(scene.blas_root, torch.clamp(new_inst, min=0))
        else:
            root = torch.zeros(R, dtype=i32, device=dev)
        next_node = torch.where(tlas_leaf, root, next_node)

        # -- BLAS leaves: the lanes at one, up to MAX_LEAF triangles each in
        # one batch
        blas_leaf = active & is_leaf & ~in_tlas
        t_best, p_best, i_best, u_best, v_best = s.t, s.prim, s.hit_inst, s.u, s.v
        lane = blas_leaf.nonzero().squeeze(1) if n_tri else blas_leaf[:0]
        if lane.numel():
            acc, prim, t, uu, vv = leaf_lanes(scene, lane, left, count, o, d, s.t, t_lim)
            t_best, p_best, u_best, v_best = (
                put(x, lane, acc, val) for x, val in ((t_best, t), (p_best, prim),
                                                      (u_best, uu), (v_best, vv)))
            i_best = put(i_best, lane, acc, new_inst[lane])
        next_node = torch.where(blas_leaf, -1, next_node)

        if any_hit:
            done = done | (p_best >= 0)
        return _Lane(torch.where(done, -1, next_node).to(i32), new_inst, sp,
                     stack_node, stack_inst, t_best, p_best, i_best, u_best, v_best, done)

    init = _Lane(
        node=torch.zeros(R, dtype=i32, device=dev),  # TLAS root
        inst=torch.full((R,), -1, dtype=i32, device=dev),
        sp=torch.zeros(R, dtype=i32, device=dev),
        stack_node=torch.zeros((R, STACK_DEPTH), dtype=i32, device=dev),
        stack_inst=torch.full((R, STACK_DEPTH), -1, dtype=i32, device=dev),
        t=torch.clamp(t_lim * torch.ones(R, dtype=f32, device=dev), max=T_MAX),
        prim=torch.full((R,), -1, dtype=i32, device=dev),
        hit_inst=torch.full((R,), -1, dtype=i32, device=dev),
        u=torch.zeros(R, dtype=f32, device=dev),
        v=torch.zeros(R, dtype=f32, device=dev),
        done=torch.full((R,), scene.inst_matrix.shape[0] == 0, dtype=torch.bool, device=dev),
    )
    final = run_steps(step, init, lambda s: s.done)
    return Hit(final.t, final.prim, final.hit_inst, final.u, final.v)


def bvh_closest_hit(scene, ray_o: torch.Tensor, ray_d: torch.Tensor, t_limit=T_MAX) -> Hit:
    """Closest-hit query for R rays against the packed two-level scene."""
    return _traversal(scene, ray_o, ray_d, t_limit, any_hit=False)


def bvh_occluded(scene, ray_o: torch.Tensor, ray_d: torch.Tensor, t_limit) -> torch.Tensor:
    """Occlusion query: True where any geometry lies in (T_MIN, t_limit)."""
    return _traversal(scene, ray_o, ray_d, t_limit, any_hit=True).prim >= 0
