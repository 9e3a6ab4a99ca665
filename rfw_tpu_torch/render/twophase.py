"""Two-phase traversal: phase A (each ray's K nearest TLAS instance
entries) and the plain reference of the whole two-phase closest hit.

Counterpart of `rfw_tpu/render/twophase.py`. Phase A tells each bounce ray
which instances it enters, nearest first; phase B walks each (ray,
instance) item in that instance's BLAS alone. In the render path
(`ops.traverse_items`) phase A is the dense (R, I) slab scan here for an
instance arena of at most `ops.traverse_items.DENSE_A_MAX_INST` rows, and
above it the tree walk of `ops.traverse_entries` (K4).

The reference path, plain torch on any device and the oracle of the
kernels' two-phase calls: `tlas_entries` walks the binary wide TLAS
(`tlas_wide_f`/`tlas_wide_i`) per ray with a stack of STACK_DEPTH and a
branchless sorted insert into a K-list; `_blas_walk_items` walks one
instance's binary wide BLAS per item (leaves decoded as in
`render.packet`); `twophase_closest_hit` chains them with a per-ray min-t
merge and marks the rays a full K-list may have cut short. Their
arithmetic rounds as the JAX package's does on the CPU (the FMA chains of
`render.intersect`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rfw_tpu_torch.accel.bvh_cpu import TREELET
from rfw_tpu_torch.accel.tlas_device import fma_matvec
from rfw_tpu_torch.render.intersect import (
    Hit, T_MAX, T_MIN, leaf_lanes, limit_of, put, run_steps, safe_inv, slab,
)

#: walk stack depth: the TLAS over I instances is ~2*log2(I) deep with SAH
#: splits; 48 covers far beyond 10k instances
STACK_DEPTH = 48
#: step cap of the walks (a malformed tree gives a wrong but finite result)
MAX_ITERS = 1 << 14

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
    t_lim = limit_of(t_limit, R, dev)
    ts = torch.full((R, K), float("inf"), dtype=torch.float32, device=dev)
    ins = torch.full((R, K), -1, dtype=torch.int32, device=dev)
    k = min(K, I)
    if R == 0 or k == 0:
        return TlasEntries(ts, ins)
    valid_box = torch.all(inst_min <= inst_max, dim=1)  # (I,)
    inv_d = safe_inv(ray_d)
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


# ------------------------------------------------------- reference path
def _hit_box(o, inv_d, box, t_best):
    """`slab` vs (R,6) [min3|max3] boxes, with the inverted (empty) boxes,
    which would slab as a hit, gated out. Returns (hit, tnear), hit with
    tnear < t_best."""
    hit, tn = slab(o, inv_d, box[:, 0:3], box[:, 3:6])
    valid = (box[:, 0:3] <= box[:, 3:6]).all(dim=-1)
    return valid & hit & (tn < t_best), tn


def _entry_t(o, inv_d, box, t_limit):
    """Clamped entry t of rays vs (R,6) boxes; +inf on a miss. The clamped
    t is compared with the limit, so a lane with t_limit 0 enters nothing."""
    hit, tn = _hit_box(o, inv_d, box, float("inf"))
    te = torch.clamp(tn, min=0.0)
    return torch.where(hit & (te < t_limit), te, float("inf"))


class _Walk(NamedTuple):
    node: torch.Tensor
    sp: torch.Tensor
    stack: torch.Tensor
    done: torch.Tensor
    a: tuple  # the walk's per-lane results


def _pop(st: _Walk, rows):
    """Lanes at node -1 pop their stack or finish. Returns (node, sp, done)."""
    need = (st.node == -1) & ~st.done
    can_pop = need & (st.sp > 0)
    sp = torch.where(can_pop, st.sp - 1, st.sp)
    node = torch.where(can_pop, st.stack[rows, torch.clamp(sp, min=0).long()], st.node)
    return node, sp, st.done | (need & (st.sp == 0))


def _push(st: _Walk, rows, sp, push, value):
    slot = torch.clamp(sp, max=STACK_DEPTH - 1).long()
    stack = st.stack.clone()
    stack[rows, slot] = torch.where(push, value, st.stack[rows, slot])
    return stack, torch.where(push, torch.clamp(sp + 1, max=STACK_DEPTH), sp)


def tlas_entries(tlas_wide_f, tlas_wide_i, ray_o, ray_d, t_limit=T_MAX,
                 K: int = 8) -> TlasEntries:
    """Per ray, the K nearest TLAS leaf (instance) entries, sorted by slab
    entry t, by a per-ray walk of the binary wide TLAS (its root is row 0).
    A ray entering more than K instance boxes keeps the K nearest, so a
    FULL list may have dropped an instance holding a nearer hit."""
    R = ray_o.shape[0]
    dev = ray_o.device
    i32 = torch.int32
    rows = torch.arange(R, device=dev)
    t_lim = limit_of(t_limit, R, dev)
    inv_d = safe_inv(ray_d)

    def insert(ts, ins, tn, iid, do):
        """Branchless sorted insert of (tn, iid) where `do`, keeping the K
        smallest: a displaced entry bubbles to the later slots."""
        tn = torch.where(do, tn, float("inf"))
        iid = torch.where(do, iid, -1)
        ts, ins = ts.clone(), ins.clone()
        for j in range(K):
            take = tn < ts[:, j]
            old_t, old_i = ts[:, j].clone(), ins[:, j].clone()
            ts[:, j] = torch.where(take, tn, old_t)
            ins[:, j] = torch.where(take, iid, old_i)
            tn = torch.where(take, old_t, tn)
            iid = torch.where(take, old_i, iid)
        return ts, ins

    def step(st: _Walk) -> _Walk:
        node, sp, done = _pop(st, rows)
        active = ~done & (node >= 0)
        n = torch.clamp(node, min=0).long()
        wf, wi = tlas_wide_f[n], tlas_wide_i[n]
        tl = _entry_t(ray_o, inv_d, wf[:, 0:6], t_lim)
        tr = _entry_t(ray_o, inv_d, wf[:, 6:12], t_lim)
        l_code, r_code = wi[:, 0], wi[:, 1]

        # leaf children record entries
        ts, ins = st.a
        ts, ins = insert(ts, ins, tl, -l_code - 1, active & (l_code < 0) & torch.isfinite(tl))
        ts, ins = insert(ts, ins, tr, -r_code - 1, active & (r_code < 0) & torch.isfinite(tr))

        # internal children continue the walk: the near one descends, the
        # far one is pushed
        l_int = active & (l_code >= 0) & torch.isfinite(tl)
        r_int = active & (r_code >= 0) & torch.isfinite(tr)
        both = l_int & r_int
        l_near = tl <= tr
        first = torch.where(both, torch.where(l_near, l_code, r_code),
                            torch.where(l_int, l_code, r_code))
        second = torch.where(l_near, r_code, l_code)
        stack, sp = _push(st, rows, sp, both, second)
        nxt = torch.where(l_int | r_int, first, -1)
        node = torch.where(active, nxt, torch.where(done, node, -1))
        return _Walk(node.to(i32), sp, stack, done, (ts, ins))

    init = _Walk(
        node=torch.zeros(R, dtype=i32, device=dev),  # the wide TLAS root is row 0
        sp=torch.zeros(R, dtype=i32, device=dev),
        stack=torch.zeros((R, STACK_DEPTH), dtype=i32, device=dev),
        done=torch.zeros(R, dtype=torch.bool, device=dev),
        a=(torch.full((R, K), float("inf"), dtype=torch.float32, device=dev),
           torch.full((R, K), -1, dtype=i32, device=dev)),
    )
    out = run_steps(step, init, lambda s: s.done, MAX_ITERS)
    return TlasEntries(*out.a)


def _blas_walk_items(scene, o_obj, d_obj, roots, valid, t_limit):
    """Per item (an object-space ray and the wide BLAS root of its
    instance), the walk of that one BLAS: the plain reference of phase B.
    Internal slots test both children's boxes (the right one pushed when
    both hit); a leaf child is decoded as in `render.packet` (pack aligns
    leaf firsts to TREELET, so the count rides in the low bits) and the
    items at a leaf test its triangles in one batch. Items with valid False make
    nothing. Returns per item (t, prim, u, v); t stays t_limit on a miss."""
    tshift = TREELET.bit_length() - 1
    N = o_obj.shape[0]
    dev = o_obj.device
    i32 = torch.int32
    rows = torch.arange(N, device=dev)
    wf, wi = scene.blas_wide_f, scene.blas_wide_i
    n_tri = scene.tri_v0.shape[0]
    inv_d = safe_inv(d_obj)
    t_lim = limit_of(t_limit, N, dev)
    no_lim = torch.full((N,), float("inf"), dtype=torch.float32, device=dev)

    def enc(code, cnt):
        first = -code - 1
        leaf = -(first + torch.clamp(cnt - 1, max=TREELET - 1)) - 2
        return torch.where(code >= 0, code, leaf)

    def step(st: _Walk) -> _Walk:
        node, sp, done = _pop(st, rows)
        active = ~done & (node != -1)
        t_best, prim, uu, vv = st.a

        # internal: test both children
        is_int = active & (node >= 0)
        n = torch.clamp(node, min=0).long()
        f, w = wf[n], wi[n]
        lh = is_int & _hit_box(o_obj, inv_d, f[:, 0:6], t_best)[0]
        rh = is_int & _hit_box(o_obj, inv_d, f[:, 6:12], t_best)[0]
        le, re_ = enc(w[:, 0], w[:, 2]), enc(w[:, 1], w[:, 3])
        nxt = torch.where(lh, le, torch.where(rh, re_, -1))
        stack, sp = _push(st, rows, sp, lh & rh, re_)

        # leaf (node <= -2): the items at one test its triangles
        is_leaf = active & (node <= -2)
        lane = is_leaf.nonzero().squeeze(1) if n_tri else is_leaf[:0]
        if lane.numel():
            lv = torch.clamp(-node - 2, min=0)
            first = (lv >> tshift) << tshift
            count = (lv & (TREELET - 1)) + 1
            acc, p, tq, uq, vq = leaf_lanes(scene, lane, first, count, o_obj, d_obj,
                                            t_best, no_lim)
            t_best, prim, uu, vv = (put(x, lane, acc, val) for x, val in (
                (t_best, tq), (prim, p), (uu, uq), (vv, vq)))

        node = torch.where(is_int, nxt, torch.where(active, -1, node))
        return _Walk(node.to(i32), sp, stack, done, (t_best, prim, uu, vv))

    init = _Walk(
        node=torch.where(valid, roots, -1).to(i32),
        sp=torch.zeros(N, dtype=i32, device=dev),
        stack=torch.zeros((N, STACK_DEPTH), dtype=i32, device=dev),
        done=~valid,
        a=(t_lim.clone(), torch.full((N,), -1, dtype=i32, device=dev),
           torch.zeros(N, dtype=torch.float32, device=dev),
           torch.zeros(N, dtype=torch.float32, device=dev)),
    )
    return run_steps(step, init, lambda s: s.done, MAX_ITERS).a


def twophase_closest_hit(scene, ray_o, ray_d, t_limit=T_MAX, K: int = 8):
    """The reference two-phase closest hit on a TraceScene of tensors:
    phase A (`tlas_entries`) -> R*K (ray, entry) items re-based into
    their instances' object space -> per-item BLAS walks -> per-ray min-t
    merge (the first of equal t in entry order). `t_limit` is one number
    for every ray. Returns (Hit, truncated): a ray whose K-list is full
    and whose best hit lies beyond the last kept entry may have missed a
    nearer hit in an instance it dropped; a caller retraces such rays."""
    R = ray_o.shape[0]
    ents = tlas_entries(scene.tlas_wide_f, scene.tlas_wide_i, ray_o, ray_d, t_limit, K=K)

    # expand to items (R*K): object-space rays per entry instance
    inst = ents.inst.reshape(-1)
    valid = inst >= 0
    iid = torch.clamp(inst, min=0).long()
    inv = scene.inst_inv[iid][:, :3, :]  # (N,3,4)
    o_rep = ray_o.repeat_interleave(K, dim=0)
    d_rep = ray_d.repeat_interleave(K, dim=0)
    o_obj = fma_matvec(inv[:, :, :3], o_rep) + inv[:, :, 3]
    d_obj = fma_matvec(inv[:, :, :3], d_rep)
    roots = scene.blas_wide_root[iid]

    t, prim, u, v = (x.reshape(R, K) for x in _blas_walk_items(
        scene, o_obj, d_obj, roots, valid, t_limit))
    j = torch.argmin(t, dim=1, keepdim=True)
    pick = lambda x: x.gather(1, j).squeeze(1)  # noqa: E731
    prim_sel = pick(prim)
    hit = Hit(pick(t), prim_sel, torch.where(prim_sel >= 0, pick(ents.inst), -1),
              pick(u), pick(v))
    full = ents.inst[:, K - 1] >= 0
    truncated = full & (hit.t > ents.t_entry[:, K - 1])
    return hit, truncated
