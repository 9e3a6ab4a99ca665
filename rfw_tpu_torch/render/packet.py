"""Packet BVH traversal (`traversal="packet"`): counterpart of
`rfw_tpu/render/packet.py`, in torch on the device of the tensors.

Rays are grouped into TILES of `lanes` rays; each tile shares ONE stack of
STACK_DEPTH (node code, instance) entries and visits ONE node per step,
over the unified binary wide arena (BLAS wide nodes, then the TLAS ones):

  * an internal node's two child boxes are slab-tested against every lane
    of the tile; a child is entered when any lane hits it, the nearer one
    (by the smallest entry t over the tile's lanes) first, the other pushed;
  * entering a TLAS leaf re-bases the tile's rays into the instance's
    object space with one 3x4 row;
  * a BLAS leaf is an encoded code: its TREELET-aligned first triangle and
    count are tested against every lane, in one batch (the nearest accepted
    triangle wins, the lowest slot on an exact-t tie, as the reference's
    triangle-by-triangle loop keeps).

Node-code encoding inside the loop (int32 per tile):
    code >= 0   internal node in the unified wide arena (BLAS ++ TLAS)
    code == -1  "pop"
    code <= -2  BLAS triangle leaf: v = -code-2; first = v with the low
                log2(TREELET) bits cleared (leaf ranges are TREELET-aligned
                in the packed arena), count = (v & (TREELET-1)) + 1

The arithmetic rounds as the reference's does on the CPU (the FMA chains
of `render.intersect`), and the loop reads "every tile done" on the host
once every `intersect.CHECK_EVERY` steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rfw_tpu_torch.accel.bvh_cpu import TREELET
from rfw_tpu_torch.accel.tlas_device import fma_matvec
from rfw_tpu_torch.render.intersect import (
    Hit, T_MAX, leaf_hits, run_steps, safe_inv, slab,
)

DEFAULT_LANES = 512
STACK_DEPTH = 96
_TSHIFT = TREELET.bit_length() - 1


class PacketScene(NamedTuple):
    """Arrays prepared once per TraceScene (prepare_packet_scene)."""

    wide_f: torch.Tensor  # (N,12) unified wide arena: [BLAS ++ TLAS]
    wide_i: torch.Tensor  # (N,4)
    tlas_root: int
    blas_wide_root: torch.Tensor  # (I,)
    inst_inv12: torch.Tensor  # (I,12) world->object, rows 0..2 of the 4x4
    tri9: torch.Tensor  # (Tri,9) [v0,e1,e2]
    n_tri: int
    n_inst: int


def prepare_packet_scene(scene) -> PacketScene:
    """Build the packet-traversal arrays from a TraceScene of tensors."""
    nb = scene.blas_wide_f.shape[0]
    dev = scene.blas_wide_f.device
    # rebase TLAS internal child codes into the unified arena
    tlas_i = scene.tlas_wide_i
    codes = torch.where(tlas_i[:, :2] >= 0, tlas_i[:, :2] + nb, tlas_i[:, :2])
    tlas_i = torch.cat([codes, tlas_i[:, 2:]], dim=1)
    n_inst = scene.inst_inv.shape[0]
    return PacketScene(
        wide_f=torch.cat([scene.blas_wide_f, scene.tlas_wide_f]),
        wide_i=torch.cat([scene.blas_wide_i, tlas_i]),
        tlas_root=nb,
        blas_wide_root=(scene.blas_wide_root if scene.blas_wide_root.shape[0]
                        else torch.zeros(1, dtype=torch.int32, device=dev)),
        inst_inv12=(scene.inst_inv[:, :3, :].reshape(-1, 12) if n_inst
                    else torch.zeros((1, 12), dtype=torch.float32, device=dev)),
        tri9=(torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2], dim=1)
              if scene.tri_v0.shape[0]
              else torch.zeros((1, 9), dtype=torch.float32, device=dev)),
        n_tri=int(scene.tri_v0.shape[0]),
        n_inst=int(scene.inst_matrix.shape[0]),
    )


class _State(NamedTuple):
    node: torch.Tensor  # (T,) current code
    inst: torch.Tensor  # (T,)
    sp: torch.Tensor  # (T,)
    stack: torch.Tensor  # (T,D,2)
    t: torch.Tensor  # (T,L)
    prim: torch.Tensor  # (T,L)
    hit_inst: torch.Tensor  # (T,L)
    u: torch.Tensor
    v: torch.Tensor
    done: torch.Tensor  # (T,)


def _traverse(ps: PacketScene, ray_o, ray_d, t_limit, any_hit: bool) -> Hit:
    """ray_o/d: (T,L,3). t_limit: scalar or (T,L). Returns per-lane Hit."""
    T, L = ray_o.shape[:2]
    dev = ray_o.device
    f32, i32 = torch.float32, torch.int32
    tiles = torch.arange(T, device=dev)
    slots = torch.arange(TREELET, device=dev)

    if ps.n_inst == 0:
        z = torch.zeros((T, L), dtype=f32, device=dev)
        miss = torch.full((T, L), -1, dtype=i32, device=dev)
        return Hit(torch.full((T, L), T_MAX, dtype=f32, device=dev), miss, miss.clone(), z,
                   z.clone())

    t_lim = torch.as_tensor(t_limit, dtype=f32, device=dev).expand(T, L)
    n_root = ps.blas_wide_root.shape[0]

    def step(st: _State) -> _State:
        # ---------- pop ----------
        need = (st.node == -1) & ~st.done
        can_pop = need & (st.sp > 0)
        sp = torch.where(can_pop, st.sp - 1, st.sp)
        popped = st.stack[tiles, torch.clamp(sp, min=0).long()]  # (T,2)
        node = torch.where(can_pop, popped[:, 0], st.node)
        inst = torch.where(can_pop, popped[:, 1], st.inst)
        done = st.done | (need & (st.sp == 0))
        active = ~done & (node != -1)

        # ---------- per-tile object-space rays ----------
        in_tlas = inst < 0
        m = ps.inst_inv12[torch.clamp(inst, min=0).long()].reshape(T, 1, 3, 4)
        o_obj = fma_matvec(m[..., :3], ray_o) + m[..., 3]
        d_obj = fma_matvec(m[..., :3], ray_d)
        o = torch.where(in_tlas[:, None, None], ray_o, o_obj)
        d = torch.where(in_tlas[:, None, None], ray_d, d_obj)
        inv_d = safe_inv(d)

        t_best, prim, hinst, uu, vv = st.t, st.prim, st.hit_inst, st.u, st.v

        # ---------- triangle-leaf phase ----------
        is_leaf = active & (node <= -2)
        lv = torch.clamp(-node - 2, min=0)
        first = (lv >> _TSHIFT) << _TSHIFT
        count = torch.where(is_leaf, (lv & (TREELET - 1)) + 1, 0)
        tri = torch.clamp(first[:, None] + slots, max=max(ps.n_tri - 1, 0))  # (T,TREELET)
        row = ps.tri9[tri.long()][:, None]  # (T,1,TREELET,9)
        valid = (is_leaf[:, None] & (slots < count[:, None]))[:, None, :]
        acc, k, tq, uq, vq = leaf_hits(o, d, row[..., 0:3], row[..., 3:6], row[..., 6:9],
                                       valid, t_best, t_lim)
        t_best = torch.where(acc, tq, t_best)
        prim = torch.where(acc, tri.gather(1, k).to(i32), prim)
        hinst = torch.where(acc, inst[:, None], hinst)
        uu = torch.where(acc, uq, uu)
        vv = torch.where(acc, vq, vv)

        # ---------- internal phase ----------
        is_int = active & (node >= 0)
        nsafe = torch.clamp(node, min=0).long()
        wf = ps.wide_f[nsafe]  # (T,12)
        wi = ps.wide_i[nsafe]  # (T,4)
        lhit, lt = slab(o, inv_d, wf[:, None, 0:3], wf[:, None, 3:6])
        rhit, rt = slab(o, inv_d, wf[:, None, 6:9], wf[:, None, 9:12])
        lhit, rhit = lhit & (lt < t_best), rhit & (rt < t_best)
        if any_hit:
            live = prim < 0
            lhit = lhit & live
            rhit = rhit & live
        l_any = lhit.any(dim=-1) & is_int
        r_any = rhit.any(dim=-1) & is_int
        inf = float("inf")
        lt_tile = torch.where(lhit, lt, inf).amin(dim=-1)
        rt_tile = torch.where(rhit, rt, inf).amin(dim=-1)

        def child_entry(code, cnt):
            """(entry code, entry instance) of a child: a TLAS leaf enters
            its instance's BLAS wide root, a BLAS leaf becomes a triangle
            leaf code."""
            c_leaf = code < 0
            payload = -code - 1
            iid = torch.clamp(payload, 0, max(min(ps.n_inst, n_root) - 1, 0))
            tlas_entry = ps.blas_wide_root[iid.long()]
            blas_entry = -(payload + torch.clamp(cnt - 1, max=TREELET - 1)) - 2
            e_code = torch.where(c_leaf, torch.where(in_tlas, tlas_entry, blas_entry), code)
            e_inst = torch.where(c_leaf & in_tlas, payload, inst)
            return e_code, e_inst

        l_code, l_inst = child_entry(wi[:, 0], wi[:, 2])
        r_code, r_inst = child_entry(wi[:, 1], wi[:, 3])

        both = l_any & r_any
        near_is_l = lt_tile <= rt_tile
        near_code = torch.where(near_is_l, l_code, r_code)
        near_inst = torch.where(near_is_l, l_inst, r_inst)
        far_code = torch.where(near_is_l, r_code, l_code)
        far_inst = torch.where(near_is_l, r_inst, l_inst)
        one = l_any ^ r_any
        one_code = torch.where(l_any, l_code, r_code)
        one_inst = torch.where(l_any, l_inst, r_inst)

        # push far where both
        slot = torch.clamp(sp, max=STACK_DEPTH - 1).long()
        entry = torch.stack([far_code, far_inst], dim=-1)
        stack = st.stack.clone()
        stack[tiles, slot] = torch.where(both[:, None], entry, st.stack[tiles, slot])
        sp = torch.where(both, torch.clamp(sp + 1, max=STACK_DEPTH), sp)

        next_code = torch.where(
            is_int, torch.where(both, near_code, torch.where(one, one_code, -1)),
            torch.where(is_leaf, -1, node))
        next_inst = torch.where(
            is_int, torch.where(both, near_inst, torch.where(one, one_inst, inst)), inst)

        if any_hit:
            done = done | (prim >= 0).all(dim=-1)

        return _State(torch.where(done, -1, next_code).to(i32), next_inst.to(i32), sp, stack,
                      t_best, prim, hinst, uu, vv, done)

    init = _State(
        node=torch.full((T,), ps.tlas_root, dtype=i32, device=dev),
        inst=torch.full((T,), -1, dtype=i32, device=dev),
        sp=torch.zeros(T, dtype=i32, device=dev),
        stack=torch.zeros((T, STACK_DEPTH, 2), dtype=i32, device=dev),
        t=torch.clamp(t_lim, max=T_MAX).clone(),
        prim=torch.full((T, L), -1, dtype=i32, device=dev),
        hit_inst=torch.full((T, L), -1, dtype=i32, device=dev),
        u=torch.zeros((T, L), dtype=f32, device=dev),
        v=torch.zeros((T, L), dtype=f32, device=dev),
        done=torch.zeros(T, dtype=torch.bool, device=dev),
    )
    final = run_steps(step, init, lambda s: s.done)
    return Hit(final.t, final.prim, final.hit_inst, final.u, final.v)


def _tiles(ray_o, ray_d, t_limit, lanes: int):
    R = ray_o.shape[0]
    T = max(1, R // lanes)
    assert T * lanes == R, f"ray count {R} not divisible by lanes {lanes}"
    tl = t_limit
    if isinstance(t_limit, torch.Tensor) and t_limit.ndim == 1:
        tl = t_limit.reshape(T, lanes)
    return ray_o.reshape(T, lanes, 3), ray_d.reshape(T, lanes, 3), tl


def packet_closest_hit(ps: PacketScene, ray_o, ray_d, t_limit=T_MAX,
                       lanes: int = DEFAULT_LANES) -> Hit:
    """Closest hit for (R,3) rays via tiled packets; returns flat (R,) Hit."""
    R = ray_o.shape[0]
    h = _traverse(ps, *_tiles(ray_o, ray_d, t_limit, lanes), any_hit=False)
    return Hit(*[x.reshape(R) for x in h])


def packet_occluded(ps: PacketScene, ray_o, ray_d, t_limit,
                    lanes: int = DEFAULT_LANES) -> torch.Tensor:
    """Occlusion for (R,3) rays via tiled packets: True where any geometry
    lies in (T_MIN, t_limit)."""
    R = ray_o.shape[0]
    h = _traverse(ps, *_tiles(ray_o, ray_d, t_limit, lanes), any_hit=True)
    return (h.prim >= 0).reshape(R)
