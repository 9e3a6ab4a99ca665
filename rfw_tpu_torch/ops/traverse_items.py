"""Two-phase traversal, phase B, and the whole two-phase call.

Counterpart of `rfw_tpu/ops/traverse_items.py`. Bounce rays are incoherent,
so the two-phase path bins them by the BLAS they are about to walk:

  1. phase A: each ray's K nearest TLAS instance entries — the dense
     (R, I) slab scan `render.twophase.dense_tlas_entries` for an instance
     arena of at most DENSE_A_MAX_INST rows, else the tree walk
     `ops.traverse_entries.tlas_entries` (K4);
  2. `compact_entries`: the valid (ray, entry) items into a buffer of
     ceil(R * items_per_ray) slots (no sort: valid entries are a prefix of
     each ray's list); `pack_compact`: a stable sort of that buffer by
     instance, so items of one instance are adjacent, ray-major;
  3. phase B: each item walks its instance's BLAS alone — K3 (closest) or
     K5 (any hit), `items` — or, with RFW_DENSE_ITEMS=1, items whose
     instance mesh spans at most DENSE_MAX_TRIS // TREELET treelets test
     every treelet of it instead — K6, `dense_items`;
  4. per-ray merge by scatter-min (closest) or scatter-max (any hit);
  5. fallback: rays whose K-list was full with the best hit beyond its
     last entry, or whose items did not fit the buffer, are retraced with
     the classic kernel (K1 bounded by the two-phase t; K2 for occlusion),
     at most `fallback_capacity(R)` of them (R // 64 rounded up to a
     multiple of 1024).

K3/K5 and K6 are the hand-written CUDA kernels of
`rfw_tpu_torch/csrc/traverse_items.cu`; `items_plain` and
`dense_items_plain` are their plain torch versions, which the wrappers run
for tensors on the CPU. The glue (compaction, sort, merge, fallback) is
plain torch on either device, as it is jnp outside any Pallas kernel in the
JAX package.

Left out of the port: the TPU's STILE run alignment (a GPU thread carries
its own instance, so the capacity C is ceil(R * items_per_ray) alone), its
VMEM and stream-shape knobs, the tri_hbm tier and the round-2 eager path
(`pallas_twophase_closest_hit`, `_pack_items`).
"""

from __future__ import annotations

import math
import os

import torch

from rfw_tpu_torch.accel.bvh_cpu import TREELET
from rfw_tpu_torch.ops.traverse import (
    PreparedScene, TSHIFT, WalkStats, _leaf_slots, _plain_walk, _rebase, _t_limit,
    check_rays, closest_hit, occluded, plain_stats, ptr, query_shape, stats_buffers,
    stream_of,
)
from rfw_tpu_torch.ops.traverse_entries import tlas_entries
from rfw_tpu_torch.render.intersect import Hit, T_MAX
from rfw_tpu_torch.render.twophase import dense_tlas_entries

#: instance-arena rows up to which phase A is the dense (R, I) scan; above
#: it, the TLAS walk kernel
DENSE_A_MAX_INST = int(os.environ.get("RFW_DENSE_A_MAX", "512"))
#: with RFW_DENSE_ITEMS=1, items whose instance mesh spans at most
#: DENSE_MAX_TRIS // TREELET treelets take the dense items kernel
DENSE_MAX_TRIS = int(os.environ.get("RFW_DENSE_MAX_TRIS", "4096"))
#: the fallback retraces up to R // FALLBACK_FRAC rays, rounded up to a
#: multiple of FALLBACK_ALIGN (at least one): rfw_tpu's buffer size,
#: so every truncated ray of a small front is retraced
FALLBACK_FRAC = 64
FALLBACK_ALIGN = 1024

#: kernel launches per kind; each wrapper adds one where it launches
LAUNCHES = {"items_closest": 0, "items_occluded": 0,
            "dense_closest": 0, "dense_occluded": 0}


# ---------------------------------------------------------------- plain path
def items_plain(ps: PreparedScene, item_inst, ray_o, ray_d, t_limit,
                any_hit: bool, stats=None):
    """Per item, the walk of its instance's BLAS from that BLAS root
    (plain torch, any device): the classic walk entered below the TLAS, in
    the TPU kernels' visit order. Items with instance -1 are empty. Returns
    a Hit (closest) or an occluded mask (any hit); stats as `_plain_walk`'s
    (an empty item counts zero)."""
    return _plain_walk(ps, ray_o, ray_d, t_limit, any_hit,
                       start_inst=item_inst, stats=stats)


def dense_items_plain(ps: PreparedScene, item_inst, ray_o, ray_d, t_limit,
                      any_hit: bool, stats=None):
    """Per item, every treelet of its instance mesh's range [tlo, thi),
    all 64 slots each, in order; a later treelet must be strictly nearer
    (plain torch, any device). stats: "tris" gains the slot tests."""
    dev = ray_o.device
    C = ray_o.shape[0]
    i32 = torch.int32
    t_best = torch.clamp(_t_limit(t_limit, C, dev), max=T_MAX)
    prim = torch.full((C,), -1, dtype=i32, device=dev)
    hit_inst = torch.full((C,), -1, dtype=i32, device=dev)
    hit_u = torch.zeros(C, dtype=torch.float32, device=dev)
    hit_v = torch.zeros(C, dtype=torch.float32, device=dev)
    occ = torch.zeros(C, dtype=torch.bool, device=dev)
    inst = item_inst.to(i32)
    valid = inst >= 0
    iid = torch.clamp(inst, 0, max(ps.n_inst - 1, 0)).long()
    lo = torch.where(valid, ps.tlo[iid], 0)
    span = torch.where(valid, ps.thi[iid] - lo, 0)
    obj = _rebase(ps, inst, ray_o, ray_d)
    full = torch.full((C,), TREELET, dtype=i32, device=dev)
    n_span = int(span.max()) if C else 0
    for j in range(n_span):
        take = j < span
        if any_hit:
            take = take & ~occ
        sel = take.nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        first = (lo[sel] + j) << TSHIFT
        tcur = t_best[sel]
        ok, t, u, v = _leaf_slots(ps.tris, first, full[sel], tuple(x[sel] for x in obj), tcur)
        if stats is not None:
            stats["tris"] = stats.get("tris", 0) + TREELET * int(
                (first + TREELET <= ps.tris.shape[0]).sum())
        if any_hit:
            occ[sel[ok.any(dim=1)]] = True
            continue
        score = torch.where(ok, t, float("inf"))
        win = torch.argmin(score, dim=1)  # lowest slot among ties
        tmin = score.gather(1, win[:, None])[:, 0]
        hit = tmin < tcur
        hs = sel[hit]
        wsel = win[hit, None]
        t_best[hs] = tmin[hit]
        prim[hs] = (first[hit] + win[hit]).to(i32)
        hit_inst[hs] = inst[hs]
        hit_u[hs] = u[hit].gather(1, wsel)[:, 0]
        hit_v[hs] = v[hit].gather(1, wsel)[:, 0]
    if any_hit:
        return occ
    return Hit(t_best, prim, hit_inst, hit_u, hit_v)


# ---------------------------------------------------------------- CUDA path
def launch_shape(any_hit: bool, stats: bool = False, n_items: int = 0, device=None) -> dict:
    """The launch shape of one instance of the K3/K5 kernel (`query_shape`)."""
    return query_shape("traverse_items", "rfw_items_info", any_hit, stats, n_items, device)


def _launch(dense: bool, ps: PreparedScene, item_inst, ray_o, ray_d, t_limit,
            any_hit: bool, stats: bool = False):
    from rfw_tpu_torch.ops._build import load_library

    check_rays(ps, ray_o, ray_d)
    C = ray_o.shape[0]
    dev = ray_o.device
    if (item_inst.dtype != torch.int32 or item_inst.shape != (C,)
            or not item_inst.is_contiguous() or item_inst.device != dev):
        raise ValueError(f"item_inst must be a contiguous ({C},) int32 tensor on {dev}")
    tl = _t_limit(t_limit, C, dev)
    f32 = torch.float32
    if any_hit:
        occ = torch.empty(C, dtype=torch.bool, device=dev)
        t = prim = inst = u = v = None
    else:
        t = torch.empty(C, dtype=f32, device=dev)
        prim = torch.empty(C, dtype=torch.int32, device=dev)
        inst = torch.empty(C, dtype=torch.int32, device=dev)
        u = torch.empty(C, dtype=f32, device=dev)
        v = torch.empty(C, dtype=f32, device=dev)
        occ = None
    out = occ if any_hit else Hit(t, prim, inst, u, v)
    counts = warp_ns = None
    if stats:
        counts, warp_ns = stats_buffers(launch_shape(any_hit, True, C, dev), C, dev)
    if C > 0:
        lib = load_library("traverse_items")
        outs = (ptr(t), ptr(prim), ptr(inst), ptr(u), ptr(v), ptr(occ))
        rays = (ptr(item_inst), ptr(ray_o), ptr(ray_d), ptr(tl), C)
        with torch.cuda.device(dev):
            if dense:
                rc = lib.rfw_dense_items(
                    int(any_hit), ptr(ps.tris), ps.tris.shape[0], ptr(ps.insts), ps.n_inst,
                    ptr(ps.tlo), ptr(ps.thi), *rays, *outs, stream_of(dev))
            else:
                next_item = torch.zeros(1, dtype=torch.int32, device=dev)
                rc = lib.rfw_items(
                    int(any_hit), ptr(ps.nodes), ps.nodes.shape[0], ptr(ps.tris),
                    ps.tris.shape[0], ptr(ps.insts), ps.n_inst, ptr(ps.roots), *rays, *outs,
                    ptr(next_item), ptr(counts), ptr(warp_ns), stream_of(dev))
        kind = f"{'dense' if dense else 'items'}_{'occluded' if any_hit else 'closest'}"
        if rc != 0:
            raise RuntimeError(f"{kind} kernel launch failed: cudaError {rc}")
        LAUNCHES[kind] += 1
    if not stats:
        return out
    return out, WalkStats(*counts.unbind(1), warp_ns=warp_ns)


def items(ps: PreparedScene, item_inst, ray_o, ray_d, t_limit, any_hit: bool,
          stats: bool = False):
    """Per-item single-BLAS walks (K3 closest, K5 any hit): the CUDA kernel
    for tensors on the card, the plain version for tensors on the CPU. With
    `stats`, (result, WalkStats): per item the node visits, box tests, leaf
    visits and slot tests (zero for an empty slot), and on the card each
    launched warp's span."""
    if ray_o.device.type == "cpu":
        if stats:
            return plain_stats(items_plain, ps, item_inst, ray_o, ray_d, t_limit, any_hit)
        return items_plain(ps, item_inst, ray_o, ray_d, t_limit, any_hit)
    return _launch(False, ps, item_inst, ray_o, ray_d, t_limit, any_hit, stats)


def dense_items(ps: PreparedScene, item_inst, ray_o, ray_d, t_limit,
                any_hit: bool):
    """Per-item all-treelet tests of the instance mesh (K6): the CUDA
    kernel for tensors on the card, the plain version for tensors on the
    CPU."""
    if ray_o.device.type == "cpu":
        return dense_items_plain(ps, item_inst, ray_o, ray_d, t_limit, any_hit)
    return _launch(True, ps, item_inst, ray_o, ray_d, t_limit, any_hit)


# ---------------------------------------------------------------- glue
def compact_entries(ents_inst, compact_cap: int):
    """The valid (ray, entry) items of an (R,K) entry table, ray-major,
    in a buffer of `compact_cap` slots. Valid entries form a prefix of each
    ray's list, so item (r,k) lands at exclusive_cumsum(counts)[r] + k.
    Returns (citem (compact_cap,) i32: item index r*K+k or -1,
    ray_overflow (R,) bool: the ray had a valid item dropped)."""
    R, K = ents_inst.shape
    dev = ents_inst.device
    valid = ents_inst >= 0
    cnt = valid.sum(dim=1)
    offs = torch.cumsum(cnt, 0) - cnt  # exclusive
    dest = offs[:, None] + torch.arange(K, device=dev)[None]
    ray_overflow = (valid & (dest >= compact_cap)).any(dim=1)
    dest = torch.where(valid & (dest < compact_cap), dest, compact_cap)
    item_idx = torch.arange(R * K, dtype=torch.int32, device=dev)
    citem = torch.full((compact_cap + 1,), -1, dtype=torch.int32, device=dev)
    keep = dest.reshape(-1) < compact_cap
    citem[dest.reshape(-1)[keep]] = item_idx[keep]
    return citem[:compact_cap], ray_overflow


def pack_compact(citem, inst_flat, n_inst: int):
    """Stable sort of the compact item buffer by instance: items of one
    instance become adjacent and stay ray-major inside the run; empty
    slots go last. Returns (slot_item (C,) i32 item index or -1,
    slot_inst (C,) i32 instance or -1)."""
    ckey = torch.where(citem >= 0, inst_flat[torch.clamp(citem, min=0).long()],
                       n_inst).to(torch.int32)
    skey, order = torch.sort(ckey, stable=True)
    slot_item = citem[order]
    return slot_item, torch.where(slot_item >= 0, skey, -1).to(torch.int32)


def _phase_a(ps: PreparedScene, ray_o, ray_d, tl_ray, K: int):
    if ps.inst_min.shape[0] <= DENSE_A_MAX_INST:
        return dense_tlas_entries(ps.inst_min, ps.inst_max, ray_o, ray_d, tl_ray, K=K)
    return tlas_entries(ps, ray_o, ray_d, tl_ray, K=K)


def _dense_on(dense) -> bool:
    if dense is None:
        return os.environ.get("RFW_DENSE_ITEMS", "0") == "1"
    return bool(dense)


def _phase_b(ps: PreparedScene, slot_inst, o_s, d_s, tl_s, any_hit: bool,
             dense: bool):
    """Phase B over the packed slots: K3/K5 for every item, or with the
    dense tier the items split by their mesh's treelet span between K6
    and K3/K5, each kernel seeing the other's items as empty."""
    if not dense:
        return items(ps, slot_inst, o_s, d_s, tl_s, any_hit)
    iid = torch.clamp(slot_inst, 0, max(ps.n_inst - 1, 0)).long()
    nt = ps.thi[iid] - ps.tlo[iid]
    dense_k = (slot_inst >= 0) & (nt > 0) & (nt <= DENSE_MAX_TRIS // TREELET)
    none = torch.full_like(slot_inst, -1)
    walk = items(ps, torch.where(dense_k, none, slot_inst).contiguous(),
                 o_s, d_s, tl_s, any_hit)
    dn = dense_items(ps, torch.where(dense_k, slot_inst, none).contiguous(),
                     o_s, d_s, tl_s, any_hit)
    if any_hit:
        return torch.where(dense_k, dn, walk)
    return Hit(*[torch.where(dense_k, a, b) for a, b in zip(dn, walk)])


def _pack(ps: PreparedScene, ray_o, ray_d, tl_ray, K: int, items_per_ray: float):
    """Phase A, compaction and the instance sort: (entries, ray_overflow,
    slot_item, slot_inst, per-slot world rays o_s, d_s, t_limit tl_s with
    -inf for empty slots)."""
    R = ray_o.shape[0]
    ents = _phase_a(ps, ray_o, ray_d, tl_ray, K)
    cap = math.ceil(R * items_per_ray)
    citem, ray_ovf = compact_entries(ents.inst, cap)
    slot_item, slot_inst = pack_compact(citem, ents.inst.reshape(-1), ps.n_inst)
    ray_id = (torch.clamp(slot_item, min=0) // K).long()
    od = torch.cat([ray_o, ray_d, tl_ray[:, None]], dim=1)[ray_id]  # one gather
    tl_s = torch.where(slot_item >= 0, od[:, 6], float("-inf")).contiguous()
    return (ents, ray_ovf, slot_item, slot_inst, od[:, 0:3].contiguous(),
            od[:, 3:6].contiguous(), tl_s)


def _merge_closest(slot_item, hs: Hit, tl_ray, K: int) -> Hit:
    """Per-ray merge of the slots' hits by scatter-min: the nearest hit,
    the lowest slot on a tie; a ray with no hit gets t = its t_limit."""
    R = tl_ray.shape[0]
    C = slot_item.shape[0]
    dev = tl_ray.device
    hit_ok = (slot_item >= 0) & (hs.prim >= 0)
    rid = torch.where(hit_ok, slot_item // K, R).long()
    inf = float("inf")
    tmin = torch.full((R + 1,), inf, dtype=torch.float32, device=dev).scatter_reduce(
        0, rid, torch.where(hit_ok, hs.t, inf), "amin")
    is_win = hit_ok & (hs.t == tmin[rid])
    slot_iota = torch.arange(C, device=dev)
    win_slot = torch.full((R + 1,), C, dtype=torch.int64, device=dev).scatter_reduce(
        0, rid, torch.where(is_win, slot_iota, C), "amin")[:R]
    has = win_slot < C
    ws = torch.clamp(win_slot, max=C - 1)
    return Hit(
        torch.where(has, hs.t[ws], tl_ray),
        torch.where(has, hs.prim[ws], -1),
        torch.where(has, hs.inst[ws], -1),
        torch.where(has, hs.u[ws], 0.0),
        torch.where(has, hs.v[ws], 0.0),
    )


def twophase_closest_fused(ps: PreparedScene, ray_o, ray_d, t_limit=T_MAX,
                           K: int = 8, items_per_ray: float = 1.5,
                           dense: bool | None = None):
    """Two-phase closest hit without the fallback: phase A, pack, phase B,
    scatter-min merge. Per-ray t_limit; dead lanes (t_limit 0) make no
    items. Returns (Hit, truncated): a truncated ray (full K-list with the
    best hit beyond its last entry, or an item dropped from the buffer)
    may have missed a nearer hit in an instance it did not keep. A ray
    with no hit gets t = its t_limit."""
    R = ray_o.shape[0]
    dev = ray_o.device
    tl_ray = _t_limit(t_limit, R, dev)
    ents, ray_ovf, slot_item, slot_inst, o_s, d_s, tl_s = _pack(
        ps, ray_o, ray_d, tl_ray, K, items_per_ray)
    hs = _phase_b(ps, slot_inst, o_s, d_s, tl_s, False, _dense_on(dense))
    hit = _merge_closest(slot_item, hs, tl_ray, K)
    full = ents.inst[:, K - 1] >= 0
    truncated = (full & (hit.t > ents.t_entry[:, K - 1])) | ray_ovf
    return hit, truncated


def fallback_capacity(R: int) -> int:
    """How many truncated rays the fallback retraces at most."""
    return max(1, -(-(R // FALLBACK_FRAC) // FALLBACK_ALIGN)) * FALLBACK_ALIGN


def _fallback_rows(mask):
    """Indices of the first fallback_capacity(R) set rows."""
    return mask.nonzero().squeeze(1)[:fallback_capacity(mask.shape[0])]


def twophase_closest_with_fallback(ps: PreparedScene, ray_o, ray_d,
                                   t_limit=T_MAX, K: int = 8,
                                   items_per_ray: float = 1.5,
                                   dense: bool | None = None) -> Hit:
    """Two-phase closest hit with the exact-result contract: truncated
    rays are retraced through the classic kernel, bounded by their
    two-phase t (an upper bound on the true t: a dropped instance can only
    hold a nearer hit), so a retrace miss means the two-phase hit stands.
    Rays beyond the fallback's capacity keep their two-phase hit, the
    nearest among their K nearest instances."""
    hit, trunc = twophase_closest_fused(ps, ray_o, ray_d, t_limit, K=K,
                                        items_per_ray=items_per_ray, dense=dense)
    idx = _fallback_rows(trunc)
    if idx.numel() == 0:
        return hit
    tl_f = hit.t[idx] * (1.0 + 1e-4) + 1e-5
    fhit = closest_hit(ps, ray_o[idx].contiguous(), ray_d[idx].contiguous(), tl_f)
    improved = fhit.prim >= 0

    def put(base, val):
        out = base.clone()
        out[idx] = torch.where(improved, val, base[idx])
        return out

    return Hit(*[put(b, f) for b, f in zip(hit, fhit)])


def twophase_occluded_fused(ps: PreparedScene, ray_o, ray_d, t_limit,
                            K: int = 8, items_per_ray: float = 1.5,
                            dense: bool | None = None):
    """Two-phase any hit: phase A, pack, K5 (and K6) items, scatter-max
    merge. Returns (occluded (R,) bool, undecided (R,) bool): an undecided
    ray is not occluded by its kept instances but had a full list or a
    dropped item, so an instance it did not keep could still occlude it."""
    R = ray_o.shape[0]
    dev = ray_o.device
    tl_ray = _t_limit(t_limit, R, dev)
    ents, ray_ovf, slot_item, slot_inst, o_s, d_s, tl_s = _pack(
        ps, ray_o, ray_d, tl_ray, K, items_per_ray)
    occ_s = _phase_b(ps, slot_inst, o_s, d_s, tl_s, True, _dense_on(dense))
    hit_ok = (slot_item >= 0) & occ_s
    rid = torch.where(hit_ok, slot_item // K, R).long()
    occ = torch.zeros(R + 1, dtype=torch.int32, device=dev).scatter_reduce(
        0, rid, hit_ok.to(torch.int32), "amax")[:R] > 0
    full = ents.inst[:, K - 1] >= 0
    return occ, (full | ray_ovf) & ~occ


def twophase_occluded_with_fallback(ps: PreparedScene, ray_o, ray_d, t_limit,
                                    K: int = 8, items_per_ray: float = 1.5,
                                    dense: bool | None = None) -> torch.Tensor:
    """Two-phase occlusion with the exact-result contract: undecided rays
    are retraced with the classic any-hit kernel. Undecided rays beyond
    the fallback's capacity stay unoccluded."""
    R = ray_o.shape[0]
    tl_ray = _t_limit(t_limit, R, ray_o.device)
    occ, undecided = twophase_occluded_fused(ps, ray_o, ray_d, tl_ray, K=K,
                                             items_per_ray=items_per_ray,
                                             dense=dense)
    idx = _fallback_rows(undecided)
    if idx.numel() == 0:
        return occ
    focc = occluded(ps, ray_o[idx].contiguous(), ray_d[idx].contiguous(), tl_ray[idx])
    out = occ.clone()
    out[idx] = occ[idx] | focc
    return out
