"""Two-phase traversal, phase A by tree: the CUDA kernel's wrapper and its
plain version.

Counterpart of `rfw_tpu/ops/traverse_entries.py`. The TPU kernel
`_entries_kernel_factory` (K4) becomes the hand-written CUDA kernel in
`rfw_tpu_torch/csrc/traverse_entries.cu`. Beside it, in this module:

  * `tlas_entries` — counterpart of `pallas_tlas_entries`: for tensors on
    the card it launches the kernel (or raises); for tensors on the CPU it
    runs the plain version. With `stats=True` it also returns the walk's
    per-ray node visits and box tests (`WalkStats`);
  * `launch_shape` — the kernel's block, residency, registers and grid;
  * `tlas_entries_plain` — a vectorised torch lockstep walk of the TLAS
    supernodes in the TPU kernel's visit order, with its culling against
    the K-th best and its sorted insert. The kernel takes children nearest
    first, so it visits fewer nodes; its t_entry is bit-identical to this
    walk's, and its instance ids are the same up to entries of equal t
    (their order, and which of them is kept at the K-th slot);
  * `LAUNCHES` — how many times the kernel was launched.
"""

from __future__ import annotations

import torch

from rfw_tpu_torch.ops.traverse import (
    ARITY, MAX_ITERS, STACK_DEPTH, PreparedScene, WalkStats, _child_slab, _safe_inv,
    _t_limit, check_rays, node_arrays, plain_stats, ptr, query_shape, stats_buffers,
    stream_of,
)
from rfw_tpu_torch.render.intersect import T_MAX, T_MIN
from rfw_tpu_torch.render.twophase import TlasEntries

#: the kernel keeps the list in registers, one instantiation per K
MAX_K = 8

#: kernel launches; the wrapper adds one where it launches
LAUNCHES = {"entries": 0}


def tlas_entries_plain(ps: PreparedScene, ray_o, ray_d, t_limit=T_MAX,
                       K: int = 8, stats=None) -> TlasEntries:
    """Per ray, the K nearest TLAS instance entries (plain torch, any
    device). stats: a dict whose "nodes" and "boxes" entries gain the
    internal-node visits and child box tests the walk made, and whose
    "per_ray" entry becomes the same counts per ray (`WalkStats`, no leaves
    or slot tests)."""
    dev = ray_o.device
    R = ray_o.shape[0]
    i32 = torch.int32
    inf = float("inf")
    tl = _t_limit(t_limit, R, dev)
    ts = torch.full((R, K), inf, dtype=torch.float32, device=dev)
    ins = torch.full((R, K), -1, dtype=i32, device=dev)
    inv_all = _safe_inv(ray_d)

    S = ps.nodes.shape[0]
    boxes, codes, cnts = node_arrays(ps)
    node = torch.full((R,), ps.tlas_root, dtype=i32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    stack = torch.zeros((R, STACK_DEPTH), dtype=i32, device=dev)
    act = torch.arange(R, device=dev)
    if stats is not None:
        per_ray = WalkStats(*(torch.zeros(R, dtype=i32, device=dev) for _ in range(4)))

    for _ in range(MAX_ITERS):
        if act.numel() == 0:
            break
        nd, s = node[act], sp[act]
        pop = nd == -1
        live = ~(pop & (s <= 0))
        if not bool(live.all()):
            act, nd, s, pop = act[live], nd[live], s[live], pop[live]
            if act.numel() == 0:
                break
        s = torch.where(pop, s - 1, s)
        nd = torch.where(pop, stack[act, torch.clamp(s, min=0)], nd)
        new_node = torch.full_like(nd, -1)  # a malformed code is dropped

        inner = ((nd >= 0) & (nd < S)).nonzero().squeeze(1)
        if inner.numel():
            nidx = nd[inner].long()
            bx, cd, cn = boxes[nidx], codes[nidx], cnts[nidx]
            rays = act[inner]
            o = ray_o[rays]
            iv = inv_all[rays]
            obj_o = (o[:, 0], o[:, 1], o[:, 2])
            inv = (iv[:, 0], iv[:, 1], iv[:, 2])
            tlr = tl[rays]
            tsr, insr = ts[rays], ins[rays]
            next_code = torch.full_like(nidx, -1, dtype=i32)
            spi = s[inner]
            if stats is not None:
                boxes_r = (~((cd < 0) & (cn == 0))).sum(dim=1).to(i32)
                per_ray.nodes.index_add_(0, rays, torch.ones_like(boxes_r))
                per_ray.boxes.index_add_(0, rays, boxes_r)
                stats["nodes"] = stats.get("nodes", 0) + int(inner.numel())
                stats["boxes"] = stats.get("boxes", 0) + int(boxes_r.sum())
            for c in range(ARITY):
                code, cnt = cd[:, c], cn[:, c]
                tn, tf = _child_slab(bx, c, obj_o, inv)
                te = torch.clamp(tn, min=0.0)
                hitc = ((tn <= tf) & (tf > T_MIN)
                        & (te < torch.minimum(tsr[:, K - 1], tlr))
                        & ~((code < 0) & (cnt == 0)))
                box_ok = ((bx[:, c, 0] <= bx[:, c, 3]) & (bx[:, c, 1] <= bx[:, c, 4])
                          & (bx[:, c, 2] <= bx[:, c, 5]))
                leafc = hitc & (code < 0) & box_ok
                if bool(leafc.any()):
                    # sorted insert: the displaced entry moves one slot on
                    tq = torch.where(leafc, te, inf)
                    iq = torch.where(leafc, -code - 1, -1)
                    for j in range(K):
                        take = tq < tsr[:, j]
                        old_t, old_i = tsr[:, j].clone(), insr[:, j].clone()
                        tsr[:, j] = torch.where(take, tq, old_t)
                        insr[:, j] = torch.where(take, iq, old_i)
                        tq = torch.where(take, old_t, tq)
                        iq = torch.where(take, old_i, iq)
                intc = hitc & (code >= 0)
                push = intc & (next_code != -1)
                if bool(push.any()):
                    stack[rays[push], torch.clamp(spi[push], max=STACK_DEPTH - 1)] = \
                        next_code[push]
                spi = torch.where(push, torch.clamp(spi + 1, max=STACK_DEPTH), spi)
                next_code = torch.where(intc, code, next_code)
            ts[rays] = tsr
            ins[rays] = insr
            new_node[inner] = next_code
            s[inner] = spi
        node[act] = new_node
        sp[act] = s
    if stats is not None:
        stats["per_ray"] = per_ray
    return TlasEntries(ts, ins)


def launch_shape(K: int, stats: bool = False, n_rays: int = 0, device=None) -> dict:
    """The launch shape of the K4 kernel instance for K (`query_shape`)."""
    return query_shape("traverse_entries", "rfw_tlas_entries_info", K, stats, n_rays, device)


def _launch(ps: PreparedScene, ray_o, ray_d, t_limit, K: int, stats: bool):
    from rfw_tpu_torch.ops._build import load_library

    if not 1 <= K <= MAX_K:
        raise ValueError(f"the entries kernel keeps K in 1..{MAX_K}, not {K}")
    check_rays(ps, ray_o, ray_d)
    R = ray_o.shape[0]
    dev = ray_o.device
    tl = _t_limit(t_limit, R, dev)
    ts = torch.empty((R, K), dtype=torch.float32, device=dev)
    ins = torch.empty((R, K), dtype=torch.int32, device=dev)
    counts = warp_ns = None
    if stats:
        counts, warp_ns = stats_buffers(launch_shape(K, True, R, dev), R, dev)
    if R > 0:
        lib = load_library("traverse_entries")
        next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.rfw_tlas_entries(
                K, ptr(ps.nodes), ps.nodes.shape[0], ps.tlas_root,
                ptr(ray_o), ptr(ray_d), ptr(tl), R, ptr(ts), ptr(ins),
                ptr(next_ray), ptr(counts), ptr(warp_ns), stream_of(dev))
        if rc != 0:
            raise RuntimeError(f"entries kernel launch failed: cudaError {rc}")
        LAUNCHES["entries"] += 1
    if not stats:
        return TlasEntries(ts, ins)
    return TlasEntries(ts, ins), WalkStats(*counts.unbind(1), warp_ns=warp_ns)


def tlas_entries(ps: PreparedScene, ray_o, ray_d, t_limit=T_MAX,
                 K: int = 8, stats: bool = False):
    """Per ray, the K nearest TLAS instance entries (t_entry ascending,
    +inf / -1 for empty slots): the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU. A full list may have dropped
    a nearer-hit instance; phase B flags such rays for a retrace. With
    `stats`, (TlasEntries, WalkStats): per ray the node visits and box
    tests, and on the card each launched warp's span."""
    if ray_o.device.type == "cpu":
        if stats:
            return plain_stats(tlas_entries_plain, ps, ray_o, ray_d, t_limit, K)
        return tlas_entries_plain(ps, ray_o, ray_d, t_limit, K)
    return _launch(ps, ray_o, ray_d, t_limit, K, stats)
