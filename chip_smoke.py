"""Smoke check of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives rfw_tpu_torch's main paths — one progressive path-traced sample per
call of `render_sample`, 1920x1080, 1 bounce + next-event estimation, Sobol
sampler, film accumulation and tonemap — on a procedural scene at the
flagship scene's scale (4 icosphere meshes of 20,480 triangles, 256
instances, textured floor, area + spot + sun lights; made from a seed),
with two_phase="off" (every ray through the classic kernel) and with the
default two_phase="auto" (bounce rays through the two-phase path), and on
an instance-heavy scene of 10,000 instances.

Phases (any failed check raises, so the script exits nonzero):
  1. set-up: needs CUDA; builds the CUDA kernels from rfw_tpu_torch/csrc,
     one nvcc per source, all at once; prints ptxas's registers and spills
     and the launch shape (registers, resident blocks, theoretical
     occupancy) of each persistent walk kernel, K1/K2, K3/K5 and K4, and
     of its counting instance;
  2. scene build and upload;
  3. K1/K2 against their plain torch version on 65,536 rays (compare_call:
     K2's flags identical; K1, which takes children nearest first, under
     its gate: hit masks identical, t bit-identical but for at most 1 in
     10^5 rays within 1e-5 relative, prim/inst/u/v bit-identical but for
     counted exact-t ties), with the counting instance's per-ray counts
     beside the plain walk's, the SIMD efficiency of the launch order, the
     longest ray and the achieved occupancy;
  4. a 256x144 render through the kernels against the same render through
     the plain traversal (traversal="lockstep");
  5. the main path at 1920x1080 with two_phase="off": a warm-up sample
     whose traversal inputs are captured, each kernel against its plain
     version on exactly those inputs (compare_call, with both times), then 8 timed
     samples with the kernels' launch counters reset just before them;
  6. where the time goes: one sample with every stage bracketed by
     torch.cuda.synchronize(), one profiled sample (device time by
     kernel), and 4 samples traced with device activity only;
  7. two-phase on the flagship scene at 1920x1080 (its 512 instance-arena
     rows take the dense phase-A scan): the bounce rays of one sample
     captured (with RFW_TP_SHADOW=1, so the bounce shadow rays too), K1
     and K2 against their plain versions on the rays the two-phase
     fallbacks retrace, K3 and K5 against their plain versions on exactly
     those items (compare_items: K5's flags identical; K3, nearest first,
     under K1's gate over the live slots; both with the counts, SIMD
     efficiency, occupancy and bound of compare_call), the whole
     two-phase call against the classic kernel, its stages, K4 against its
     plain version on the same rays (compare_entries: t_entry
     bit-identical, ids up to counted equal-t swaps at the K-th kept t;
     counts as above) and the stages with phase A by K4
     (the dense-scan gate forced to 0), then the A/B in turns (the
     variants in order, then in reverse): classic K1 against the
     two-phase call with either phase A on the captured bounce rays, and
     ms per sample of two_phase="off" against "auto" (dense scan, then
     K4); the first "auto" turn is the counted run of the two-phase main
     path (launch counters reset just before it, read just after it);
  8. an instance-heavy scene at 1920x1080 (10,000 instances: 20,480-
     triangle spheres among small icospheres and cubes; its arena is far
     over 512 rows, so phase A is the K4 tree walk): with RFW_DENSE_ITEMS=1
     and RFW_TP_SHADOW=1, K1/K2 on the fallbacks' rays, K4 (on the bounce
     rays and on the bounce shadow rays, its two launches a sample), K3,
     K5 and K6 (closest and any hit) against
     their plain versions on one sample's captured inputs and the stages
     of the two-phase call; then the A/B in turns: classic K1 against the
     two-phase call with and without K6 on the captured bounce rays, and
     ms per sample of "off", "auto", and "auto" with both switches set,
     whose first turn is the counted run (every kernel must launch);
  9. the microbenchmarks of rfw_tpu_torch.tools: U1 (the leaf-test stages)
     in every variant against its plain version in one block and in a
     block per SM, U2 (K1's call shape without the walk) in every variant
     against its plain version at 1 and 512 tiles; then the counted run of
     their entry points (U1 in one block and in a block per SM, U2 over 1,
     8, 64 and 512 tiles with K1 on the same rays), and K1's time on the
     1080p primaries split by the cost model they give (call shape, leaf
     tests, node visits, remainder), once by the plain walk's counts and
     once by the kernel's own.
Every number is printed beside the card's name and power limit. The line
before the last two is {"kernels": [...]}: per kernel, its launches in its
path's counted run, its largest disagreement with the plain version, its
time and the plain version's per 1080p sample (the sum over the sample's
calls, each timed on that call's captured inputs; for U1 one call of
`full` at 512 iterations in one block, for U2 one `trivial` launch at 512
tiles), the least time the card could take for the same work (bytes over
3.35 TB/s or fp32 operations over 67 TFLOP/s, whichever is larger; U1's
operations over the fp32 peak of the one SM it occupies; K1-K5's
operations by whichever of the kernel's walk and the plain walk made
fewer, the plain walk's alone in bound_ms_plain_counts) and which of the
two bounds it; no single PyTorch call computes a BVH traversal or either
microbenchmark, so library_ms is null. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter, defaultdict
from contextlib import contextmanager, redirect_stdout
from pathlib import Path

import numpy as np
import torch

SEED = 7
W, H = 1920, 1080
SPP = 8
BOUNCES = 1
N_CMP = 65536
N_HEAVY = 10000  # instances of the phase-8 scene
HEAVY_SPP = 3
U1_ITERS, U1_REPS = 512, 3  # the reference tool's defaults
U1_CMP_ITERS = 16
U2_TILES, U2_REPS = (1, 8, 64, 512), 3

# the card's peaks for the bound (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# fp32 operations per unit of work, counted from csrc/bvh_common.cuh: one
# child slab test (6 sub, 6 mul, 10 min/max, 3 compares) and one Woop slot
# test (6 dot products of 5, 3 adds, 1 div, 2 mul + 2 add, 6 compares)
FLOP_PER_BOX = 25
FLOP_PER_TRI = 44


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


@contextmanager
def env(**kv):
    """Set environment variables for the duration of the block."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed(fn):
    """(fn(), device milliseconds of that one call) by CUDA events."""
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def check_nearest(card, label, kh, ph, name, live=None) -> float:
    """Hold a nearest-first walk (K1, K3) against the plain walk in the
    TPU's order: hit masks identical; t bit-identical where both hit, but
    for at most 1 in 10^5 live rows (all rows, or those of the mask `live`:
    K3's items, not its empty slots), each within 1e-5 relative and printed
    with which walk found the nearer triangle (the other dropped its box at
    the rounding edge, where a box's entry t lies past the triangle's t);
    prim, inst, u and v bit-identical except on an exact tie (another
    triangle at the plain walk's t, bit for bit), which is counted; misses,
    empty slots among them, identical in every output. Returns the largest
    |t| difference."""
    km, pm = kh.prim >= 0, ph.prim >= 0
    masks = torch.equal(km, pm)
    both = km & pm
    same_t = bits(kh.t) == bits(ph.t)
    diff = both & ~same_t
    same_id = (kh.prim == ph.prim) & (kh.inst == ph.inst)
    tie = both & same_t & ~same_id
    same_uv = (bits(kh.u) == bits(ph.u)) & (bits(kh.v) == bits(ph.v))
    bad_uv = int((both & same_t & same_id & ~same_uv).sum())
    miss_bad = int((~km & ~pm & ~(same_t & same_id & same_uv)).sum())
    n = kh.t.numel() if live is None else int(live.sum())
    n_diff = int(diff.sum())
    rel = ((kh.t - ph.t).abs() / ph.t.abs().clamp(min=1e-30))[diff]
    t_err = (kh.t - ph.t).abs()[both].max().item() if both.any() else 0.0
    log(card, f"{name}, {label}: hit masks identical {masks}, hits {int(both.sum())}, t "
              f"bit-identical on all but {n_diff} (max rel {rel.max().item() if n_diff else 0.0:.3e}), "
              f"exact-t ties (another triangle) {int(tie.sum())}, u/v differ on the same "
              f"triangle {bad_uv}, misses differ {miss_bad}, bit-identical "
              f"{all(torch.equal(a, b) for a, b in zip(kh, ph))}")
    for i in diff.nonzero().squeeze(1)[:20].tolist():
        nearer = "kernel" if kh.t[i] < ph.t[i] else "plain walk"
        log(card, f"  ray {i}: kernel t {kh.t[i].item():.9g} prim {kh.prim[i].item()} inst "
                  f"{kh.inst[i].item()}; plain t {ph.t[i].item():.9g} prim {ph.prim[i].item()} "
                  f"inst {ph.inst[i].item()}; the {nearer} found the nearer triangle, the other "
                  f"walk dropped its box at the rounding edge")
    assert masks, f"{name} ({label}): hit masks differ"
    assert n_diff <= n // 100000, f"{name} ({label}): t differs on {n_diff} of {n} rays"
    assert n_diff == 0 or rel.max().item() <= 1e-5, f"{name} ({label}): t differs by > 1e-5"
    assert bad_uv == 0 and miss_bad == 0, f"{name} ({label}): outputs differ off a tie"
    return t_err


def check_hits(card, label, kh, ph, name="K1 closest_hit kernel vs plain", exact=True,
               live=None) -> float:
    """Hold a closest-hit result against a reference: with `exact` (a
    kernel against its plain version), every output bit-identical; with
    exact="nearest", the nearest-first gate (check_nearest); otherwise hit
    masks agree on >= 99.99% of the live rows (all rows, or those of the
    mask `live`), and where both hit, t to 1e-5 relative, the same (prim,
    inst) unless t ties within 1e-6, and u/v to 1e-4. Returns the largest
    |t| difference where both hit."""
    if exact == "nearest":
        return check_nearest(card, label, kh, ph, name, live)
    km, pm = kh.prim >= 0, ph.prim >= 0
    agree = (km == pm) if live is None else (km == pm)[live]
    mask_agree = agree.float().mean().item() if agree.numel() else 1.0
    both = km & pm
    t_rel = ((kh.t - ph.t).abs() / ph.t.abs().clamp(min=1e-30))[both]
    t_abs = (kh.t - ph.t).abs()[both]
    same = (kh.prim == ph.prim) & (kh.inst == ph.inst) & both
    # a different triangle is only allowed on an exact-t tie
    tie = both & ~same & ((kh.t - ph.t).abs() <= 1e-6 * ph.t.abs())
    bad_id = (both & ~same & ~tie).sum().item()
    uv_err = torch.maximum((kh.u - ph.u).abs(), (kh.v - ph.v).abs())[same]
    t_err = t_abs.max().item() if t_abs.numel() else 0.0
    identical = all(torch.equal(a, b) for a, b in zip(kh, ph))
    log(card, f"{name}, {label}: hit-mask agreement "
              f"{mask_agree:.6f}, hits {int(both.sum())}, max t rel err "
              f"{t_rel.max().item() if t_rel.numel() else 0.0:.3e}, max t abs err {t_err:.3e}, "
              f"prim/inst differ (not a t tie) {bad_id}, t ties {int(tie.sum())}, "
              f"max u/v err {uv_err.max().item() if uv_err.numel() else 0.0:.3e}, "
              f"bit-identical {identical}")
    assert identical or not exact, f"{name} ({label}): not bit-identical"
    assert mask_agree >= 0.9999, f"{name} ({label}): hit masks agree on only {mask_agree}"
    assert t_rel.numel() == 0 or t_rel.max().item() <= 1e-5, f"{name} ({label}): t differs by more than 1e-5"
    assert bad_id == 0, f"{name} ({label}): {bad_id} rays hit another triangle at another t"
    assert uv_err.numel() == 0 or uv_err.max().item() <= 1e-4, f"{name} ({label}): u/v differ"
    return t_err


def check_occluded(card, label, ko, po, name="K2 occluded kernel vs plain", exact=True,
                   live=None) -> float:
    """Hold an occlusion result against a reference: with `exact`, every
    flag equal; otherwise the flags agree on >= 99.99% of the live rows
    (all rows, or those of the mask `live`). Returns the largest flag
    difference."""
    agree = (ko == po) if live is None else (ko == po)[live]
    occ_agree = agree.float().mean().item() if agree.numel() else 1.0
    identical = torch.equal(ko, po)
    log(card, f"{name}, {label}: flag agreement {occ_agree:.6f}, "
              f"occluded {int(po.sum())}, identical {identical}")
    assert identical or not exact, f"{name} ({label}): flags not identical"
    assert occ_agree >= 0.9999, f"{name} ({label}): occlusion agrees on only {occ_agree}"
    return float((ko.int() - po.int()).abs().max().item()) if ko.numel() else 0.0


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def flops(stats: dict) -> int:
    """fp32 operations of the counted box and slot tests."""
    return FLOP_PER_BOX * stats.get("boxes", 0) + FLOP_PER_TRI * stats.get("tris", 0)


def bound(n_bytes: int, stats: dict):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move n_bytes and do the fp32 operations of the counted box and slot
    tests, at its published peaks."""
    b_ms, f_ms = n_bytes / HBM_BYTES_PER_S * 1e3, flops(stats) / FP32_FLOP_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def compare_rays(card, ps, view, dev, seed):
    """K1/K2 against the plain torch walk on 65,536 rays: half subsampled
    1080p camera rays, half random directions from hit points."""
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.render.intersect import T_MAX
    from rfw_tpu_torch.render.wavefront import camera_rays_c

    rng = np.random.default_rng(seed)
    n_cam = N_CMP // 2
    pix = torch.from_numpy(rng.choice(W * H, n_cam, replace=False).astype(np.int32)).to(dev)
    jit = torch.from_numpy(rng.random((n_cam, 2), dtype=np.float32)).to(dev)
    o_c, d_c = camera_rays_c(view, W, H, (pix % W, pix // W),
                             jitter=(jit, torch.zeros_like(jit)))
    o_c, d_c = torch.stack(o_c, 1).contiguous(), torch.stack(d_c, 1).contiguous()
    ref = tr.closest_hit_plain(ps, o_c, d_c)
    hit = ref.prim >= 0
    # secondary rays leave just before the camera hits (or from the camera
    # when it missed) in uniformly random directions
    t_back = torch.where(hit, ref.t * 0.999, 0.0)
    o_s = o_c + d_c * t_back[:, None]
    d_s = torch.from_numpy(rng.normal(size=(n_cam, 3)).astype(np.float32)).to(dev)
    d_s = d_s / torch.linalg.norm(d_s, dim=1, keepdim=True)
    ray_o = torch.cat([o_c, o_s]).contiguous()
    ray_d = torch.cat([d_c, d_s]).contiguous()
    t_lim = torch.from_numpy(rng.uniform(0.0, 60.0, N_CMP).astype(np.float32)).to(dev)

    label = f"{N_CMP} mixed rays"
    k1 = compare_call(card, label, "closest", ps, ray_o, ray_d, T_MAX, reps=20)
    k2 = compare_call(card, label, "occluded", ps, ray_o, ray_d, t_lim, reps=20)
    return dict(K1=k1["max_abs_err"], K2=k2["max_abs_err"])


def simd_efficiency(ws) -> tuple:
    """(SIMD efficiency of the launch order, longest ray's steps) from per-
    ray counts: a ray's steps are its node and leaf visits; a warp of 32
    consecutive rays takes as many steps as its longest ray, so the
    efficiency is the sum of the steps over 32 x the warps' longest."""
    steps = (ws.nodes + ws.leaves).long()
    if steps.numel() == 0:
        return 1.0, 0
    pad = (-steps.numel()) % 32
    per_warp = torch.cat([steps, steps.new_zeros(pad)]).view(-1, 32).amax(dim=1)
    return steps.sum().item() / max(32 * per_warp.sum().item(), 1), int(steps.max())


def occupancy(shape: dict, warp_ns=None) -> tuple:
    """(theoretical, achieved) occupancy: resident warps over the SM's
    maximum by the launch shape, and the warps' summed lifetimes (their
    first and last %globaltimer) over that maximum through the launch's
    window; achieved is None where no warp wrote its times."""
    max_warps = shape["threads_per_sm"] // 32
    theory = shape["blocks_per_sm"] * shape["block"] // 32 / max_warps
    if warp_ns is None or not bool((warp_ns[:, 1] > 0).any()):
        return theory, None
    w = warp_ns[warp_ns[:, 1] > 0].double()
    window = (w[:, 1].max() - w[:, 0].min()).item()
    return theory, (w[:, 1] - w[:, 0]).sum().item() / max(window * shape["sms"] * max_warps, 1.0)


def walk_counts(card, tag, ks, stats, n_bytes, shapes) -> dict:
    """A persistent walk kernel's per-ray counts (ks, from its counting
    instance) beside its plain version's (stats: totals and "per_ray"), the
    bound from n_bytes and the box and slot tests of whichever made fewer
    operations (and of the plain walk alone), the SIMD efficiency of the
    launch order, the longest ray or item, and the theoretical and achieved
    occupancy (shapes: the default and the counting instance's launch
    shapes). Logs the counts; returns the row's fields."""
    pr = stats["per_ray"]
    counts_equal = all(torch.equal(a, b) for a, b in zip(ks[:4], pr[:4]))
    k_tot = {k: int(getattr(ks, k).sum()) for k in ("nodes", "boxes", "leaves", "tris")}
    fewer = min(k_tot, stats, key=flops)
    b_ms, by = bound(n_bytes, fewer)
    b_plain, _ = bound(n_bytes, stats)
    eff, longest = simd_efficiency(ks)
    eff_p, longest_p = simd_efficiency(pr)
    shape_d, shape_s = shapes
    theory, achieved = occupancy(shape_s, ks.warp_ns)
    theory_d, _ = occupancy(shape_d)
    log(card, f"{tag} counts: kernel {k_tot['nodes']} node visits, {k_tot['boxes']} box "
              f"tests, {k_tot['leaves']} leaf visits, {k_tot['tris']} slot tests; plain walk "
              f"{stats.get('nodes', 0)}, {stats.get('boxes', 0)}, {stats.get('leaves', 0)}, "
              f"{stats.get('tris', 0)}; per-ray counts equal {counts_equal}; SIMD efficiency of "
              f"the launch order {eff:.4f} (plain walk's {eff_p:.4f}), longest {longest} steps "
              f"(plain {longest_p}); {shape_d['registers']} registers, occupancy theoretical "
              f"{theory_d:.3f} (counting instance {theory:.3f}), achieved "
              f"{'not measured' if achieved is None else f'{achieved:.3f}'} (counting instance)")
    return dict(bound_ms=b_ms, bound_by=by, bound_ms_plain_counts=b_plain,
                bound_counts="kernel" if fewer is k_tot else "plain walk",
                nodes=stats.get("nodes", 0), boxes=stats.get("boxes", 0),
                leaves=stats.get("leaves", 0), tris=stats.get("tris", 0), kernel_counts=k_tot,
                counts_equal=counts_equal, simd_efficiency=eff, longest_steps=longest,
                occupancy=theory_d, achieved_occupancy=achieved,
                registers=shape_d["registers"])


def bound_note(row) -> str:
    """The bound of a compared call as compare_call prints it."""
    fewer = row["kernel_counts"] if row["bound_counts"] == "kernel" else row
    return (f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; the {row['bound_counts']}'s "
            f"{fewer['boxes']} box tests, {fewer['tris']} slot tests; by the plain walk's "
            f"counts {row['bound_ms_plain_counts']:.4f} ms)")


def compare_call(card, label, kind, ps, o, d, tl, reps=10) -> dict:
    """K1 (kind "closest") or K2 ("occluded") against its plain version on
    one call's inputs: K2's flags identical, K1 under its nearest-first
    gate; the counting instance gives the same result as the default one,
    and its per-ray counts stand beside the plain walk's (both kernels take
    children nearest first, the plain walk in the TPU's order, so the
    counts differ; walk_counts). Kernel time by CUDA events over `reps`
    launches, plain time of the compared call, the bound from the call's
    bytes (rays in and out, the scene arrays once) and the box and slot
    tests of whichever walk made fewer operations. Returns the call's
    row."""
    from rfw_tpu_torch.ops import traverse as tr

    n = o.shape[0]
    tl_t = tl if isinstance(tl, torch.Tensor) else torch.full((n,), tl, device=o.device)
    live = int((tl_t > 0).sum())
    stats = {}
    scene_b = nbytes(ps.nodes, ps.tris, ps.insts, ps.roots)
    tag = f"{label}, {n} rays"
    if kind == "closest":
        name, fn, out_b = "K1", tr.closest_hit, 20
        ref, plain_ms = timed(lambda: tr.closest_hit_plain(ps, o, d, tl, stats=stats))
        got = fn(ps, o, d, tl)
        err = check_hits(card, tag, got, ref, exact="nearest")
        got_s, ks = fn(ps, o, d, tl, stats=True)
        same = all(torch.equal(a, b) for a, b in zip(got_s, got))
    else:
        name, fn, out_b = "K2", tr.occluded, 1
        ref, plain_ms = timed(lambda: tr.occluded_plain(ps, o, d, tl, stats=stats))
        got = fn(ps, o, d, tl)
        err = check_occluded(card, tag, got, ref)
        got_s, ks = fn(ps, o, d, tl, stats=True)
        same = torch.equal(got_s, got)
    assert same, f"{name} ({tag}): the counting instance gives another result"
    ms = cuda_ms(lambda: fn(ps, o, d, tl), reps)
    shapes = [tr.launch_shape(kind == "occluded", c, n) for c in (False, True)]
    row = walk_counts(card, f"{name} {label}", ks, stats, n * (28 + out_b) + scene_b, shapes)
    log(card, f"{name} {label}: {n} rays ({live} live), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, {bound_note(row)}")
    return dict(call=label, rays=n, live=live, ms=ms, plain_ms=plain_ms, max_abs_err=err, **row)


@contextmanager
def patched(module, **fns):
    """Replace module-level names for the duration of the block."""
    old = {k: getattr(module, k) for k in fns}
    for k, f in fns.items():
        setattr(module, k, f)
    try:
        yield
    finally:
        for k, f in old.items():
            setattr(module, k, f)


def capture_traversal(run):
    """Run `run()` with render_sample's traversal calls recorded. Returns
    [(label, kind, prepared scene, ray_o, ray_d, t_limit)] in call order;
    the calls still go to the kernels."""
    from rfw_tpu_torch.render import wavefront as wf

    calls = []

    def recorder(kind, fn):
        def record(ps, ray_o, ray_d, t_limit):
            vertex = sum(c[1] == "closest" for c in calls) - (kind == "occluded")
            label = f"vertex {vertex} {'closest' if kind == 'closest' else 'shadow'}"
            tl = t_limit.clone() if isinstance(t_limit, torch.Tensor) else t_limit
            calls.append((label, kind, ps, ray_o.clone(), ray_d.clone(), tl))
            return fn(ps, ray_o, ray_d, t_limit)
        return record

    with patched(wf, closest_hit=recorder("closest", wf.closest_hit),
                 occluded=recorder("occluded", wf.occluded)):
        run()
    return calls


def compare_main_path(card, calls):
    """Each kernel against its plain version on the captured inputs of one
    1080p sample (compare_call). Returns per-kernel call rows."""
    rows = defaultdict(list)
    for label, kind, ps, o, d, tl in calls:
        rows[kind].append(compare_call(card, label, kind, ps, o, d, tl))
    return rows


def fallback_calls(ps, o, d, tl, so, sd, stl, cfg):
    """The two-phase calls on captured bounce rays and bounce shadow rays,
    with their fallbacks' K1 and K2 calls recorded: [(label, kind, ray_o,
    ray_d, t_limit)]; the calls still go to the kernels."""
    from rfw_tpu_torch.ops import traverse_items as ti

    calls = []

    def recorder(kind, fn):
        def record(ps_, ro, rd, rtl):
            calls.append((f"{kind} fallback", kind, ro.clone(), rd.clone(), rtl.clone()))
            return fn(ps_, ro, rd, rtl)
        return record

    kw = dict(K=cfg.tp_K, items_per_ray=cfg.tp_items_per_ray)
    with patched(ti, closest_hit=recorder("closest", ti.closest_hit),
                 occluded=recorder("occluded", ti.occluded)):
        ti.twophase_closest_with_fallback(ps, o, d, tl, **kw)
        ti.twophase_occluded_with_fallback(ps, so, sd, stl, **kw)
    return calls


def compare_fallback(card, scene_label, ps, o, d, tl, so, sd, stl, cfg):
    """K1 and K2 against their plain versions on the rays the two-phase
    fallbacks retrace (compare_call). Returns per-kernel call rows."""
    rows = defaultdict(list)
    for label, kind, ro, rd, rtl in fallback_calls(ps, o, d, tl, so, sd, stl, cfg):
        rows[kind].append(compare_call(card, f"{scene_label} {label}", kind, ps, ro, rd, rtl))
    return rows


def capture_twophase(run):
    """Run `run()` with render_sample's two-phase calls recorded: returns
    [(kind, prepared scene, ray_o, ray_d, t_limit)]; the calls still run."""
    from rfw_tpu_torch.render import wavefront as wf

    calls = []

    def recorder(kind, fn):
        def record(ps, ray_o, ray_d, t_limit, **kw):
            calls.append((kind, ps, ray_o.clone(), ray_d.clone(), t_limit.clone()))
            return fn(ps, ray_o, ray_d, t_limit, **kw)
        return record

    with patched(wf, twophase_closest_with_fallback=recorder(
            "closest", wf.twophase_closest_with_fallback),
            twophase_occluded_with_fallback=recorder(
            "occluded", wf.twophase_occluded_with_fallback)):
        run()
    return calls


def packed_items(ps, o, d, tl, K, items_per_ray):
    """Phase A and the pack of one two-phase call, as phase B gets them:
    (entries, slot_inst, o_s, d_s, tl_s, dense-tier mask)."""
    from rfw_tpu_torch.accel.bvh_cpu import TREELET
    from rfw_tpu_torch.ops import traverse_items as ti

    ents, _, _, slot_inst, o_s, d_s, tl_s = ti._pack(ps, o, d, tl, K, items_per_ray)
    iid = slot_inst.clamp(0, max(ps.n_inst - 1, 0)).long()
    nt = ps.thi[iid] - ps.tlo[iid]
    dense_k = (slot_inst >= 0) & (nt > 0) & (nt <= ti.DENSE_MAX_TRIS // TREELET)
    return ents, slot_inst, o_s, d_s, tl_s, dense_k


def compare_items(card, name, label, dense, any_hit, ps, inst, o, d, tl):
    """One phase-B kernel against its plain version on packed items: K6
    (dense) and K5 (any hit) identical; K3, which takes children nearest
    first, under the nearest-first gate over the live slots (empty slots
    identical). For K3/K5 the counting instance gives the same result, and
    its per-item counts stand beside the plain walk's (walk_counts). Kernel
    time by CUDA events over 10 launches, plain time of the compared call,
    and the bound from the bytes the kernel touches (a live item reads its
    instance, o, d and t_limit, 32 B; an empty slot reads its instance, and
    its t_limit for closest hits; every slot writes 20 B of hit or 1 B of
    flag), the scene arrays it reads once, and the test counts (K3/K5: of
    whichever walk made fewer operations)."""
    from rfw_tpu_torch.ops import traverse_items as ti

    fn, plain = (ti.dense_items, ti.dense_items_plain) if dense else (ti.items, ti.items_plain)
    stats = {}
    ref, plain_ms = timed(lambda: plain(ps, inst, o, d, tl, any_hit, stats=stats))
    got = fn(ps, inst, o, d, tl, any_hit)
    live_k = inst >= 0
    n, live = inst.shape[0], int(live_k.sum())
    if any_hit:
        err = check_occluded(card, label, got, ref, name=f"{name} kernel vs plain", live=live_k)
    else:
        err = check_hits(card, label, got, ref, name=f"{name} kernel vs plain",
                         exact=True if dense else "nearest", live=live_k)
    ms = cuda_ms(lambda: fn(ps, inst, o, d, tl, any_hit), 10)
    if dense:
        # the treelets of the meshes the items test, the instance rows
        iid = inst[inst >= 0].long()
        spans = torch.unique(torch.stack([ps.tlo[iid], ps.thi[iid]], 1), dim=0)
        scene_b = int((spans[:, 1] - spans[:, 0]).sum()) * 64 * 64 + nbytes(ps.insts, ps.tlo, ps.thi)
    else:
        scene_b = nbytes(ps.nodes, ps.tris, ps.insts, ps.roots)
    out_b = 1 if any_hit else 20
    item_b = live * (32 + out_b) + (n - live) * ((4 if any_hit else 8) + out_b)
    head = (f"{name} {label}: {n} item slots ({live} items), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms")
    if dense:
        b_ms, by = bound(item_b + scene_b, stats)
        log(card, f"{head}, bound {b_ms:.4f} ms ({by}; {item_b} B of items, {scene_b} B of "
                  f"scene, {stats.get('tris', 0)} slot tests)")
        return dict(call=label, items=live, slots=n, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=by, max_abs_err=err)
    got_s, ks = fn(ps, inst, o, d, tl, any_hit, stats=True)
    same = torch.equal(got_s, got) if any_hit else all(
        torch.equal(a, b) for a, b in zip(got_s, got))
    assert same, f"{name} ({label}): the counting instance gives another result"
    assert not any(bool(getattr(ks, k)[~live_k].any()) for k in ("nodes", "boxes", "leaves",
                                                                 "tris")), \
        f"{name} ({label}): an empty slot counts a visit"
    shapes = [ti.launch_shape(any_hit, c, n) for c in (False, True)]
    row = walk_counts(card, f"{name} {label}", ks, stats, item_b + scene_b, shapes)
    log(card, f"{head}, {bound_note(row)}; {item_b} B of items, {scene_b} B of scene")
    return dict(call=label, items=live, slots=n, ms=ms, plain_ms=plain_ms, max_abs_err=err,
                **row)


def ids_by_t(e):
    """Per ray, (t_entry, inst) with the ids ascending inside each run of
    equal t (the runs themselves stay in t order)."""
    by_id = torch.sort(e.inst, dim=1, stable=True)
    by_t = torch.sort(e.t_entry.gather(1, by_id.indices), dim=1, stable=True)
    return by_t.values, by_id.values.gather(1, by_t.indices)


def check_entries(card, label, got, ref, K) -> float:
    """Hold K4's nearest-first walk against the plain walk in the TPU's
    order: t_entry bit-identical, the finite masks equal and ids -1 exactly
    where t is +inf; per ray and per distinct t the same multiset of
    instance ids, except at a full list's K-th kept t, where another of
    several equal-t entries may be kept: those rays are counted and the
    first printed. Returns the largest |t| difference."""
    fin = torch.isfinite(ref.t_entry)
    same_t = torch.equal(bits(got.t_entry), bits(ref.t_entry))
    masks = torch.equal(torch.isfinite(got.t_entry), fin) and torch.equal(got.inst >= 0, fin)
    t, gi = ids_by_t(got)
    _, ri = ids_by_t(ref)
    kth = ref.t_entry[:, K - 1:K]
    at_kth = (t == kth) & torch.isfinite(kth)
    differ = gi != ri
    bad = int((differ & ~at_kth).sum())
    swapped = (differ & at_kth).any(dim=1)
    both_fin = fin & torch.isfinite(got.t_entry)
    err = (got.t_entry - ref.t_entry).abs()[both_fin]
    err = err.max().item() if err.numel() else 0.0
    identical = torch.equal(got.t_entry, ref.t_entry) and torch.equal(got.inst, ref.inst)
    log(card, f"K4 tlas_entries kernel vs plain, {label}: {got.inst.shape[0]} rays, K={K}, "
              f"entries {int(fin.sum())}, t_entry bit-identical {same_t}, finite masks equal "
              f"{masks}, ids differ off the K-th kept t {bad}, rays whose K-th kept t keeps "
              f"another of its equal-t entries {int(swapped.sum())}, identical {identical}")
    for r in swapped.nonzero().squeeze(1)[:5].tolist():
        log(card, f"  ray {r}: K-th kept t {kth[r, 0].item():.9g}; kernel ids "
                  f"{got.inst[r].tolist()}, plain ids {ref.inst[r].tolist()}")
    assert same_t and masks, f"K4 ({label}): t_entry not bit-identical"
    assert bad == 0, f"K4 ({label}): {bad} ids differ off the K-th kept t"
    return err


def compare_entries(card, label, ps, o, d, tl, K):
    """K4 against its plain version on captured rays (check_entries); the
    counting instance gives the same result, and its per-ray counts stand
    beside the plain walk's (walk_counts). Kernel time by CUDA events over
    10 launches, plain time of the compared call, and the bound from the
    rays' bytes (28 B in, 8K out), the TLAS rows once and the box tests of
    whichever walk made fewer."""
    from rfw_tpu_torch.ops import traverse_entries as te

    stats = {}
    ref, plain_ms = timed(lambda: te.tlas_entries_plain(ps, o, d, tl, K, stats=stats))
    got = te.tlas_entries(ps, o, d, tl, K)
    err = check_entries(card, label, got, ref, K)
    got_s, ks = te.tlas_entries(ps, o, d, tl, K, stats=True)
    assert all(torch.equal(a, b) for a, b in zip(got_s, got)), \
        f"K4 ({label}): the counting instance gives another result"
    ms = cuda_ms(lambda: te.tlas_entries(ps, o, d, tl, K), 10)
    n = o.shape[0]
    live = int((tl > 0).sum())
    tlas_b = (ps.nodes.shape[0] - ps.tlas_root) * ps.nodes.shape[1] * 4
    shapes = [te.launch_shape(K, c, n) for c in (False, True)]
    row = walk_counts(card, f"K4 {label}", ks, stats, n * (28 + 8 * K) + tlas_b, shapes)
    log(card, f"K4 {label}: {n} rays ({live} live), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, {bound_note(row)}")
    return dict(call=label, rays=n, live=live, ms=ms, plain_ms=plain_ms, max_abs_err=err, **row)


def twophase_stages(card, label, ps, o, d, tl, cfg):
    """One two-phase call with its stages bracketed by synchronize():
    phase A, pack, phase B kernels, merge, fallback; and the fallback's
    ray count."""
    from rfw_tpu_torch.ops import traverse_items as ti

    clock = StageClock()
    fallback = []

    def count_fallback(ps_, o_, *a):
        fallback.append(o_.shape[0])
        return ti_closest(ps_, o_, *a)

    ti_closest = ti.closest_hit
    stages = dict(_phase_a="phase A", _pack="pack (compaction, instance sort, gather)",
                  items="phase B: K3 items", dense_items="phase B: K6 dense items",
                  _merge_closest="merge (scatter-min)")
    with patched(ti, **{f: clock.wrap(n, getattr(ti, f)) for f, n in stages.items()},
                 closest_hit=clock.wrap("fallback (K1 retrace)", count_fallback)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ti.twophase_closest_with_fallback(ps, o, d, tl, K=cfg.tp_K,
                                          items_per_ray=cfg.tp_items_per_ray)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    rest = total - sum(clock.ms.values())
    _, trunc = ti.twophase_closest_fused(ps, o, d, tl, K=cfg.tp_K,
                                         items_per_ray=cfg.tp_items_per_ray)
    log(card, f"two-phase call stages, {label}: {total:.2f} ms in all; truncated rays "
              f"{int(trunc.sum())}, retraced by the fallback {sum(fallback)}")
    for name, ms in sorted([*clock.ms.items(), ("other (ray gathers, flags, glue)", rest)],
                           key=lambda kv: -kv[1]):
        log(card, f"  {ms:9.3f} ms  {100 * ms / total:5.1f}%  {name}")


def twophase_vs_classic(card, label, ps, o, d, tl, cfg, occluded_too=None):
    """The whole two-phase call against the classic kernel on the same
    rays (exact contract, up to rays past the fallback's capacity)."""
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.ops import traverse_items as ti

    kw = dict(K=cfg.tp_K, items_per_ray=cfg.tp_items_per_ray)
    _, trunc = ti.twophase_closest_fused(ps, o, d, tl, **kw)
    within = int(trunc.sum()) <= ti.fallback_capacity(o.shape[0])
    tp = ti.twophase_closest_with_fallback(ps, o, d, tl, **kw)
    ref = tr.closest_hit(ps, o, d, tl)
    hm, rm = tp.prim >= 0, ref.prim >= 0
    live = tl > 0
    log(card, f"two-phase call vs K1, {label}: {o.shape[0]} rays, truncated {int(trunc.sum())} "
              f"(all retraced: {within}), hit-mask agreement over the live rays "
              f"{(hm == rm)[live].float().mean().item():.6f}")
    if within:
        check_hits(card, label, tp, ref, name="two-phase call vs K1", exact=False, live=live)
    if occluded_too is not None:
        so, sd, stl = occluded_too
        occ = ti.twophase_occluded_with_fallback(ps, so, sd, stl, **kw)
        check_occluded(card, label, occ, tr.occluded(ps, so, sd, stl),
                       name="two-phase any-hit call vs K2", exact=False, live=stl > 0)


def _counters():
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.ops import traverse_entries as te
    from rfw_tpu_torch.ops import traverse_items as ti
    from rfw_tpu_torch.tools import ubench_grid as ug
    from rfw_tpu_torch.tools import ubench_leaf as ul

    return tr.LAUNCHES, te.LAUNCHES, ti.LAUNCHES, ul.LAUNCHES, ug.LAUNCHES


def reset_launches():
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    return {k: n for counts in _counters() for k, n in counts.items()}


class StageClock:
    """Exclusive host-clock milliseconds per wrapped function, each call
    bracketed by torch.cuda.synchronize(); a nested wrapped call counts
    for itself only."""

    def __init__(self):
        self.ms = defaultdict(float)
        self._open = []  # per open call: ms spent in wrapped callees

    def wrap(self, name, fn):
        def timed_stage(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._open.append(0.0)
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            inner = self._open.pop()
            self.ms[name] += dt - inner
            if self._open:
                self._open[-1] += dt
            return out
        return timed_stage


def stage_breakdown(card, run):
    """One sample with its stages bracketed; prints ms and share per stage."""
    from rfw_tpu_torch.render import disney
    from rfw_tpu_torch.render import wavefront as wf

    clock = StageClock()
    wf_stages = dict(
        prepare_scene="prepare_scene", sample_slot="sobol uniforms (sample_slot)",
        camera_rays_c="camera rays", closest_hit="trace closest (K1)",
        occluded="trace shadow (K2)", _shading_basis_c="shading basis",
        _fetch_material_c="material + textures", _sample_light_c="NEE light sample",
        morton_codes_c="sort key (Morton)")
    disney_stages = dict(disney_eval_c="disney eval", disney_pdf_c="disney pdf",
                         disney_sample_c="disney sample")
    with patched(wf, **{f: clock.wrap(n, getattr(wf, f)) for f, n in wf_stages.items()}), \
            patched(disney, **{f: clock.wrap(n, getattr(disney, f))
                               for f, n in disney_stages.items()}):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    rest = total - sum(clock.ms.values())
    log(card, f"stage breakdown of one bracketed sample: {total:.2f} ms (exclusive times)")
    for name, ms in sorted([*clock.ms.items(), ("other (sort, gathers, MIS, glue)", rest)],
                           key=lambda kv: -kv[1]):
        log(card, f"  {ms:9.3f} ms  {100 * ms / total:5.1f}%  {name}")


def profile_sample(card, run):
    """One sample under the profiler (host ops and device activity): device
    time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # device events only: the aten ops that launched them carry the same
    # device time again
    dev_us = [(e.key, e.device_time_total) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total_us = sum(us for _, us in dev_us)
    if total_us <= 0:
        log(card, "profiled sample: device time not measured (the profiler saw none)")
        return
    trav = sum(us for k, us in dev_us if "traverse_kernel" in k)
    log(card, f"profiled sample: kernel time {total_us / 1e3:.2f} ms, traversal kernels "
              f"{trav / 1e3:.2f} ms ({100 * trav / total_us:.1f}%)")
    for k, us in sorted(dev_us, key=lambda kv: -kv[1])[:12]:
        log(card, f"  {us / 1e3:9.3f} ms  {k[:90]}")


def busy_share(card, run, n: int):
    """Device busy share over `n` back-to-back samples traced with device
    activity only: no host op is recorded, so the host launches near its
    unprofiled pace. Busy = the union of kernel and copy spans; the window
    runs from the first device event to the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(n):
            run(s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        log(card, f"{n} traced samples: device busy share not measured (no device events)")
        return
    busy, cur0, cur1 = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur1:
            busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    window = max(b for _, b in spans) - spans[0][0]
    log(card, f"{n} samples traced (device activity only): {wall_ms / n:.2f} ms/sample on the "
              f"host clock, device window {window / 1e3:.2f} ms, busy {busy / 1e3:.2f} ms "
              f"({100 * busy / window:.1f}%), idle {100 * (1 - busy / window):.1f}% "
              f"(union of {len(spans)} device events)")


def ab_calls(card, label, variants):
    """ms per call of each (name, fn) variant by CUDA events over 5 runs, in
    turns: the variants in order, then in reverse."""
    turns = [(name, cuda_ms(fn, 5)) for name, fn in [*variants, *variants[::-1]]]
    log(card, f"A/B on {label} (ms per call, in turns): "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in turns))


def ab_samples(card, dev, label, variants, sample, counted, n=3):
    """ms per 1080p sample of each (name, config, context) variant on the
    host clock, n samples a turn after one warm-up, in turns: the variants
    in order, then in reverse. The first turn of variant `counted` is its
    path's counted run: the launch counters and the peak memory are reset
    just before it and read just after. Returns (launches, peak bytes, the
    summed radiance of that run)."""
    out = None
    turns = []
    for i, (name, cfg, ctx) in enumerate([*variants, *variants[::-1]]):
        with ctx():
            sample(cfg, 1000 + 10 * i)  # warm-up of this turn
            torch.cuda.synchronize()
            count = name == counted and out is None
            if count:
                reset_launches()
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            acc = sum(sample(cfg, 1001 + 10 * i + k).radiance for k in range(n))
            torch.cuda.synchronize()
            turns.append((name, (time.perf_counter() - t0) / n * 1e3))
            if count:
                out = read_launches(), torch.cuda.max_memory_allocated(dev), acc
    log(card, f"A/B ms per 1080p sample, {label} (host clock, {n} samples a turn, in turns): "
              + ", ".join(f"{name} {ms:.2f}" for name, ms in turns))
    launches, peak, acc = out
    log(card, f"{label}, counted run of {counted} ({n} samples): launches {launches}, peak "
              f"memory {peak / 2**30:.3f} GiB ({peak} B)")
    assert bool(torch.isfinite(acc).all()), f"non-finite radiance ({label}, {counted})"
    assert acc.mean().item() > 0.0, f"black film ({label}, {counted})"
    return launches, peak, acc


def phase7(card, dev, scene, mats, atlas, lights, view, ps, base):
    """Two-phase on the flagship scene at 1920x1080: K1/K2 on the rays the
    fallbacks retrace and K3/K5 against their plain versions on one
    sample's captured bounce items, the two-phase call against the classic
    kernel and by stage, and the A/B in turns, with phase A by the dense
    scan (the default at 512 arena rows) and by K4 (the gate forced to
    0)."""
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.ops import traverse_items as ti
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample

    cfg = RenderConfig(**{**base, "two_phase": "auto"})
    cfg_off = RenderConfig(**base)

    def sample(c, s):
        return render_sample(scene, mats, atlas, lights, view, W, H, c, sample_index=s)

    with env(RFW_TP_SHADOW="1"):
        calls = capture_twophase(lambda: sample(cfg, 100))
    kinds = [c[0] for c in calls]
    assert kinds == ["closest", "occluded"], f"two-phase calls seen: {kinds}"
    (_, _, o, d, tl), (_, _, so, sd, stl) = calls
    log(card, f"phase 7: captured {o.shape[0]} bounce rays ({int((tl > 0).sum())} live) and "
              f"{so.shape[0]} bounce shadow rays ({int((stl > 0).sum())} live); instance arena "
              f"{ps.inst_min.shape[0]} rows -> phase A by "
              f"{'the dense scan' if ps.inst_min.shape[0] <= ti.DENSE_A_MAX_INST else 'K4'}")
    fb = compare_fallback(card, "flagship", ps, o, d, tl, so, sd, stl, cfg)
    _, inst, o_s, d_s, tl_s, _ = packed_items(ps, o, d, tl, cfg.tp_K, cfg.tp_items_per_ray)
    k3 = compare_items(card, "K3", "bounce closest items", False, False, ps, inst, o_s, d_s, tl_s)
    _, inst, o_s, d_s, tl_s, _ = packed_items(ps, so, sd, stl, cfg.tp_K, cfg.tp_items_per_ray)
    k5 = compare_items(card, "K5", "bounce shadow items", False, True, ps, inst, o_s, d_s, tl_s)
    twophase_vs_classic(card, "flagship bounce rays", ps, o, d, tl, cfg, (so, sd, stl))
    twophase_stages(card, "flagship bounce rays", ps, o, d, tl, cfg)
    with patched(ti, DENSE_A_MAX_INST=0):
        k4 = compare_entries(card, "flagship bounce rays", ps, o, d, tl, cfg.tp_K)
        twophase_stages(card, "flagship bounce rays, phase A by K4", ps, o, d, tl, cfg)

    kw = dict(K=cfg.tp_K, items_per_ray=cfg.tp_items_per_ray)

    def tp_k4():
        with patched(ti, DENSE_A_MAX_INST=0):
            return ti.twophase_closest_with_fallback(ps, o, d, tl, **kw)

    ab_calls(card, "the captured flagship bounce rays", [
        ("classic K1", lambda: tr.closest_hit(ps, o, d, tl)),
        ("two-phase (dense phase A)", lambda: ti.twophase_closest_with_fallback(ps, o, d, tl, **kw)),
        ("two-phase (K4 phase A)", tp_k4)])
    launches, _, _ = ab_samples(card, dev, "flagship scene", [
        ("off", cfg_off, env), ("auto", cfg, env),
        ("auto, phase A by K4", cfg, lambda: patched(ti, DENSE_A_MAX_INST=0))],
        sample, counted="auto")
    for k in ("closest", "occluded", "items_closest"):
        assert launches[k] > 0, f"the two-phase main path never launched {k}"
    return dict(K3=[k3], K5=[k5], K4=[k4], launches=launches, fallback=fb)


def phase8(card, dev, base):
    """The instance-heavy scene at 1920x1080 with the dense items tier and
    two-phase bounce shadows: K4, K3, K5 and K6 against their plain
    versions on one sample's captured inputs, K1 and K2 on the fallbacks'
    rays, the A/B in turns, and the counted render."""
    from rfw_tpu_torch.convert import from_numpy_scene
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.ops import traverse_items as ti
    from rfw_tpu_torch.render.wavefront import (
        RenderConfig, mat_feature_mask, render_sample, tex_kinds_mask,
    )
    from rfw_tpu_torch.scenes import build_heavy_scene

    t0 = time.perf_counter()
    scene_np, mats_np, lights_np, atlas_np, camera = build_heavy_scene(SEED + 1, N_HEAVY)
    scene, mats, lights, atlas = from_numpy_scene(scene_np, mats_np, lights_np, atlas_np, dev)
    ps = tr.prepare_scene(scene)
    span = (ps.thi - ps.tlo)[: int((scene_np.inst_mesh >= 0).sum())]
    log(card, f"phase 8 scene: {int((scene_np.inst_mesh >= 0).sum())} instances "
              f"({ps.inst_min.shape[0]} arena rows), {scene_np.tri_v0.shape[0]} triangle rows, "
              f"{int((span <= ti.DENSE_MAX_TRIS // 64).sum())} instances of dense-tier meshes, "
              f"built and uploaded in {time.perf_counter() - t0:.2f} s")
    assert ps.inst_min.shape[0] > ti.DENSE_A_MAX_INST
    view = torch.from_numpy(camera.get_view(W, H).as_array()).to(dev)
    cfg = RenderConfig(**{**base, "two_phase": "auto", "tex_mask": tex_kinds_mask(mats_np.tex),
                          "mat_features": mat_feature_mask(mats_np),
                          "has_area_lights": bool(lights_np.n_area[0] > 0)})
    cfg_off = dataclasses.replace(cfg, two_phase="off")

    def sample(c, s):
        return render_sample(scene, mats, atlas, lights, view, W, H, c, sample_index=s)

    def tiers():
        return env(RFW_TP_SHADOW="1", RFW_DENSE_ITEMS="1")

    with tiers():
        calls = capture_twophase(lambda: sample(cfg, 0))
        kinds = [c[0] for c in calls]
        assert kinds == ["closest", "occluded"], f"two-phase calls seen: {kinds}"
        (_, _, o, d, tl), (_, _, so, sd, stl) = calls
        fb = compare_fallback(card, "heavy", ps, o, d, tl, so, sd, stl, cfg)
        k4 = [compare_entries(card, "heavy bounce rays", ps, o, d, tl, cfg.tp_K),
              compare_entries(card, "heavy bounce shadow rays", ps, so, sd, stl, cfg.tp_K)]
        rows = dict(K3=[], K5=[], K6=[])
        for label, (ro, rd, rtl), any_hit in (("bounce closest", (o, d, tl), False),
                                              ("bounce shadow", (so, sd, stl), True)):
            _, inst, o_s, d_s, tl_s, dense_k = packed_items(
                ps, ro, rd, rtl, cfg.tp_K, cfg.tp_items_per_ray)
            none = torch.full_like(inst, -1)
            walk_i = torch.where(dense_k, none, inst).contiguous()
            dense_i = torch.where(dense_k, inst, none).contiguous()
            rows["K5" if any_hit else "K3"].append(compare_items(
                card, "K5" if any_hit else "K3", f"heavy {label} items (walk tier)", False,
                any_hit, ps, walk_i, o_s, d_s, tl_s))
            rows["K6"].append(compare_items(
                card, "K6", f"heavy {label} items (dense tier)", True, any_hit, ps, dense_i,
                o_s, d_s, tl_s))
        twophase_vs_classic(card, "heavy bounce rays", ps, o, d, tl, cfg, (so, sd, stl))
        twophase_stages(card, "heavy bounce rays", ps, o, d, tl, cfg)

    kw = dict(K=cfg.tp_K, items_per_ray=cfg.tp_items_per_ray)
    ab_calls(card, "the captured heavy bounce rays", [
        ("classic K1", lambda: tr.closest_hit(ps, o, d, tl)),
        ("two-phase (K3 only)", lambda: ti.twophase_closest_with_fallback(
            ps, o, d, tl, dense=False, **kw)),
        ("two-phase (K3 + K6)", lambda: ti.twophase_closest_with_fallback(
            ps, o, d, tl, dense=True, **kw))])
    launches, _, acc = ab_samples(card, dev, "heavy scene", [
        ("off", cfg_off, env), ("auto", cfg, env),
        ("auto, RFW_TP_SHADOW=1 RFW_DENSE_ITEMS=1", cfg, tiers)],
        sample, counted="auto, RFW_TP_SHADOW=1 RFW_DENSE_ITEMS=1", n=HEAVY_SPP)
    log(card, f"phase 8 counted render: mean radiance {(acc / HEAVY_SPP).mean().item():.6f}")
    for k in ("closest", "occluded", "entries", "items_closest", "items_occluded",
              "dense_closest", "dense_occluded"):
        assert launches[k] > 0, f"the phase-8 path never launched {k}"
    return dict(K4=k4, launches=launches, fallback=fb, **rows)


def run_tool(card, main, argv):
    """Drive a tool's entry point; its one JSON line goes to the log."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        result = main([str(a) for a in argv])
    log(card, f"python -m {main.__module__} {' '.join(map(str, argv))}: {buf.getvalue().strip()}")
    return result


def sm_clock_mhz() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


SASS_OPS = ("LDG", "SHFL", "MUFU.RCP", "F2I", "FADD", "FMUL", "FFMA", "BRA")


def sass_census(card) -> dict:
    """Per kernel of the microbenchmarks, the count of each SASS opcode that
    carries the work they time (`cuobjdump -sass` of the built libraries):
    nvcc deletes work whose result is never stored, so this shows that the
    re-base, the leaf loop, the epilogue's division and the fetch chains
    are still in the code. Returns {kernel symbol: Counter}."""
    from rfw_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    census = {}
    for b in _build.build(["ubench_leaf", "ubench_grid"]):
        sass = subprocess.run([str(tool), "-sass", str(b.path)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        fn = None
        for line in sass.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                fn = m.group(1)
                census[fn] = Counter()
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if fn and m:
                op = m.group(1)
                census[fn][op.split(".")[0]] += 1
                if op.startswith("MUFU.RCP"):
                    census[fn]["MUFU.RCP"] += 1
    for fn, c in sorted(census.items()):
        log(card, f"SASS {fn}: " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS))
    return census


def check_sass(census: dict) -> None:
    """The census of each microbenchmark kernel holds the work it times."""
    def of(kernel, v):
        hits = [c for fn, c in census.items() if f"{kernel}ILi{v}E" in fn]
        assert len(hits) == 1, f"no single SASS function for {kernel}<{v}>: {list(census)}"
        return hits[0]

    leaf = [of("leaf_kernel", v) for v in range(5)]
    for v in (0, 1, 3):  # full, noselect, epilogue: the per-slot division
        assert leaf[v]["MUFU.RCP"] >= 1, f"U1 variant {v}: no division left"
    for v in (0, 1, 2):  # the record loads of the slot loop
        assert leaf[v]["LDG"] >= 3, f"U1 variant {v}: no record loads left"
    assert leaf[3]["SHFL"] >= 1, "U1 epilogue: the per-slot shuffle is gone"
    # fetch: the ray's own load, and the chain's load and float-to-int step
    assert leaf[4]["LDG"] >= 2 and leaf[4]["F2I"] >= 1, "U1 fetch: the chain is gone"
    grid = [of("grid_kernel", v) for v in range(4)]
    assert grid[0]["MUFU.RCP"] == 0, "U2 trivial re-bases rays"
    for v in (1, 2, 3):  # set_obj's three reciprocals
        assert grid[v]["MUFU.RCP"] >= 3, f"U2 variant {v}: the re-base is gone"
    assert grid[3]["LDG"] > grid[1]["LDG"], "U2 fetch8: the node fetches are gone"


def phase9(card, dev, ps, k1_primaries):
    """The microbenchmarks U1 and U2: every variant of each kernel against
    its plain version (U1 in one block and in a block per SM; U2 at 1 and
    512 tiles), then the counted run of their entry points (launch
    counters reset just before it, read just after), then the cost model
    of K1 on the primaries that they give."""
    from rfw_tpu_torch.tools import ubench_grid as ug
    from rfw_tpu_torch.tools import ubench_leaf as ul

    check_sass(sass_census(card))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tri, obj = ul.make_inputs()
    tris, obj = ul.to_records(torch.from_numpy(tri)).to(dev), torch.from_numpy(obj).to(dev)
    u1_err = 0.0
    for variant in ul.VARIANTS:
        ref = ul.leaf_plain(tris, obj, variant, U1_CMP_ITERS)
        for copies in (1, sms):
            got = ul.leaf(tris, obj, variant, U1_CMP_ITERS, copies)
            same = all(torch.equal(x, y.expand_as(x)) for x, y in zip(got, ref))
            err = max((got.t - ref.t).abs().max().item(),
                      float((got.aux - ref.aux).abs().max().item()))
            u1_err = max(u1_err, err)
            log(card, f"U1 {variant} kernel vs plain, {U1_CMP_ITERS} iterations, {copies} "
                      f"copies: max abs err {err:.3e}, identical {same}")
            assert same, f"U1 {variant} ({copies} copies): not identical to the plain version"
    ref, u1_plain_ms = timed(lambda: ul.leaf_plain(tris, obj, "full", U1_ITERS))
    got = ul.leaf(tris, obj, "full", U1_ITERS)
    same = all(torch.equal(x, y) for x, y in zip(got, ref))
    log(card, f"U1 full kernel vs plain, {U1_ITERS} iterations, one block: identical {same}, "
              f"plain {u1_plain_ms:.2f} ms")
    assert same, "U1 full: not identical to the plain version"

    u2_err, u2_plain_ms = 0.0, None
    for tiles in (1, U2_TILES[-1]):
        o, d = (torch.from_numpy(a).to(dev) for a in ug.make_rays(tiles))
        tl = torch.full((o.shape[0],), 1e26, dtype=torch.float32, device=dev)
        for variant in ug.VARIANTS:
            ref, plain_ms = timed(lambda: ug.grid_plain(ps, o, d, tl, variant))
            got = ug.grid(ps, o, d, tl, variant)
            same = all(torch.equal(x, y) for x, y in zip(got, ref))
            err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, ref))
            u2_err = max(u2_err, err)
            log(card, f"U2 {variant} kernel vs plain, {tiles} tiles: all five outputs "
                      f"identical {same}, max abs err {err:.3e}, plain {plain_ms:.3f} ms")
            assert same, f"U2 {variant} ({tiles} tiles): not identical to the plain version"
            if variant == "trivial":
                u2_plain_ms = plain_ms

    # ---- the counted run: the tools' entry points as a user runs them
    reset_launches()
    leaf1 = run_tool(card, ul.main, ["--iters", U1_ITERS, "--reps", U1_REPS, "--copies", 1])
    clock = sm_clock_mhz()
    leafn = run_tool(card, ul.main, ["--iters", U1_ITERS, "--reps", U1_REPS, "--copies", sms])
    grid = run_tool(card, ug.main, ["--tiles", *U2_TILES, "--reps", U2_REPS])
    launches = read_launches()
    for k in ("leaf", "grid"):
        assert launches[k] > 0, f"the microbenchmark run never launched the {k} kernel"

    log(card, f"SM clock after U1 in one block (now, max) MHz: {clock}")
    for v in ul.VARIANTS:
        log(card, f"U1 {v:9s}: {leaf1['us_per_iter'][v]:9.4f} us/iter in one block, "
                  f"{leafn['us_per_iter'][v]:9.4f} us/iter in {sms} blocks "
                  f"({leafn['us_per_iter'][v] * 1e3 / (sms * ul.RAYS):.5f} ns per ray-iteration)")
    res = grid["results"]
    for tiles in U2_TILES:
        log(card, f"U2 at {tiles} tiles ({tiles * ug.TILE_RAYS} rays), us per launch "
                  f"(device; host) and per tile: " + ", ".join(
                      f"{v} {r['launch_us']:.3f}; {r['host_us']:.3f} ({r['tile_us']:.4f})"
                      for v, r in res[str(tiles)].items()))

    # ---- K1's time on the primaries, split by the cost model
    full_rays = U2_TILES[-1] * ug.TILE_RAYS
    top = res[str(U2_TILES[-1])]
    slot_us = leafn["us_per_iter"]["full"] / (sms * ul.RAYS * 64)
    n = k1_primaries["rays"]
    shape_ms = top["init"]["launch_us"] / 1e3 * n / full_rays
    own = k1_primaries["kernel_counts"]
    for whose, c in (("the plain walk's", k1_primaries), ("the kernel's own", own)):
        leaf_ms = c["tris"] * slot_us / 1e3
        node_ms = c["boxes"] * slot_us * FLOP_PER_BOX / FLOP_PER_TRI / 1e3
        rest = k1_primaries["ms"] - shape_ms - leaf_ms - node_ms
        log(card, f"K1 on the {n} primaries, {k1_primaries['ms']:.4f} ms, by {whose} counts: "
                  f"call shape (U2 init, scaled to {n} rays) {shape_ms:.4f} ms; leaf tests "
                  f"{leaf_ms:.4f} ms ({c['leaves']} leaf visits, {c['tris']} slot tests x "
                  f"{slot_us * 1e6:.3f} ps, U1 full at {sms} blocks / 64 slots); node visits "
                  f"{node_ms:.4f} ms ({c['boxes']} box tests at {FLOP_PER_BOX}/"
                  f"{FLOP_PER_TRI} of a slot test); remainder (fetch latency, divergence) "
                  f"{rest:.4f} ms ({100 * rest / k1_primaries['ms']:.1f}%)")

    u1_ops = ul.RAYS * 64 * FLOP_PER_TRI * U1_ITERS
    u1 = dict(call=f"full, {U1_ITERS} iterations, one block", ms=leaf1["ms_per_call"]["full"],
              plain_ms=u1_plain_ms, bound_ms=u1_ops / (FP32_FLOP_PER_S / sms) * 1e3,
              bound_by="operations", max_abs_err=u1_err)
    u2 = dict(call=f"trivial, {U2_TILES[-1]} tiles", ms=top["trivial"]["launch_us"] / 1e3,
              plain_ms=u2_plain_ms, bound_ms=full_rays * (4 + 20) / HBM_BYTES_PER_S * 1e3,
              bound_by="bytes", max_abs_err=u2_err)
    return dict(U1=[u1], U2=[u2], launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = card_line()
    log(card, f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 1. build the kernels from the checkout's sources
    from rfw_tpu_torch.ops import _build
    from rfw_tpu_torch.ops import traverse as tr

    t0 = time.perf_counter()
    built = _build.build()
    for b in built:
        _build.load_library(b.name)
    log(card, f"kernel build: {time.perf_counter() - t0:.2f} s in all, one nvcc per source in "
              f"parallel ({', '.join(f'{b.name} {b.seconds:.2f} s' for b in built)})")
    for b in built:
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(card, f"ptxas {b.name}: " + line.strip())
    from rfw_tpu_torch.ops import traverse_entries as te
    from rfw_tpu_torch.ops import traverse_items as ti
    from rfw_tpu_torch.render.wavefront import RenderConfig

    tp_k = RenderConfig().tp_K
    for stats in (False, True):
        for name, query in (("K1", lambda c: tr.launch_shape(False, c, W * H)),
                            ("K2", lambda c: tr.launch_shape(True, c, W * H)),
                            ("K3", lambda c: ti.launch_shape(False, c, W * H)),
                            ("K5", lambda c: ti.launch_shape(True, c, W * H)),
                            (f"K4 (K={tp_k})", lambda c: te.launch_shape(tp_k, c, W * H))):
            s = query(stats)
            theory, _ = occupancy(s)
            log(card, f"{name}{' counting instance' if stats else ''}: "
                      f"{s['registers']} registers, {s['local_bytes']} B local, "
                      f"{s['shared_bytes']} B shared per block of {s['block']}, "
                      f"{s['blocks_per_sm']} blocks per SM on {s['sms']} SMs -> theoretical "
                      f"occupancy {theory:.3f}; {s['grid']} blocks launched for {W * H} rays")

    # ---- 2. scene
    from rfw_tpu_torch.convert import from_numpy_scene
    from rfw_tpu_torch.render.film import add_sample, new_film, tonemap
    from rfw_tpu_torch.render.wavefront import mat_feature_mask, render_sample, tex_kinds_mask
    from rfw_tpu_torch.scenes import build_scene

    t0 = time.perf_counter()
    scene_np, mats_np, lights_np, atlas_np, camera, pack_s = build_scene(SEED)
    scene, mats, lights, atlas = from_numpy_scene(scene_np, mats_np, lights_np, atlas_np, dev)
    torch.cuda.synchronize()
    log(card, f"scene: {scene_np.tri_v0.shape[0]} triangle rows, "
              f"{int((scene_np.inst_mesh >= 0).sum())} instances "
              f"({scene_np.inst_matrix.shape[0]} rows), "
              f"{sum(a.nbytes for a in scene_np) / 1e6:.1f} MB TraceScene, "
              f"pack {pack_s:.2f} s, build+upload {time.perf_counter() - t0:.2f} s")
    ps = tr.prepare_scene(scene)
    log(card, f"prepared traversal arrays: {sum(t.numel() * t.element_size() for t in ps[:4]) / 1e6:.1f} MB")

    # ---- 3. kernels against their plain versions
    view_full = torch.from_numpy(camera.get_view(W, H).as_array()).to(dev)
    cmp = compare_rays(card, ps, view_full, dev, SEED)

    # ---- 4. render through the kernels vs through the plain traversal
    base = dict(max_bounces=BOUNCES, clamp=20.0, sky_intensity=0.35, sampler="sobol",
                two_phase="off", aovs=False, sort_secondary=True,
                tex_mask=tex_kinds_mask(mats_np.tex), mat_features=mat_feature_mask(mats_np),
                has_area_lights=bool(lights_np.n_area[0] > 0))
    sw, sh = 256, 144
    view_small = torch.from_numpy(camera.get_view(sw, sh).as_array()).to(dev)
    r_k = render_sample(scene, mats, atlas, lights, view_small, sw, sh,
                        RenderConfig(**base), sample_index=1).radiance
    r_l = render_sample(scene, mats, atlas, lights, view_small, sw, sh,
                        RenderConfig(traversal="lockstep", **base), sample_index=1).radiance
    err = (r_k - r_l).abs()
    px_ok = (err <= 1e-3 + 1e-3 * r_l.abs()).all(dim=1).float().mean().item()
    log(card, f"render {sw}x{sh} 1 spp, kernel vs lockstep: {px_ok:.6f} of pixels within "
              f"1e-3 abs + 1e-3 rel, max abs err {err.max().item():.3e}, "
              f"mean {r_k.mean().item():.6f} vs {r_l.mean().item():.6f}")
    assert bool(torch.isfinite(r_k).all()), "non-finite radiance (kernel render)"
    assert px_ok >= 0.995, f"kernel and lockstep renders agree on only {px_ok} of pixels"

    # ---- 5. the main path at 1920x1080
    cfg = RenderConfig(**base)

    def sample(s):
        return render_sample(scene, mats, atlas, lights, view_full, W, H, cfg, sample_index=s)

    # warm-up sample, its traversal inputs captured; the kernels against
    # their plain versions on exactly those inputs
    calls = capture_traversal(lambda: sample(0))
    main_rows = compare_main_path(card, calls)
    assert set(main_rows) == {"closest", "occluded"}, f"traversal calls seen: {list(main_rows)}"
    del calls
    torch.cuda.synchronize()
    film = new_film(W, H, device=dev)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for s in range(SPP):
        add_sample(film, sample(s + 1).radiance)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: read_launches()[k] for k in tr.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    frame = tonemap(film, SPP, W, H)
    torch.cuda.synchronize()
    mrays = W * H * SPP * 2 * (BOUNCES + 1) / dt / 1e6
    log(card, f"main path {W}x{H} {BOUNCES}-bounce+NEE, {SPP} samples: {mrays:.3f} Mrays/s, "
              f"{dt / SPP * 1e3:.2f} ms/sample, peak memory {peak / 2**30:.3f} GiB "
              f"({peak} B), launches {launches}")
    radiance = film / SPP
    mean = radiance.mean().item()
    log(card, f"film: mean radiance {mean:.6f}, frame {tuple(frame.shape)} {frame.dtype}, "
              f"mean 8-bit value {frame[..., :3].float().mean().item():.3f}")
    assert bool(torch.isfinite(film).all()), "non-finite radiance in the film"
    assert mean > 0.0, "black film"
    assert tuple(frame.shape) == (H, W, 4) and frame.dtype == torch.uint8
    for k, n in launches.items():
        assert n > 0, f"the main path never launched the {k} kernel"

    # ---- 6. where the time goes
    stage_breakdown(card, lambda: sample(SPP + 1))
    profile_sample(card, lambda: sample(SPP + 2))
    busy_share(card, lambda s: sample(SPP + 3 + s), 4)

    # ---- 7. two-phase on the flagship scene
    tp = phase7(card, dev, scene, mats, atlas, lights, view_full, ps, base)

    # ---- 8. the instance-heavy scene
    heavy = phase8(card, dev, base)

    # ---- 9. the microbenchmarks U1 and U2
    ubench = phase9(card, dev, ps, main_rows["closest"][0])

    def row(name, source, replaces, launches, rows, extra_err=(), **extra):
        b = max(rows, key=lambda r: r["bound_ms"]) if rows else None
        if rows and all("bound_ms_plain_counts" in r for r in rows):  # the walks K1-K5
            extra["bound_ms_plain_counts"] = sum(r["bound_ms_plain_counts"] for r in rows)
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches,
                    max_abs_err=max([*extra_err, *(r["max_abs_err"] for r in rows)]),
                    ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
                    bound_ms=sum(r["bound_ms"] for r in rows),
                    bound_by=b["bound_by"] if b else None, library_ms=None, calls=rows,
                    **extra)

    def fallback(kind):
        return [r for fb in (tp["fallback"], heavy["fallback"]) for r in fb[kind]]

    def walk_row(name, kind, cmp_err):
        rows = main_rows[kind]
        return row(name, "rfw_tpu_torch/csrc/traverse.cu", "rfw_tpu/ops/traverse.py:335",
                   launches[kind], rows,
                   [cmp_err, *(r["max_abs_err"] for r in fallback(kind))],
                   fallback_calls=fallback(kind))

    items_src = "rfw_tpu_torch/csrc/traverse_items.cu"
    kernels = [
        walk_row("K1 closest_hit", "closest", cmp["K1"]),
        walk_row("K2 occluded", "occluded", cmp["K2"]),
        row("K3 items closest", items_src, "rfw_tpu/ops/traverse_items.py:107",
            tp["launches"]["items_closest"], tp["K3"], [r["max_abs_err"] for r in heavy["K3"]]),
        row("K5 items any-hit", items_src, "rfw_tpu/ops/traverse_items.py:107",
            heavy["launches"]["items_occluded"], heavy["K5"],
            [r["max_abs_err"] for r in tp["K5"]]),
        row("K4 tlas_entries", "rfw_tpu_torch/csrc/traverse_entries.cu",
            "rfw_tpu/ops/traverse_entries.py:53", heavy["launches"]["entries"], heavy["K4"],
            [r["max_abs_err"] for r in tp["K4"]]),
        row("K6 dense items (closest + any-hit)", items_src, "rfw_tpu/ops/traverse_items.py:527",
            heavy["launches"]["dense_closest"] + heavy["launches"]["dense_occluded"],
            heavy["K6"]),
        row("U1 ubench_leaf", "rfw_tpu_torch/csrc/ubench_leaf.cu", "tools/ubench_leaf.py:51",
            ubench["launches"]["leaf"], ubench["U1"]),
        row("U2 ubench_grid", "rfw_tpu_torch/csrc/ubench_grid.cu", "tools/ubench_grid.py:60",
            ubench["launches"]["grid"], ubench["U2"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
