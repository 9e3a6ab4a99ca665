"""Smoke check of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives rfw_tpu_torch's main paths — one progressive path-traced sample per
call of `render_sample`, 1920x1080, 1 bounce + next-event estimation, Sobol
sampler, film accumulation and tonemap — on a procedural scene at the
flagship scene's scale (4 icosphere meshes of 20,480 triangles, 256
instances, textured floor, area + spot + sun lights; made from a seed),
with two_phase="off" (every ray through the classic kernel) and with the
default two_phase="auto" (bounce rays through the two-phase path), and on
an instance-heavy scene of 10,000 instances; then drives the same scene
through the backend a user calls, `TorchBackend`.

Phases (any failed check raises, so the script exits nonzero):
  1. set-up: needs CUDA; builds the CUDA kernels from rfw_tpu_torch/csrc,
     one nvcc per source, all at once; prints ptxas's registers and spills
     and the launch shape (registers, resident blocks, theoretical
     occupancy) of each kernel K1-K6 and of its counting instance;
  2. scene build and upload;
  3. K1/K2 against their plain torch version on 65,536 rays (compare_call:
     K2's flags identical; K1, which takes children nearest first, under
     its gate: hit masks identical, t bit-identical but for at most 1 in
     10^5 rays within 1e-5 relative, prim/inst/u/v bit-identical but for
     counted exact-t ties), each wrapper call counting one launch of its
     kind, the counting instance giving the same result, with its per-ray
     counts (check_counts: a node visit per ray, at most 8 box tests a
     visit and 64 slot tests a leaf, a span per launched warp) beside the
     plain walk's, the SIMD efficiency of the launch order, the longest
     ray and the achieved occupancy; and K1's tie rule on two coplanar
     quads in different treelets (tie_between_treelets);
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
     fallbacks retrace, K2 also on the rays that a two-phase any-hit call
     with a small item buffer leaves undecided (compare_undecided), K3
     and K5 against their plain versions on exactly
     those items (compare_items: K5's flags identical; K3, nearest first,
     under K1's gate over the live slots; both with the counts, SIMD
     efficiency, occupancy and bound of compare_call), the whole
     two-phase call against the classic kernel, its stages, K4 against its
     plain version on the same rays (compare_entries: t_entry
     bit-identical, ids up to counted equal-t swaps at the K-th kept t,
     also with lists of 1 and 8 entries; counts as above) and the stages
     with phase A by K4
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
     their plain versions on one sample's captured inputs (K6 bit for bit,
     with its box and slot tests beside the plain version's, its
     registers and achieved occupancy, the padding share of the plain
     version's slot tests, and K3/K5 timed on K6's own items as its
     yardstick) and the stages
     of the two-phase call; then the A/B in turns: classic K1 against the
     two-phase call with and without K6 on the captured bounce rays, and
     ms per sample of "off", "auto", and "auto" with both switches set,
     whose first turn is the counted run (every kernel must launch);
  9. the microbenchmarks of rfw_tpu_torch.tools: U1 (the leaf-test stages)
     in every variant against its plain version in one block and in a
     block per SM (identical; `fused` and `staged`, the slot test in the
     reference tool's arithmetic in K1's leaf loop and in U1's own staged
     loop, also at 512 iterations, within 3e-5 relative on all but at
     most 4 rays of a copy, copies and aux identical), U2 (K1's
     call shape without the walk) in every variant against its plain
     version at 1 and 512 tiles; then the counted run of their entry
     points (U1 in one block and in a block per SM, U2 over 1, 8, 64 and
     512 tiles with K1 on the same rays), and K1's time on the 1080p
     primaries split by the cost model they give (call shape, leaf tests,
     node visits, remainder), once by the plain walk's counts and once by
     the kernel's own, and its leaf tests priced at U1 fused's rate; the
     SASS of U1 full's, fused's and staged's per-slot loops (instructions
     per slot test, by opcode, beside the 44 fp32 operations the bound
     counts) and the time issuing them takes; and the SASS of K1-K6, whose
     slot loops must keep the exact division (each instance's loop and a
     digest of its code are printed);
 10. the backend on the card: TorchBackend(1920, 1080) on the flagship
     scene fed through the 14-method contract (Mesh3D.view() meshes,
     instances, materials, textures, spot, sun and area lights), phase 5's
     settings with two_phase="auto": its first pack equals build_scene's
     field for field, its first frame launches K1, K2 and K3 (counters
     reset just before it, read just after), its first HDR frame equals
     render_sample at sample 0 on its own tensors, tonemap(fxaa=True) on
     the card agrees with the CPU on the same accumulator (99.9% of
     pixels within 1); then 4 progressive frames (ms, Mrays/s), a motion
     sync of the 256 sphere instances against a full repack (the same
     arenas either way), a NORMAL frame and a frame with a quad2d overlay.
The tests that need a card (tests/test_torch_*.py, `*_on_card`) cannot run
where the card is (their conftest imports jax); these phases make their
checks (.claude/skills/verify/SKILL.md maps each test to its phase).
Every number is printed beside the card's name and power limit. The line
before the last two is {"kernels": [...]}: per kernel, its launches in its
path's counted run, its largest disagreement with the plain version, its
time and the plain version's per 1080p sample (the sum over the sample's
calls, each timed on that call's captured inputs; for U1 one call of
`full` at 512 iterations in one block, with `fused`'s and `staged`'s
beside it, for U2 one `trivial` launch at 512 tiles), the least time the
card could take for the same work (bytes over 3.35 TB/s or fp32
operations over 67 TFLOP/s, whichever is larger; U1's
operations over the fp32 peak of the one SM it occupies; K1-K5's
operations by whichever of the kernel's walk and the plain walk made
fewer, the plain walk's alone in bound_ms_plain_counts; K6's by its own
counts and by the plain version's likewise) and which of the two bounds
it; no single PyTorch call computes a BVH traversal or either
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
# U1 `fused` and `staged` against their plain version, which cannot round the card's
# MUFU.RCP alike: t within this relative error but on at most this many of
# a copy's 1,024 rays (tests/test_torch_ubench.py's tolerance)
U1_FUSED_REL, U1_FUSED_LANES = 3e-5, 4
U2_TILES, U2_REPS = (1, 8, 64, 512), 3
# item buffer of the forced two-phase any-hit call whose undecided rays K2
# retraces (phase 7): small enough that rays lose items
UNDECIDED_ITEMS_PER_RAY = 0.05

# the card's peaks for the bound (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# fp32 operations per unit of work, counted from csrc/bvh_common.cuh: one
# child slab test (6 sub, 6 mul, 10 min/max, 3 compares) and one Woop slot
# test (6 dot products of 5, 3 adds, 1 div, 2 mul + 2 add, 6 compares)
FLOP_PER_BOX = 25
FLOP_PER_TRI = 44
# warp instructions an H100 SM issues a clock (4 sub-partitions, one each)
WARP_ISSUE_PER_CLOCK = 4


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


def tie_between_treelets(card, dev) -> None:
    """K1 on two coplanar copies of a quad, each its own mesh and treelet,
    against one copy alone, for rays from either side: every ray hits, t,
    u and v bit-identical to the one copy's, prim that copy's triangle in
    whichever copy won, inst naming that copy."""
    from rfw_tpu_torch.convert import to_tensor
    from rfw_tpu_torch.models.primitives import quad3d
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.render.pack import TraceScene, pack_trace_scene

    def quads(n):
        meshes = [(k, quad3d(normal=(0, 1, 0), position=(0, 0, 0), width=2, height=2), None)
                  for k in range(n)]
        scene = pack_trace_scene(meshes, [(k, np.eye(4, dtype=np.float32)[None])
                                          for k in range(n)])
        return scene, tr.prepare_scene(TraceScene(*[to_tensor(getattr(scene, f), dev)
                                                    for f in TraceScene._fields]))

    rng = np.random.default_rng(11)
    (_, one_ps), (two_scene, two_ps) = quads(1), quads(2)
    lo1 = int(two_scene.mesh_tri_range[1, 0])
    for side in (1.0, -1.0):
        xz = rng.uniform(-0.9, 0.9, (64, 2)).astype(np.float32)
        o = torch.from_numpy(np.stack([xz[:, 0], np.full(64, side, np.float32), xz[:, 1]], 1))
        d = torch.from_numpy(np.tile(np.array([[0.0, -side, 0.0]], np.float32), (64, 1)))
        o, d = o.to(dev), d.to(dev)
        one, two = tr.closest_hit(one_ps, o, d), tr.closest_hit(two_ps, o, d)
        copy = (two.prim >= lo1).to(torch.int32)
        ok = (bool((one.prim >= 0).all())
              and torch.equal(one.t.view(torch.int32), two.t.view(torch.int32))
              and torch.equal(one.u, two.u) and torch.equal(one.v, two.v)
              and torch.equal(two.prim - copy * lo1, one.prim) and torch.equal(two.inst, copy))
        log(card, f"K1 tie between treelets, rays from side {side:+.0f}: 64 rays, the second "
                  f"copy won {int(copy.sum())}, tie rule held {ok}")
        assert ok, f"K1 tie between treelets (side {side}): the tie rule failed"


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


def launched_once(counts: dict, kind: str, fn):
    """fn()'s result, holding that it added one launch to the wrapper's
    count counts[kind] and none to another kind."""
    before = dict(counts)
    out = fn()
    assert counts == {**before, kind: before[kind] + 1}, \
        f"one {kind} call counted {counts} after {before}"
    return out


def check_counts(tag, ks, shape, live, kind="walk"):
    """The counting instance's invariants: one warp_ns row per launched
    warp (shape: its launch shape), each written, its end at or after its
    start; rows outside the mask `live` (empty slots, dead lanes) count
    nothing; no leaf visit tests more than its 64 slots. A walk ("walk",
    K1-K5) visits a node for every live row and tests at most 8 boxes a
    visit; K6 ("dense") visits no node and tests a treelet only after its
    box."""
    assert ks.warp_ns.shape == (shape["grid"] * shape["block"] // 32, 2), \
        f"{tag}: warp_ns {tuple(ks.warp_ns.shape)} for the launch {shape}"
    assert bool((ks.warp_ns[:, 0] > 0).all()) and bool(
        (ks.warp_ns[:, 1] >= ks.warp_ns[:, 0]).all()), f"{tag}: a warp span is missing"
    for k in ("nodes", "boxes", "leaves", "tris"):
        assert not bool(getattr(ks, k)[~live].any()), f"{tag}: an empty row counts {k}"
    assert bool((ks.tris <= 64 * ks.leaves).all()), f"{tag}: a leaf tests over 64 slots"
    if kind == "walk":
        assert bool((ks.nodes[live] >= 1).all()), f"{tag}: a live row visits no node"
        assert bool((ks.boxes <= 8 * ks.nodes).all()), f"{tag}: over 8 box tests a visit"
    else:
        assert not bool(ks.nodes.any()), f"{tag}: K6 visits a node"
        assert bool((ks.leaves <= ks.boxes).all()), f"{tag}: a leaf test without its box"


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
        got = launched_once(tr.LAUNCHES, kind, lambda: fn(ps, o, d, tl))
        err = check_hits(card, tag, got, ref, exact="nearest")
        got_s, ks = fn(ps, o, d, tl, stats=True)
        same = all(torch.equal(a, b) for a, b in zip(got_s, got))
    else:
        name, fn, out_b = "K2", tr.occluded, 1
        ref, plain_ms = timed(lambda: tr.occluded_plain(ps, o, d, tl, stats=stats))
        got = launched_once(tr.LAUNCHES, kind, lambda: fn(ps, o, d, tl))
        err = check_occluded(card, tag, got, ref)
        got_s, ks = fn(ps, o, d, tl, stats=True)
        same = torch.equal(got_s, got)
    assert same, f"{name} ({tag}): the counting instance gives another result"
    ms = cuda_ms(lambda: fn(ps, o, d, tl), reps)
    shapes = [tr.launch_shape(kind == "occluded", c, n) for c in (False, True)]
    check_counts(f"{name} ({tag})", ks, shapes[1], torch.ones_like(tl_t, dtype=torch.bool))
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


def compare_undecided(card, scene_label, ps, o, d, tl, K, items_per_ray):
    """K2 against its plain version on rays that a two-phase any-hit call
    leaves undecided: with a small item buffer (items_per_ray) rays lose
    items, and those their kept instances do not occlude are undecided,
    so the fallback retraces them with K2; their count is printed and must
    be positive, and K2 is held on exactly the rays the fallback retraces
    (compare_call). Returns K2's rows."""
    from rfw_tpu_torch.ops import traverse_items as ti

    _, undecided = ti.twophase_occluded_fused(ps, o, d, tl, K=K, items_per_ray=items_per_ray)
    n_und = int(undecided.sum())
    log(card, f"{scene_label} two-phase any-hit call at {items_per_ray} items per ray: "
              f"{n_und} of {o.shape[0]} rays undecided, the fallback retraces "
              f"{min(n_und, ti.fallback_capacity(o.shape[0]))}")
    assert n_und > 0, f"{scene_label}: no undecided ray at {items_per_ray} items per ray"
    calls = []

    def record(ps_, ro, rd, rtl):
        calls.append((ro.clone(), rd.clone(), rtl.clone()))
        return tr_occluded(ps_, ro, rd, rtl)

    tr_occluded = ti.occluded
    with patched(ti, occluded=record):
        ti.twophase_occluded_with_fallback(ps, o, d, tl, K=K, items_per_ray=items_per_ray)
    assert len(calls) == 1, f"{scene_label}: {len(calls)} fallback calls"
    return [compare_call(card, f"{scene_label} undecided shadow fallback", "occluded", ps,
                         *calls[0])]


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
    identical). The wrapper counts one launch of its kind; the counting
    instance gives the same result, and its per-item counts stand beside
    the plain version's (walk_counts; check_counts). Kernel time by CUDA
    events over 10 launches, plain time of the compared call, and the
    bound from the bytes the kernel touches (a live item reads its
    instance, o, d and t_limit, 32 B; an empty slot reads its instance,
    and its t_limit for closest hits; every slot writes 20 B of hit or 1 B
    of flag), the scene arrays it reads once (K6: the real slots and the
    36 B table row of each treelet of the items' meshes, the instance rows
    and treelet ranges) and the test counts of whichever made fewer
    operations. K6 also gets its yardstick: K3 (K5 for any hit) timed on
    the same items, held against K6's plain version under K3's gate (K5:
    flags identical); and the share of the plain version's slot tests
    that are padding, over the items' mesh spans."""
    from rfw_tpu_torch.ops import traverse_items as ti

    fn, plain = (ti.dense_items, ti.dense_items_plain) if dense else (ti.items, ti.items_plain)
    kind = f"{'dense' if dense else 'items'}_{'occluded' if any_hit else 'closest'}"
    stats = {}
    ref, plain_ms = timed(lambda: plain(ps, inst, o, d, tl, any_hit, stats=stats))
    got = launched_once(ti.LAUNCHES, kind, lambda: fn(ps, inst, o, d, tl, any_hit))
    live_k = inst >= 0
    n, live = inst.shape[0], int(live_k.sum())
    if any_hit:
        err = check_occluded(card, label, got, ref, name=f"{name} kernel vs plain", live=live_k)
    else:
        err = check_hits(card, label, got, ref, name=f"{name} kernel vs plain",
                         exact=True if dense else "nearest", live=live_k)
    ms = cuda_ms(lambda: fn(ps, inst, o, d, tl, any_hit), 10)
    if dense:
        # the real slots and table rows of the treelets of the items'
        # meshes, the instance rows and treelet ranges
        iid = inst[live_k].long()
        spans = torch.unique(torch.stack([ps.tlo[iid], ps.thi[iid]], 1), dim=0)
        csum = torch.cat([ps.tcount.new_zeros(1), torch.cumsum(ps.tcount, 0)]).long()
        real = int((csum[spans[:, 1].long()] - csum[spans[:, 0].long()]).sum())
        treelets = int((spans[:, 1] - spans[:, 0]).sum())
        scene_b = real * 64 + treelets * 36 + nbytes(ps.insts, ps.tlo, ps.thi)
    else:
        scene_b = nbytes(ps.nodes, ps.tris, ps.insts, ps.roots)
    out_b = 1 if any_hit else 20
    item_b = live * (32 + out_b) + (n - live) * ((4 if any_hit else 8) + out_b)
    head = (f"{name} {label}: {n} item slots ({live} items), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms")
    got_s, ks = fn(ps, inst, o, d, tl, any_hit, stats=True)
    same = torch.equal(got_s, got) if any_hit else all(
        torch.equal(a, b) for a, b in zip(got_s, got))
    assert same, f"{name} ({label}): the counting instance gives another result"
    shape_fn = ti.dense_launch_shape if dense else ti.launch_shape
    shapes = [shape_fn(any_hit, c, n) for c in (False, True)]
    check_counts(f"{name} ({label})", ks, shapes[1], live_k, "dense" if dense else "walk")
    row = walk_counts(card, f"{name} {label}", ks, stats, item_b + scene_b, shapes)
    log(card, f"{head}, {bound_note(row)}; {item_b} B of items, {scene_b} B of scene")
    out = dict(call=label, items=live, slots=n, ms=ms, plain_ms=plain_ms, max_abs_err=err, **row)
    if dense:
        out.update(dense_yardstick(card, name, label, any_hit, ps, inst, o, d, tl, ref, ks))
    return out


def dense_yardstick(card, name, label, any_hit, ps, inst, o, d, tl, ref, ks) -> dict:
    """K6's yardstick and padding: K3 (K5) on K6's items against K6's plain
    result `ref` and timed; the padding share of the plain version's slot
    tests over the items' mesh spans; the SIMD efficiency of K6's slot
    tests in the launch order (ks: its counts): the slot tests over 32 x
    each warp's largest."""
    from rfw_tpu_torch.ops import traverse_items as ti

    live_k = inst >= 0
    walk_name = "K5" if any_hit else "K3"
    walk = ti.items(ps, inst, o, d, tl, any_hit)
    if any_hit:
        check_occluded(card, label, walk, ref, name=f"{walk_name} on K6's items vs K6's plain",
                       live=live_k)
    else:
        check_hits(card, label, walk, ref, name=f"{walk_name} on K6's items vs K6's plain",
                   exact="nearest", live=live_k)
    walk_ms = cuda_ms(lambda: ti.items(ps, inst, o, d, tl, any_hit), 10)
    iid = inst[live_k].long()
    csum = torch.cat([ps.tcount.new_zeros(1), torch.cumsum(ps.tcount, 0)]).long()
    real = int((csum[ps.thi[iid].long()] - csum[ps.tlo[iid].long()]).sum())
    padded = 64 * int((ps.thi[iid] - ps.tlo[iid]).sum())
    pad_share = 1.0 - real / max(padded, 1)
    tris = ks.tris.long()
    pad = (-tris.numel()) % 32
    per_warp = torch.cat([tris, tris.new_zeros(pad)]).view(-1, 32).amax(dim=1)
    slot_eff = tris.sum().item() / max(32 * per_warp.sum().item(), 1)
    log(card, f"{name} {label}: yardstick {walk_name} on the same items {walk_ms:.4f} ms; "
              f"padding {100 * pad_share:.1f}% of the plain version's {padded} slot tests over "
              f"the items' mesh spans ({real} real slots); SIMD efficiency of K6's slot tests "
              f"in the launch order {slot_eff:.4f}")
    return dict(yardstick=walk_name, yardstick_ms=walk_ms, padding_share=pad_share,
                slot_simd_efficiency=slot_eff)


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


def compare_entries(card, label, ps, o, d, tl, K, other_k=()):
    """K4 against its plain version on captured rays (check_entries), also
    at each list length of `other_k` (the check alone); each call counts
    one launch; the counting instance gives the same result, and its
    per-ray counts stand beside the plain walk's (walk_counts;
    check_counts). Kernel time by CUDA events over 10 launches, plain time
    of the compared call, and the bound from the rays' bytes (28 B in, 8K
    out), the TLAS rows once and the box tests of whichever walk made
    fewer."""
    from rfw_tpu_torch.ops import traverse_entries as te

    for k in other_k:
        got = launched_once(te.LAUNCHES, "entries", lambda: te.tlas_entries(ps, o, d, tl, k))
        check_entries(card, f"{label}, K={k}", got, te.tlas_entries_plain(ps, o, d, tl, k), k)
    stats = {}
    ref, plain_ms = timed(lambda: te.tlas_entries_plain(ps, o, d, tl, K, stats=stats))
    got = launched_once(te.LAUNCHES, "entries", lambda: te.tlas_entries(ps, o, d, tl, K))
    err = check_entries(card, label, got, ref, K)
    got_s, ks = te.tlas_entries(ps, o, d, tl, K, stats=True)
    assert all(torch.equal(a, b) for a, b in zip(got_s, got)), \
        f"K4 ({label}): the counting instance gives another result"
    ms = cuda_ms(lambda: te.tlas_entries(ps, o, d, tl, K), 10)
    n = o.shape[0]
    live = int((tl > 0).sum())
    tlas_b = (ps.nodes.shape[0] - ps.tlas_root) * ps.nodes.shape[1] * 4
    shapes = [te.launch_shape(K, c, n) for c in (False, True)]
    check_counts(f"K4 ({label})", ks, shapes[1], tl > 0)
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
    fb["occluded"] += compare_undecided(card, "flagship", ps, so, sd, stl, cfg.tp_K,
                                        UNDECIDED_ITEMS_PER_RAY)
    _, inst, o_s, d_s, tl_s, _ = packed_items(ps, o, d, tl, cfg.tp_K, cfg.tp_items_per_ray)
    k3 = compare_items(card, "K3", "bounce closest items", False, False, ps, inst, o_s, d_s, tl_s)
    _, inst, o_s, d_s, tl_s, _ = packed_items(ps, so, sd, stl, cfg.tp_K, cfg.tp_items_per_ray)
    k5 = compare_items(card, "K5", "bounce shadow items", False, True, ps, inst, o_s, d_s, tl_s)
    twophase_vs_classic(card, "flagship bounce rays", ps, o, d, tl, cfg, (so, sd, stl))
    twophase_stages(card, "flagship bounce rays", ps, o, d, tl, cfg)
    with patched(ti, DENSE_A_MAX_INST=0):
        k4 = compare_entries(card, "flagship bounce rays", ps, o, d, tl, cfg.tp_K, (1, 8))
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


SASS_OPS = ("LDG", "LDS", "SHFL", "MUFU.RCP", "FCHK", "F2I", "FADD", "FMUL", "FFMA", "BRA")
UBENCH_LIBS = ("ubench_leaf", "ubench_grid")
WALK_LIBS = ("traverse", "traverse_items", "traverse_entries")


def sass_census(card, names=UBENCH_LIBS + WALK_LIBS):
    """Per kernel of the named libraries, the count of each SASS opcode
    (`cuobjdump -sass` of the built libraries): nvcc deletes work whose
    result is never stored, so this shows that the re-base, the leaf loop,
    the epilogue's division and the fetch chains of the microbenchmarks
    are still in the code, and that the walks keep their exact division.
    Logs the microbenchmarks' censuses. Returns ({kernel symbol: Counter},
    {kernel symbol: [(address, opcode, branch target or None)]}, {kernel
    symbol: sha256 of its instruction lines})."""
    import hashlib

    from rfw_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    census, listing, labels, text = {}, {}, {}, {}
    for b in _build.build(list(names)):
        sass = subprocess.run([str(tool), "-sass", str(b.path)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        fn = None
        for line in sass.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                fn = m.group(1)
                census[fn], listing[fn], labels[fn], text[fn] = Counter(), [], {}, []
                continue
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if fn and m:  # a label names the next instruction
                labels[fn][m.group(1)] = len(listing[fn])
                continue
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*)",
                          line)
            if fn and m:
                op = m.group(2)
                text[fn].append(line.strip())
                census[fn][op.split(".")[0]] += 1
                if op.startswith("MUFU.RCP"):
                    census[fn]["MUFU.RCP"] += 1
                target = None
                if op.split(".")[0] == "BRA":  # an address or a label
                    t = re.search(r"0x([0-9a-f]+)|\((\.L_x_\d+)\)", m.group(3))
                    target = t and (int(t.group(1), 16) if t.group(1) else t.group(2))
                listing[fn].append((int(m.group(1), 16), op, target))
    for fn, insts in listing.items():  # labels -> the addresses they name
        at = {name: insts[i][0] for name, i in labels[fn].items() if i < len(insts)}
        listing[fn] = [(a, op, at.get(t) if isinstance(t, str) else t) for a, op, t in insts]
    digest = {fn: hashlib.sha256("\n".join(v).encode()).hexdigest()[:16]
              for fn, v in text.items()}
    for fn, c in sorted(census.items()):
        if "leaf_kernel" in fn or "grid_kernel" in fn:
            log(card, f"SASS {fn}: " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS))
    return census, listing, digest


def slot_loop(card, listing, symbol: str, label: str, quiet=False) -> dict:
    """The SASS of a kernel's per-slot loop: the smallest backward branch
    of the one function whose symbol holds `symbol` whose body holds the
    slot test's reciprocal (MUFU.RCP, one per slot; `leaf_test` unrolls its
    slot loop by 2), its instructions per slot and their opcodes, beside
    the fp32 operations a slot test counts in the bound."""
    insts = [v for fn, v in listing.items() if symbol in fn]
    assert len(insts) == 1, f"no single SASS function for {symbol}: {list(listing)}"
    insts = insts[0]
    loops = []
    for addr, op, target in insts:
        if isinstance(target, int) and target <= addr:
            body = [o for a, o, _ in insts if target <= a <= addr]
            rcp = sum(o.startswith("MUFU.RCP") for o in body)
            if rcp:
                loops.append((len(body), rcp, target, addr, body))
    assert loops, f"{label}: no loop holds the slot test's reciprocal"
    n, rcp, lo, hi, body = min(loops)
    ops = Counter(o.split(".")[0] for o in body)
    fp32 = sum(ops[k] for k in ("FFMA", "FMUL", "FADD", "FSETP", "FMNMX", "FSEL", "MUFU",
                                "FCHK"))
    if not quiet:
        log(card, f"{label} per-slot loop (SASS 0x{lo:04x}-0x{hi:04x}): {n} instructions "
                  f"for {rcp} slot tests -> {n / rcp:.1f} instructions per slot, "
                  f"{fp32 / rcp:.1f} of them fp32 (FFMA, FMUL, FADD, FSETP, FMNMX, FSEL, "
                  f"MUFU, FCHK), against the {FLOP_PER_TRI} fp32 operations a slot test "
                  f"counts in the bound; per slot: "
                  + ", ".join(f"{k} {v / rcp:.1f}" for k, v in ops.most_common()))
    return dict(instructions_per_slot=n / rcp, fp32_per_slot=fp32 / rcp, slots_per_body=rcp,
                opcodes_per_slot={k: v / rcp for k, v in ops.items()})


def check_walk_sass(card, census, listing, digest) -> None:
    """K1-K6 keep the exact contract: the slot loop of every instance of
    traverse_kernel (K1/K2), items_kernel (K3/K5) and dense_items_kernel
    (K6) holds one exact division (FCHK and its MUFU.RCP) a slot test;
    entries_kernel (K4, no slot test) keeps its reciprocals. Logs
    each instance's slot loop and the digest of its SASS, which equal the
    parent's where the kernel's code did not change."""
    kernels = ("traverse_kernel", "items_kernel", "dense_items_kernel", "entries_kernel")
    for fn in sorted(census):
        kind = next((k for k in kernels if re.search(rf"\d{k}I", fn)), None)
        if kind is None:
            continue
        if kind == "entries_kernel":
            assert census[fn]["MUFU.RCP"] >= 1, f"{fn}: the reciprocals are gone"
            log(card, f"SASS {fn}: FCHK {census[fn]['FCHK']}, MUFU.RCP "
                      f"{census[fn]['MUFU.RCP']}, {sum(census[fn].values())} instructions, "
                      f"sha256 {digest[fn]}")
            continue
        loop = slot_loop(card, listing, fn, fn, quiet=True)
        ops = loop["opcodes_per_slot"]
        assert ops.get("FCHK", 0) >= 1 and ops.get("MUFU", 0) >= 1, \
            f"{fn}: the slot loop lost its exact division ({ops})"
        log(card, f"SASS {fn}: slot loop {loop['instructions_per_slot']:.1f} instructions a "
                  f"slot, FCHK {ops['FCHK']:.1f}, MUFU {ops['MUFU']:.1f}, FFMA "
                  f"{ops.get('FFMA', 0):.1f}; {sum(census[fn].values())} instructions, sha256 "
                  f"{digest[fn]}")


def check_sass(census: dict) -> None:
    """The census of each microbenchmark kernel holds the work it times."""
    def of(kernel, v):
        hits = [c for fn, c in census.items() if f"{kernel}ILi{v}E" in fn]
        assert len(hits) == 1, f"no single SASS function for {kernel}<{v}>: {list(census)}"
        return hits[0]

    leaf = [of("leaf_kernel", v) for v in range(7)]
    for v in (0, 1, 3):  # full, noselect, epilogue: the per-slot division
        assert leaf[v]["MUFU.RCP"] >= 1, f"U1 variant {v}: no division left"
    for v in (0, 1, 2):  # the record loads of the slot loop
        assert leaf[v]["LDG"] >= 3, f"U1 variant {v}: no record loads left"
    assert leaf[3]["SHFL"] >= 1, "U1 epilogue: the per-slot shuffle is gone"
    # fetch: the ray's own load, and the chain's load and float-to-int step
    assert leaf[4]["LDG"] >= 2 and leaf[4]["F2I"] >= 1, "U1 fetch: the chain is gone"
    # fused, staged: the approximate reciprocal, no exact division, the
    # multiply-adds, the record loads (staged: from shared memory, after
    # the cp.async copies)
    for v in (5, 6):
        assert leaf[v]["MUFU.RCP"] >= 1 and leaf[v]["FCHK"] == 0, f"U1 {v}: not rcp.approx"
        assert leaf[v]["FFMA"] >= 18, f"U1 variant {v}: the multiply-adds are gone"
    assert leaf[5]["LDG"] >= 3, "U1 fused: no record loads left"
    assert leaf[6]["LDS"] >= 3 and leaf[6]["LDGSTS"] >= 1, "U1 staged: no staged loads left"
    grid = [of("grid_kernel", v) for v in range(4)]
    assert grid[0]["MUFU.RCP"] == 0, "U2 trivial re-bases rays"
    for v in (1, 2, 3):  # set_obj's three reciprocals
        assert grid[v]["MUFU.RCP"] >= 3, f"U2 variant {v}: the re-base is gone"
    assert grid[3]["LDG"] > grid[1]["LDG"], "U2 fetch8: the node fetches are gone"


def phase9(card, dev, ps, k1_primaries):
    """The microbenchmarks U1 and U2: every variant of each kernel against
    its plain version (U1 in one block and in a block per SM, `fused`
    under its tolerance; U2 at 1 and 512 tiles), then the counted run of
    their entry points (launch counters reset just before it, read just
    after), then the cost model of K1 on the primaries that they give."""
    from rfw_tpu_torch.tools import ubench_grid as ug
    from rfw_tpu_torch.tools import ubench_leaf as ul

    census, listing, digest = sass_census(card)
    check_sass(census)
    check_walk_sass(card, census, listing, digest)
    loop = slot_loop(card, listing, "leaf_kernelILi0E", "U1 full")
    loop_fused = slot_loop(card, listing, "leaf_kernelILi5E", "U1 fused")
    loop_staged = slot_loop(card, listing, "leaf_kernelILi6E", "U1 staged")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tri, obj = ul.make_inputs()
    tris, obj = ul.to_records(torch.from_numpy(tri)).to(dev), torch.from_numpy(obj).to(dev)
    u1_err = 0.0
    fused = ("fused", "staged")  # the approximate reciprocal: by tolerance
    for variant in (v for v in ul.VARIANTS if v not in fused):  # identical
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
    # fused, staged: the copies identical, aux identical, t within the tolerance
    for variant, iters in ((v, i) for i in (U1_CMP_ITERS, U1_ITERS) for v in fused):
        ref = ul.leaf_plain(tris, obj, variant, iters)
        for copies in (1, sms):
            got = ul.leaf(tris, obj, variant, iters, copies)
            same_copies = torch.equal(got.t, got.t[:1].expand_as(got.t))
            same_aux = torch.equal(got.aux, ref.aux.expand_as(got.aux))
            rel = (got.t[0].double() - ref.t[0].double()).abs() / ref.t[0].double().abs()
            beyond = int((rel > U1_FUSED_REL).sum())
            err = (got.t[0] - ref.t[0]).abs().max().item()
            u1_err = max(u1_err, err)
            log(card, f"U1 {variant} kernel vs plain, {iters} iterations, {copies} copies: "
                      f"copies identical {same_copies}, aux identical {same_aux}, "
                      f"{beyond} of {ul.RAYS} rays beyond {U1_FUSED_REL:g} relative (at most "
                      f"{U1_FUSED_LANES}), largest relative error {rel.max().item():.3e}, "
                      f"bit-identical rays {int((got.t[0] == ref.t[0]).sum())}, max abs err "
                      f"{err:.3e}")
            tag = f"U1 {variant} ({iters} iterations, {copies} copies)"
            assert same_copies, f"{tag}: copies differ"
            assert same_aux, f"{tag}: aux differs"
            assert beyond <= U1_FUSED_LANES, f"{tag}: {beyond} rays off the plain t"

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
    # U1 full in one block against the issue rate of its own SASS: an SM
    # issues WARP_ISSUE_PER_CLOCK warp instructions a clock
    mhz = float(clock.split(",")[0])
    slots = ul.RAYS * 64 * U1_ITERS
    u1_bound_ms = ul.RAYS * 64 * FLOP_PER_TRI * U1_ITERS / (FP32_FLOP_PER_S / sms) * 1e3

    def issue_ms(per_slot):
        return slots * per_slot / 32 / (WARP_ISSUE_PER_CLOCK * mhz * 1e6) * 1e3

    for v, lp in (("full", loop), ("fused", loop_fused), ("staged", loop_staged)):
        u1_ms = leaf1["ms_per_call"][v]
        log(card, f"U1 {v}, one block: {u1_ms:.4f} ms for {slots} slot tests "
                  f"({100 * u1_bound_ms / u1_ms:.1f}% of the {u1_bound_ms:.4f} ms bound); "
                  f"issuing its SASS ({lp['instructions_per_slot']:.1f} instructions a slot) "
                  f"at {WARP_ISSUE_PER_CLOCK} warp instructions a clock at {mhz:.0f} MHz takes "
                  f"{issue_ms(lp['instructions_per_slot']):.4f} ms "
                  f"({100 * issue_ms(lp['instructions_per_slot']) / u1_ms:.1f}% of the "
                  f"measured time), its fp32 instructions alone ({lp['fp32_per_slot']:.1f}) "
                  f"{issue_ms(lp['fp32_per_slot']):.4f} ms; the bound's {FLOP_PER_TRI} fp32 "
                  f"operations as {FLOP_PER_TRI // 2} multiply-adds "
                  f"{issue_ms(FLOP_PER_TRI / 2):.4f} ms")
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
    fused_us = leafn["us_per_iter"]["fused"] / (sms * ul.RAYS * 64)
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
    fused_ms = own["tris"] * fused_us / 1e3
    log(card, f"K1 on the {n} primaries, leaf tests at U1 fused's ps a slot: {own['tris']} "
              f"slot tests x {fused_us * 1e6:.3f} ps = {fused_ms:.4f} ms against "
              f"{own['tris'] * slot_us / 1e3:.4f} ms at U1 full's {slot_us * 1e6:.3f} ps "
              f"(the fused contract would save {own['tris'] * (slot_us - fused_us) / 1e3:.4f} "
              f"ms of K1's {k1_primaries['ms']:.4f} ms, counted at U1's full occupancy)")

    u1 = dict(call=f"full, {U1_ITERS} iterations, one block", ms=leaf1["ms_per_call"]["full"],
              plain_ms=u1_plain_ms, bound_ms=u1_bound_ms, bound_by="operations",
              max_abs_err=u1_err, fused_ms=leaf1["ms_per_call"]["fused"],
              staged_ms=leaf1["ms_per_call"]["staged"],
              instructions_per_slot=loop["instructions_per_slot"],
              fused_instructions_per_slot=loop_fused["instructions_per_slot"],
              staged_instructions_per_slot=loop_staged["instructions_per_slot"])
    u2 = dict(call=f"trivial, {U2_TILES[-1]} tiles", ms=top["trivial"]["launch_us"] / 1e3,
              plain_ms=u2_plain_ms, bound_ms=full_rays * (4 + 20) / HBM_BYTES_PER_S * 1e3,
              bound_by="bytes", max_abs_err=u2_err)
    return dict(U1=[u1], U2=[u2], launches=launches)


def phase10(card, dev, parts, scene_np, lights_np, camera):
    """The backend on the card: TorchBackend(1920, 1080) (default device:
    the card) on the flagship scene fed through the contract (each mesh as
    Mesh3D.view(), instances, materials, textures, the spot, sun and
    area-light views, the camera), with phase 5's settings and the default
    two_phase="auto". Checks: the first synchronize packs build_scene's
    arenas field for field; the first frame launched K1, K2 and K3 (launch
    counters reset just before it, read just after); its HDR frame equals
    render_sample at sample_index 0 on the backend's own tensors;
    tonemap(fxaa=True) on the card agrees with the CPU on the same
    accumulator. Then 4 progressive frames, a motion sync of the 256
    sphere instances against a full repack, a NORMAL frame and a frame with
    a quad2d overlay, each with its time."""
    from rfw_tpu_torch.backend import CameraView2D, InstancesView2D, InstancesView3D, RenderMode
    from rfw_tpu_torch.mathx import orthographic_rh
    from rfw_tpu_torch.models import quad2d
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.render.film import tonemap
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
    from rfw_tpu_torch.render.wavefront import (
        RenderConfig, mat_feature_mask, render_sample, tex_kinds_mask,
    )

    t_phase = time.perf_counter()
    settings = TorchSettings(samples_per_frame=1, max_bounces=BOUNCES, clamp=20.0,
                             sky_intensity=0.35, sampler="sobol")
    be = TorchBackend(W, H, settings)
    assert be.device.type == "cuda", be.device
    mats = parts["materials"]
    meshes = {slot: mesh for slot, mesh, _ in parts["meshes"]}

    def inst_view(slot, matrices):
        n = matrices.shape[0]
        return InstancesView3D(matrices=matrices, skin_ids=np.full(n, -1, np.int32),
                               changed=np.ones(n, bool), local_aabb_min=meshes[slot].aabb_min,
                               local_aabb_max=meshes[slot].aabb_max)

    be.set_3d_meshes([(slot, mesh.view()) for slot, mesh in meshes.items()])
    be.set_3d_instances([(slot, inst_view(slot, m)) for slot, m in parts["instances"]])
    be.set_materials(mats.to_device(), [i for i, _ in mats.materials])
    be.set_textures([(i, t.view()) for i, t in mats.textures])
    be.set_spot_lights(parts["spot"])
    be.set_directional_lights(parts["sun"])
    be.set_area_lights(parts["area"])
    be.synchronize()
    cold_ms = be.stats["sync_ms"].last()
    for f in scene_np._fields:
        a, b = getattr(scene_np, f), getattr(be._scene_host, f)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), \
            f"the backend's pack differs from build_scene's in {f}"
    packed_lights = be._pack_lights()
    for f in lights_np._fields:
        assert np.array_equal(getattr(lights_np, f), getattr(packed_lights, f)), f
    log(card, f"phase 10: TorchBackend({W}, {H}) on {be.device}; first synchronize (BLAS "
              f"builds, pack, upload) {cold_ms:.2f} ms; its pack equals build_scene's in all "
              f"{len(scene_np._fields)} TraceScene fields and the lights'")

    view = camera.get_view(W, H)
    torch.cuda.synchronize()
    reset_launches()
    frame = be.render(None, view)
    launches = read_launches()
    log(card, f"backend first frame: {be.stats['render_ms'].last():.2f} ms, launches "
              f"{launches}")
    for k in ("closest", "occluded", "items_closest"):
        assert launches[k] > 0, f"TorchBackend.render never launched {k}"
    assert frame.shape == (H, W, 4) and frame.dtype == np.uint8
    hdr = be.hdr_frame()
    cfg = RenderConfig(max_bounces=BOUNCES, clamp=20.0, sky_intensity=0.35, sampler="sobol",
                       aovs=False, tex_mask=tex_kinds_mask(be._materials.tex),
                       mat_features=mat_feature_mask(be._materials),
                       has_area_lights=be._area.count > 0)
    ref = render_sample(be._scene_dev, be._mats_dev, be._atlas_dev, be._lights_dev,
                        torch.from_numpy(view.as_array()).to(dev), W, H, cfg,
                        sample_index=0).radiance.cpu().numpy().reshape(H, W, 3)
    same = np.array_equal(hdr, ref)
    err = np.abs(hdr - ref)
    px_ok = (err <= 1e-3 + 1e-3 * np.abs(ref)).all(axis=-1).mean()
    log(card, f"backend HDR frame vs render_sample(sample_index=0): bit-identical {same}, "
              f"{int((err > 0).any(axis=-1).sum())} pixels differ, max abs err "
              f"{err.max():.3e}, {px_ok:.6f} of pixels within 1e-3 abs + 1e-3 rel, mean "
              f"{hdr.mean():.6f} vs {ref.mean():.6f}")
    assert np.isfinite(hdr).all() and hdr.mean() > 0, "non-finite or black HDR frame"
    # both sides run render_sample on the same card tensors at sample 0, and
    # no op of it was found not to be deterministic on CUDA: bit for bit
    assert same, "the backend's HDR frame differs from render_sample's"

    fx_card = tonemap(be._film, be._spp, W, H, fxaa=True).cpu().numpy()
    fx_cpu = tonemap(be._film.cpu(), be._spp, W, H, fxaa=True).numpy()
    diff = np.abs(fx_card.astype(np.int32) - fx_cpu.astype(np.int32)).max(axis=-1)
    log(card, f"tonemap(fxaa=True) card vs CPU on the same accumulator: "
              f"{(diff <= 1).mean():.6f} of pixels within 1, max {diff.max()}; FXAA changed "
              f"{(fx_card != tonemap(be._film, be._spp, W, H).cpu().numpy()).any(-1).mean():.4f}"
              f" of pixels")
    assert (diff <= 1).mean() >= 0.999, "card FXAA disagrees with CPU FXAA"

    for _ in range(4):
        be.render(None, view)
        log(card, f"backend progressive frame, spp {be._spp}: "
                  f"{be.stats['render_ms'].last():.2f} ms, "
                  f"{be.stats['mrays_per_s'].last():.3f} Mrays/s")
    assert be._spp == 5

    # a motion sync of the 256 sphere instances, then a full repack of the
    # same state (cached BLAS): the same arenas either way
    rng = np.random.default_rng(SEED)
    moved = []
    for slot, m in parts["instances"][:4]:
        m = m.copy()
        m[:, :3, 3] += rng.uniform(-0.3, 0.3, (m.shape[0], 3)).astype(np.float32)
        moved.append((slot, inst_view(slot, m)))
    geo = be._scene_dev.tri_v0
    be.set_3d_instances(moved)
    assert be._inst_dirty and not be._geo_dirty
    be.synchronize()
    motion_ms = be.stats["sync_ms"].last()
    assert be._scene_dev.tri_v0 is geo, "the motion sync re-uploaded geometry"
    after_motion = be._scene_host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    be._rebuild_scene()
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t0) * 1e3
    for f in after_motion._fields:
        assert np.array_equal(getattr(after_motion, f), getattr(be._scene_host, f)), \
            f"motion sync and full repack differ in {f}"
    log(card, f"backend sync of {sum(v.count for _, v in moved)} moved instances "
              f"(repack_instances, host TLAS): {motion_ms:.2f} ms; a full repack of the "
              f"same state (_rebuild_scene, BLAS cached): {full_ms:.2f} ms; the first sync "
              f"(BLAS builds): {cold_ms:.2f} ms; motion and full repack give the same arenas")
    be.render(None, view)
    log(card, f"backend frame after the motion: {be.stats['render_ms'].last():.2f} ms")

    normal = be.render(None, view, RenderMode.NORMAL)
    log(card, f"backend NORMAL frame: {be.stats['render_ms'].last():.2f} ms, mean 8-bit "
              f"value {normal[..., :3].mean():.3f}")
    assert normal.shape == (H, W, 4) and normal[..., :3].std() > 1.0

    # a quad over 9% of the frame, textured with the floor's checker
    be.set_2d_meshes([(0, quad2d(center=(0.3 * W, 0.3 * H), size=(0.3 * W, 0.3 * H),
                                 color=(1.0, 1.0, 1.0, 0.85), texture_id=0).view())])
    be.set_2d_instances([(0, InstancesView2D(np.eye(4, dtype=np.float32)[None],
                                             np.ones(1, bool)))])
    view_2d = CameraView2D(matrix=orthographic_rh(0.0, float(W), float(H), 0.0, -1.0, 1.0))
    plain = be.render(None, view, RenderMode.RESET)
    t0 = time.perf_counter()
    over = be.render(view_2d, view, RenderMode.RESET)  # the same sample, overlaid
    wall = (time.perf_counter() - t0) * 1e3
    changed = (np.abs(over.astype(np.int32) - plain.astype(np.int32)).max(-1) > 8).mean()
    log(card, f"backend frame with a textured quad2d overlay: {wall:.2f} ms in all, "
              f"{be.stats['render_ms'].last():.2f} ms of it before the overlay; "
              f"{changed:.4f} of pixels changed by more than 8")
    assert 0.05 < changed < 0.2, f"overlay covers {changed} of the frame"
    log(card, f"phase 10: {time.perf_counter() - t_phase:.2f} s")

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
                            (f"K4 (K={tp_k})", lambda c: te.launch_shape(tp_k, c, W * H)),
                            ("K6 closest", lambda c: ti.dense_launch_shape(False, c, W * H)),
                            ("K6 any hit", lambda c: ti.dense_launch_shape(True, c, W * H))):
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
    scene_np, mats_np, lights_np, atlas_np, camera, pack_s, parts = build_scene(SEED, views=True)
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
    tie_between_treelets(card, dev)

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

    # ---- 10. the backend on the card
    phase10(card, dev, parts, scene_np, lights_np, camera)

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
            ubench["launches"]["leaf"], ubench["U1"], fused_ms=ubench["U1"][0]["fused_ms"],
            staged_ms=ubench["U1"][0]["staged_ms"]),
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
