"""Smoke check of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sass-against DIR   # the walk kernels' SASS
                                               # against another tree's
    python3 chip_smoke.py --sobol              # phase 19 alone
    python3 chip_smoke.py --disney             # phase 20 alone

Drives rfw_tpu_torch's main paths — one progressive path-traced sample per
call of `render_sample`, 1920x1080, 1 bounce + next-event estimation, Sobol
sampler, film accumulation and tonemap — on a procedural scene at the
flagship scene's scale (4 icosphere meshes of 20,480 triangles, 256
instances, textured floor, area + spot + sun lights; made from a seed),
with two_phase="off" (every ray through the classic kernel) and with
two_phase="on" (bounce rays through the two-phase path; the default
"auto" keeps them on the classic kernel on the card), and on
an instance-heavy scene of 10,000 instances; then drives the same scene
through the backend a user calls, `TorchBackend`, and through the app
layer a user writes, `Instance` and `Scene`.

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
     the lockstep tier (traversal="lockstep": one stack per ray over the
     binary arenas, the reference's oracle tier);
  5. the main path at 1920x1080 with two_phase="off": a warm-up sample
     whose traversal inputs are captured, each kernel against its plain
     version on exactly those inputs (compare_call, with both times), then 8 timed
     samples with the kernels' launch counters reset just before them
     (the Disney BSDF kernels' must read 3 a sample);
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
     ms per sample of two_phase="off" against "on" (dense scan, then
     K4); the first "on" turn is the counted run of the two-phase
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
     ms per sample of "off", "on", and "on" with both switches set,
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
     field for field, its first frame launches K1 and K2 and no K3 (the
     bounce rays by K1 under "auto" on the card; counters
     reset just before it, read just after), its first HDR frame equals
     render_sample at sample 0 on its own tensors, tonemap(fxaa=True) on
     the card agrees with the CPU on the same accumulator (99.9% of
     pixels within 1); then 4 progressive frames (ms, Mrays/s), a motion
     sync of the 256 sphere instances against a full repack (the same
     arenas either way), a NORMAL frame and a frame with a quad2d overlay;
 11. the app on the card, as a user writes it: (a) the flagship scene
     authored through Instance(TorchBackend(1920, 1080), ...) and
     app.scene (add_texture, add_material, add_3d_object,
     add_3d_instance, the spot and sun lights; the area lights come from
     the emissive material), 5 frames by run_windowed(HeadlessWindow):
     the first Scene.synchronize packs build_scene's arenas field for
     field and its lights (directions normalized), the first frame
     launches K1 and K2 and no K3 (counters reset just before it, read at its
     present); each frame's ms, render ms and Mrays/s and
     Scene.synchronize's own host ms; (b) a SphereWorld system moving 64
     sphere instances by InstanceHandle3D.set_trs, 5 frames: one motion
     sync a frame (repack_instances, no full repack, no geometry upload),
     and the last frame's arenas equal a full repack of the same state;
     (c) Scene.load of an OBJ/MTL and of a 2-joint skinned glTF written
     here, at two animation times NORMAL, ALBEDO and GBUFFER frames at
     96x72 and 480x270 from TorchBackend on the card and from
     CpuReferenceBackend, each synced in full: RMSE at most 1e-3 per mode,
     and the two times give different frames. Phases 10 and 11 take the
     backend's host routes (device_dynamics and device_motion off);
 12. dynamics and the random sampler, with TorchSettings' defaults (the
     device routes): (a) the flagship scene plus four instances of a
     skinned, morphed tube of 20,480 triangles (24 joints in a chain, 2
     morph targets) under two skins, 8 animated frames: every sync takes
     the device route (apply_dynamic: no repack, KBs uploaded), the first
     dynamic frame launches K1 and K2 and no K3 (counters reset just before its
     sync, read after its render), the last frame's arenas within 1e-4 of
     a full host repack of the same pose and its HDR frame within the
     radiance tolerance of the host route's (device_dynamics=False), ms
     per sync of both routes; (b) the 256 sphere instances moved for 8
     frames: zero repack_instances calls (instance_motion_update), frames
     against the host rebuild's (differing pixels counted), ms per motion
     sync of both routes; (c) one motion sync of the instance-heavy scene
     with device_motion=False at 10,000 instances (the Morton tree
     outgrows the host collapse's padded rows: the host collapse stays)
     and at 4,000 (build_tlas8_device runs), K1 on the 1080p primaries
     over the device-built tree and over the host collapse: masks and t
     identical, ids up to counted exact-t ties; (d) one 1080p sample with
     sampler="random": every threefry uniform it drew on the card
     identical to the same call on the CPU; ms per sample of "random"
     against "sobol" in turns;
 13. the scale-out layer and the examples: (a) the 1080p frame of phase
     5's settings with two_phase="on" rendered as four row0 strips of
     270 rows, one after another, against the full frame (differing
     pixels per output; each live strip ray matched by its bits to the
     frame's same ray: closest hits with the same t but other ids counted
     as exact-t ties, any other t or occlusion flag fails), the strips'
     time against one full-frame sample in turns, and one strip's counted
     run; (b) a one-rank NCCL group made by film_mesh():
     render_sample_sharded against render_sample (Sobol, per pixel),
     render_spp_sharded (Sobol and random) and render_sharded_2d on a
     (1, 1) mesh, 4 samples each, against the sequential means (rtol 1e-5,
     atol 1e-6), broadcast_scene of the packed arenas and the time of an
     NCCL broadcast of them and of an all-reduce of one sample's radiance;
     (c) examples/torch_{cornell,physics,d2,interactive}.py as
     subprocesses on the card, all at once: exit 0, their frame and timing
     lines logged, their PNGs written;
 14. the slice that closes the port: (a) the native host library
     (rfw_tpu_torch/native, built by g++ in phase 1, its first use, and
     timed there), the flagship and heavy scenes packed by it and by numpy
     (RFW_NO_NATIVE=1) in turns, host seconds each, node, leaf-link and
     instance arrays identical and every leaf's triangle set identical; a
     256x144 Sobol render from each flagship pack at phase 4's gate; the
     backend's host routes (device_dynamics and device_motion off) on
     phase 12 (a)'s scene, dynamic and motion syncs by either builder in
     turns; (b) 256x144 1-spp Sobol frames (two_phase="on") under
     "packet", "lockstep", "pallas" and "pallas_hbm" against "auto" at
     phase 4's gate, ms per sample by CUDA events, the "pallas" frame's
     launches counted (counters reset just before it, read just after),
     and a "pallas" frame at 248x144 (R no multiple of 1,024: the kernels
     in rfw_tpu's packet lane order, two-phase off) against "auto" at that
     size, its launches counted (K1 and K2, no K3);
     (c) the public two-phase call ops.pallas_twophase_closest_hit (phase
     A by K4, phase B by K3, no retrace) on phase 7's captured bounce rays,
     its launches counted, its hits against K1's on the rays it does not
     mark truncated (check_nearest), its time against K1's; (d)
     build_lbvh_device on the heavy scene's 10,000 instance boxes on the
     card against the CPU (bit for bit), with its time;
 15. the measurement entry point and its tools: (a) `python -m
     rfw_tpu_torch.bench` (rfw_tpu_torch.bench.main) at 1920x1080, 8
     samples, 3 repeats, with --two-phase off and on: each JSON line
     parsed (a positive value, a finite film), and the launches of each
     whole run (counters reset just before it, read just after) a sample:
     K1 2, K2 2 under "off", and K3 1 besides under "on"; (b) each layer
     tool of rfw_tpu_torch.tools (bisect_e2e, profile_e2e, bench_traverse
     with --occluded --tp-occluded --stats, bench_items plain, --fused and
     --breakdown --pallas-A, check_traverse, diag_live) at the reference
     tools' default sizes on the flagship scene, its line logged:
     check_traverse's gate must pass, bench_items and the two-phase any hit
     must agree with K1/K2; (c) examples/torch_animated.py at 64x36, 2
     frames, --no-pica, with a skinned glTF written here as its CesiumMan:
     two PNGs, its second frame's sync by the device skin and refit route;
 16. wide supernodes and the bounce sort keys: (a) the flagship and the
     instance-heavy scene packed 16- and 32-wide (RFW_WIDE_ARITY), K1/K2
     against their plain versions at the same arity on phase 5's four
     captured calls (primaries, vertex-0 shadows, bounce rays, bounce
     shadows) and against the 8-wide kernels on the same rays (K1 under
     the nearest-first gate, K2 identical), K3/K5 on phase 7's and phase
     8's captured items and K4 on their rays, each under its arity-8 gate
     with its counts, times and bound; ptxas's spills and each wide
     instance's registers and occupancy; (b) no kernel push finds its
     96-entry stack full (walk_counts asserts it of every compared call,
     in every phase); (c) one counted 1080p sample per wide arity
     (two_phase "on", RFW_TP_SHADOW=1, phase A by K4: K1, K2, K3, K4 and
     K5 each launch), K1 on one sample's bounce rays under each sort key
     and in pixel order, `python -m rfw_tpu_torch.bench` as a subprocess
     with two_phase "off" and "on" under RFW_WIDE_ARITY 8, 16 and 32
     and, at 8, under RFW_SORT_KEY morton, mortonoct and instance (ms per
     sample, Mrays/s, peak memory), and TorchBackend(1920, 1080) on a
     16-wide pack with the skinned tube of phase 12 (a): its first HDR
     frame equals render_sample on its own tensors bit for bit, a skin
     pose sync and a motion sync take the host routes;
 17. the last switches and tools: (a) the flagship's 1080p Sobol sample
     under RFW_COMPACTION=0 with two_phase "off" and "on": no host read
     of a live count (no `_pick_prefix` call and no vertex-0 sort, where
     the compacted sample makes two and one), its HDR frame against the
     compacted sample's at phase 4's per-pixel tolerance, K1 and K2
     against their plain versions on the captured uncompacted vertex-0
     shadow, bounce and bounce shadow calls (every lane of the frame,
     dead ones included), ms per sample compacted against uncompacted in
     turns, the uncompacted "on" run counted; (b) `python -m
     rfw_tpu_torch.bench` as subprocesses (3 repeats) under
     RFW_COMPACTION 1 and 0 with "off" and "on", and under
     RFW_DEEP_LADDER 1 and 0 at 3 bounces: ms per sample, Mrays/s, peak
     memory and launches a sample; (c) rfw_tpu_torch.tools.bench_nee in
     its default mode and sweeping 4 and 32 point lights (finite
     variances, each child process with the RFW_POTENTIAL_MAX it was
     given); (d) profile_shading, ubench_atlas, ubench_gather (alone,
     with --sweep-size and with --sweep-width) and bench_fused_stages
     (--case sorted, phase A by the dense scan and by K4) at the
     reference tools' defaults, every stage reported and positive; (e)
     profile_dynamics on a skinned glTF written here as its CesiumMan,
     without pica: its skin sync takes the device route.
 18. textures without Pillow (`import PIL` blocked for the phase, whether
     or not the machine has it): (a) the fixtures of tests/golden/textures
     (PNG: RGBA, palette with tRNS, 16-bit grey; JPEG: baseline 4:2:0,
     4:2:2, 4:4:4, greyscale, progressive, restart markers, a 1024x1024
     gradient) decoded by rfw_tpu_torch.utils.image, each equal to the
     array Pillow decoded when it was made; (b) a glTF embedding the 37x53
     4:2:0 JPEG as baseColor and a 24x20 PNG as metallic-roughness, loaded
     through Scene into TorchBackend(640, 360): both textures' 64x64 mip 0,
     on the host and read back from the card's atlas, equal the committed
     arrays of Pillow's bilinear resize; its first frame launches K1, K2
     and K3 and is finite and non-zero; (c) the host's decode ms per
     megapixel of a 2048x2048 PNG written by utils/png.py and of the
     1024x1024 JPEG.
 19. the Sobol kernel (csrc/sampler.cu): the five draws of one 1080p
     Sobol sample captured (camera jitter on the swizzled pixel ids,
     vertex 0's light and BSDF slots on its sorted hit prefix, the
     bounce's slot on its live prefix): 5 kernel launches, each draw
     launched once more and identical bit for bit to the plain version
     (`sample_slot_plain`), also with a per-lane sample index; card ms
     over 10 launches beside its bound (the ids read and the uniforms
     written at 3.35 TB/s against `sobol_ops` at the INT32 rate) and the
     plain version's ms (tests/test_torch_sampler.py's
     `test_sobol_kernel_matches_plain_on_card`).
 20. the Disney BSDF kernels (csrc/disney.cu): the 3 BSDF calls of one
     1080p sample captured (vertex 0's NEE eval + pdf and its sample, the
     bounce's NEE eval + pdf, on the main path's strided column views and
     the scene's feature mask), each launched once more (disney.LAUNCHES
     up by exactly 1) and identical bit for bit to the plain versions
     (`disney_eval_plain_c`, `disney_pdf_plain_c`,
     `disney_sample_plain_c`); card ms over 10 launches beside its bound
     (20 planes read and 3-4 planes, or 7 and a bool, written at 3.35
     TB/s) and the plain versions' ms (tests/test_torch_disney.py's
     `test_kernels_match_plain_on_card`).
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
microbenchmark, so library_ms is null; launches_app is its launches in
phase 11's first frame, launches_dynamics in phase 12's first dynamic
frame (its sync and its render), launches_parallel in phase 13's
counted film strip, launches_tiers in phase 14's "pallas" frame,
launches_twophase_call in its public two-phase call and launches_bench in
phase 15's "on" bench run (25 samples: the warm-up and 3 x 8),
launches_uncompacted in phase 17 (a)'s counted RFW_COMPACTION=0 "on"
run (3 samples), launches_textures in phase 18's textured glTF frame; K1's and K2's uncompacted_calls are phase 17 (a)'s
compared calls, their disagreements counted in max_abs_err. K1-K5
carry their supernode `arity`; the entries of arity 16 and 32 (phase 16)
count their launches in that arity's counted sample and sum their times,
plain times and bounds over phase 16's compared calls at that arity (a
16-wide row is 512 B, a 32-wide one 1 KiB). The next entry, S1, is
phase 19's Sobol kernel, which replaces no TPU kernel (`replaces` null):
its launches in one sample, its times, plain times and bounds summed over
that sample's five draws, each bounded by bytes or by its 32-bit
operations at the INT32 rate. After it B1, phase 20's Disney BSDF
kernels, which replace no TPU kernel either: likewise over the sample's
3 BSDF calls, each bounded by bytes. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
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

from rfw_tpu_torch.tools import patched

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


def main_path_settings(mats_np, lights_np) -> dict:
    """RenderConfig's fields of phases 4-5 (two_phase "off") for the scene's
    materials and lights."""
    from rfw_tpu_torch.render.wavefront import mat_feature_mask, tex_kinds_mask

    return dict(max_bounces=BOUNCES, clamp=20.0, sky_intensity=0.35, sampler="sobol",
                two_phase="off", aovs=False, sort_secondary=True,
                tex_mask=tex_kinds_mask(mats_np.tex), mat_features=mat_feature_mask(mats_np),
                has_area_lights=bool(lights_np.n_area[0] > 0))


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
    TPU's order under K1's gate (`rfw_tpu_torch.tools.check_traverse.
    nearest_gate`): hit masks identical; t bit-identical where both hit, but
    for at most 1 in 10^5 live rows (all rows, or those of the mask `live`:
    K3's items, not its empty slots), each within 1e-5 relative and printed
    with which walk found the nearer triangle (the other dropped its box at
    the rounding edge, where a box's entry t lies past the triangle's t);
    prim, inst, u and v bit-identical except on an exact tie (another
    triangle at the plain walk's t, bit for bit), which is counted; misses,
    empty slots among them, identical in every output. Returns the largest
    |t| difference."""
    from rfw_tpu_torch.tools.check_traverse import nearest_gate

    g, diff = nearest_gate(kh, ph, live)
    n, n_diff = g["rows"], g["t_differ"]
    log(card, f"{name}, {label}: hit masks identical {g['masks_identical']}, hits {g['hits']}, "
              f"t bit-identical on all but {n_diff} (max rel {g['t_differ_max_rel']:.3e}), "
              f"exact-t ties (another triangle) {g['exact_t_ties']}, u/v differ on the same "
              f"triangle {g['uv_differ']}, misses differ {g['misses_differ']}, bit-identical "
              f"{g['identical']}")
    for i in diff.nonzero().squeeze(1)[:20].tolist():
        nearer = "kernel" if kh.t[i] < ph.t[i] else "plain walk"
        log(card, f"  ray {i}: kernel t {kh.t[i].item():.9g} prim {kh.prim[i].item()} inst "
                  f"{kh.inst[i].item()}; plain t {ph.t[i].item():.9g} prim {ph.prim[i].item()} "
                  f"inst {ph.inst[i].item()}; the {nearer} found the nearer triangle, the other "
                  f"walk dropped its box at the rounding edge")
    assert g["masks_identical"], f"{name} ({label}): hit masks differ"
    assert n_diff <= n // 100000, f"{name} ({label}): t differs on {n_diff} of {n} rays"
    assert g["t_differ_max_rel"] <= 1e-5, f"{name} ({label}): t differs by > 1e-5"
    assert g["uv_differ"] == 0 and g["misses_differ"] == 0, \
        f"{name} ({label}): outputs differ off a tie"
    return g["t_err_max"]


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


def check_counts(tag, ks, shape, live, kind="walk", arity=8):
    """The counting instance's invariants: one warp_ns row per launched
    warp (shape: its launch shape), each written, its end at or after its
    start; rows outside the mask `live` (empty slots, dead lanes) count
    nothing; no leaf visit tests more than its 64 slots. A walk ("walk",
    K1-K5) visits a node for every live row and tests at most `arity` (the
    scene's supernode width) boxes a visit; K6 ("dense") visits no node and
    tests a treelet only after its box."""
    assert ks.warp_ns.shape == (shape["grid"] * shape["block"] // 32, 2), \
        f"{tag}: warp_ns {tuple(ks.warp_ns.shape)} for the launch {shape}"
    assert bool((ks.warp_ns[:, 0] > 0).all()) and bool(
        (ks.warp_ns[:, 1] >= ks.warp_ns[:, 0]).all()), f"{tag}: a warp span is missing"
    for k in ("nodes", "boxes", "leaves", "tris"):
        assert not bool(getattr(ks, k)[~live].any()), f"{tag}: an empty row counts {k}"
    assert bool((ks.tris <= 64 * ks.leaves).all()), f"{tag}: a leaf tests over 64 slots"
    if kind == "walk":
        assert bool((ks.nodes[live] >= 1).all()), f"{tag}: a live row visits no node"
        assert bool((ks.boxes <= arity * ks.nodes).all()), \
            f"{tag}: over {arity} box tests a visit"
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
    # pushes that found the stack (96 entries) full: each overwrote the top
    # entry, which can lose a subtree; the kernels must make none
    full = None if ks.full is None else int(ks.full)
    log(card, f"{tag} counts: kernel {k_tot['nodes']} node visits, {k_tot['boxes']} box "
              f"tests, {k_tot['leaves']} leaf visits, {k_tot['tris']} slot tests; plain walk "
              f"{stats.get('nodes', 0)}, {stats.get('boxes', 0)}, {stats.get('leaves', 0)}, "
              f"{stats.get('tris', 0)}; per-ray counts equal {counts_equal}; SIMD efficiency of "
              f"the launch order {eff:.4f} (plain walk's {eff_p:.4f}), longest {longest} steps "
              f"(plain {longest_p}); {shape_d['registers']} registers, occupancy theoretical "
              f"{theory_d:.3f} (counting instance {theory:.3f}), achieved "
              f"{'not measured' if achieved is None else f'{achieved:.3f}'} (counting instance)"
              + ("" if full is None else f"; pushes that found the stack full: kernel {full}, "
                 f"plain walk {stats.get('full', 0)}"))
    assert not full, f"{tag}: {full} pushes found the kernel's stack full"
    return dict(bound_ms=b_ms, bound_by=by, bound_ms_plain_counts=b_plain, stack_full=full,
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
    shapes = [tr.launch_shape(kind == "occluded", c, n, arity=ps.arity) for c in (False, True)]
    check_counts(f"{name} ({tag})", ks, shapes[1], torch.ones_like(tl_t, dtype=torch.bool),
                 arity=ps.arity)
    row = walk_counts(card, f"{name} {label}", ks, stats, n * (28 + out_b) + scene_b, shapes)
    log(card, f"{name} {label}: {n} rays ({live} live), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, {bound_note(row)}")
    return dict(call=label, rays=n, live=live, ms=ms, plain_ms=plain_ms, max_abs_err=err, **row)


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

    ents, _, _, slot_inst, o_s, d_s, tl_s = ti._pack(ps, o, d, tl, K,
                                                     math.ceil(o.shape[0] * items_per_ray))
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
    shapes = [ti.dense_launch_shape(any_hit, c, n) if dense
              else ti.launch_shape(any_hit, c, n, arity=ps.arity) for c in (False, True)]
    check_counts(f"{name} ({label})", ks, shapes[1], live_k, "dense" if dense else "walk",
                 ps.arity)
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
    shapes = [te.launch_shape(K, c, n, arity=ps.arity) for c in (False, True)]
    check_counts(f"K4 ({label})", ks, shapes[1], tl > 0, arity=ps.arity)
    row = walk_counts(card, f"K4 {label}", ks, stats, n * (28 + 8 * K) + tlas_b, shapes)
    log(card, f"K4 {label}: {n} rays ({live} live), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, {bound_note(row)}")
    return dict(call=label, rays=n, live=live, ms=ms, plain_ms=plain_ms, max_abs_err=err, **row)


def twophase_stages(card, label, ps, o, d, tl, cfg):
    """One two-phase call with its stages bracketed by synchronize()
    (rfw_tpu_torch.tools.bench_fused_stages.stages): phase A, pack, phase
    B kernels, merge, fallback; and the fallback's ray count."""
    from rfw_tpu_torch.tools.bench_fused_stages import stages

    call = stages(ps, o, d, tl, cfg.tp_K, cfg.tp_items_per_ray, torch.device("cuda"))
    total = call["total_ms"]
    log(card, f"two-phase call stages, {label}: {total:.2f} ms in all; truncated rays "
              f"{call['truncated']}, retraced by the fallback {call['retraced']}")
    for name, ms in sorted([*call["stage_ms"].items(),
                            ("other (ray gathers, flags, glue)", call["other_ms"])],
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


def stage_breakdown(card, run):
    """One sample with its stages bracketed; prints ms and share per stage."""
    from rfw_tpu_torch.render import disney
    from rfw_tpu_torch.render import wavefront as wf
    from rfw_tpu_torch.tools.bench_fused_stages import StageClock

    clock = StageClock(torch.device("cuda"))
    wf_stages = dict(
        prepare_scene="prepare_scene", sample_slot="sobol uniforms (sample_slot)",
        camera_rays_c="camera rays", closest_hit="trace closest (K1)",
        occluded="trace shadow (K2)", _shading_basis_c="shading basis",
        _fetch_material_c="material + textures", _sample_light_c="NEE light sample",
        morton_codes_c="sort key (Morton)")
    disney_stages = dict(disney_eval_c="disney eval", disney_pdf_c="disney pdf",
                         disney_eval_pdf_c="disney eval + pdf",
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

    cfg = RenderConfig(**{**base, "two_phase": "on"})
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
    items_k3 = packed_items(ps, o, d, tl, cfg.tp_K, cfg.tp_items_per_ray)[1:5]
    k3 = compare_items(card, "K3", "bounce closest items", False, False, ps, *items_k3)
    items_k5 = packed_items(ps, so, sd, stl, cfg.tp_K, cfg.tp_items_per_ray)[1:5]
    k5 = compare_items(card, "K5", "bounce shadow items", False, True, ps, *items_k5)
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
        ("off", cfg_off, env), ("on", cfg, env),
        ("on, phase A by K4", cfg, lambda: patched(ti, DENSE_A_MAX_INST=0))],
        sample, counted="on")
    for k in ("closest", "occluded", "items_closest"):
        assert launches[k] > 0, f"the two-phase path never launched {k}"
    # phase 16 holds the wide walks on the same inputs
    inputs = dict(K3=[("bounce closest items", items_k3)],
                  K5=[("bounce shadow items", items_k5)],
                  K4=[("flagship bounce rays", (o, d, tl))])
    return dict(K3=[k3], K5=[k5], K4=[k4], launches=launches, fallback=fb, rays=(o, d, tl),
                inputs=inputs)


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
    cfg = RenderConfig(**{**base, "two_phase": "on", "tex_mask": tex_kinds_mask(mats_np.tex),
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
        inputs = dict(K3=[], K5=[], K4=[("heavy bounce rays", (o, d, tl)),
                                        ("heavy bounce shadow rays", (so, sd, stl))])
        for label, (ro, rd, rtl), any_hit in (("bounce closest", (o, d, tl), False),
                                              ("bounce shadow", (so, sd, stl), True)):
            _, inst, o_s, d_s, tl_s, dense_k = packed_items(
                ps, ro, rd, rtl, cfg.tp_K, cfg.tp_items_per_ray)
            none = torch.full_like(inst, -1)
            walk_i = torch.where(dense_k, none, inst).contiguous()
            dense_i = torch.where(dense_k, inst, none).contiguous()
            kname, label = "K5" if any_hit else "K3", f"heavy {label} items (walk tier)"
            rows[kname].append(compare_items(card, kname, label, False, any_hit, ps, walk_i,
                                             o_s, d_s, tl_s))
            inputs[kname].append((label, (walk_i, o_s, d_s, tl_s)))
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
        ("off", cfg_off, env), ("on", cfg, env),
        ("on, RFW_TP_SHADOW=1 RFW_DENSE_ITEMS=1", cfg, tiers)],
        sample, counted="on, RFW_TP_SHADOW=1 RFW_DENSE_ITEMS=1", n=HEAVY_SPP)
    log(card, f"phase 8 counted render: mean radiance {(acc / HEAVY_SPP).mean().item():.6f}")
    for k in ("closest", "occluded", "entries", "items_closest", "items_occluded",
              "dense_closest", "dense_occluded"):
        assert launches[k] > 0, f"the phase-8 path never launched {k}"
    return dict(K4=k4, launches=launches, fallback=fb, inputs=inputs, ps=ps, **rows)


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


def sass_census(card, names=UBENCH_LIBS + WALK_LIBS, paths=None):
    """Per kernel of the named libraries, the count of each SASS opcode
    (`cuobjdump -sass` of the built libraries): nvcc deletes work whose
    result is never stored, so this shows that the re-base, the leaf loop,
    the epilogue's division and the fetch chains of the microbenchmarks
    are still in the code, and that the walks keep their exact division.
    Logs the microbenchmarks' censuses. Returns ({kernel symbol: Counter},
    {kernel symbol: [(address, opcode, branch target or None)]}, {kernel
    symbol: sha256 of its instructions}), of the named libraries as this
    tree builds them, or of the built libraries at `paths`. The digest
    reads each instruction without its encoding and column padding, each
    label as the function-relative address it names, and drops the
    numbering that nvcc gives internal subroutines and the anonymous
    namespace across a library, so one function's code digests alike
    whatever else its library holds."""
    import hashlib

    from rfw_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    census, listing, labels, text = {}, {}, {}, {}
    for path in paths or [b.path for b in _build.build(list(names))]:
        sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
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
                # the instruction alone, its spacing dropped (cuobjdump pads
                # the columns to the widest instruction of the library)
                inst = line.split("/*")[1].split("*/", 1)[1].split(";")[0]
                text[fn].append(" ".join(inst.split()))
                census[fn][op.split(".")[0]] += 1
                if op.startswith("MUFU.RCP"):
                    census[fn]["MUFU.RCP"] += 1
                target = None
                if op.split(".")[0] == "BRA":  # an address or a label
                    t = re.search(r"0x([0-9a-f]+)|\((\.L_x_\d+)\)", m.group(3))
                    target = t and (int(t.group(1), 16) if t.group(1) else t.group(2))
                listing[fn].append((int(m.group(1), 16), op, target))
    digest = {}
    for fn, insts in listing.items():  # labels -> the addresses they name
        at = {name: insts[i][0] for name, i in labels[fn].items() if i < len(insts)}
        listing[fn] = [(a, op, at.get(t) if isinstance(t, str) else t) for a, op, t in insts]
        lines = [re.sub(r"\.L_x_\d+", lambda m: f"0x{at.get(m.group(0), -1):x}", line)
                 for line in text[fn]]
        lines = [re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+|__internal_\d+_", "#",
                        line) for line in lines]
        digest[fn] = hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]
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
    arenas field for field; the first frame launched K1 and K2 and no K3
    (on the card "auto" traces the bounce rays by K1; launch counters reset
    just before it, read just after); its HDR frame equals
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
    # the host routes (phase 12 drives the device routes)
    settings = TorchSettings(samples_per_frame=1, max_bounces=BOUNCES, clamp=20.0,
                             sky_intensity=0.35, sampler="sobol", device_dynamics=False,
                             device_motion=False)
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
    for k in ("closest", "occluded"):
        assert launches[k] > 0, f"TorchBackend.render never launched {k}"
    assert launches["items_closest"] == 0, "TorchBackend.render took the two-phase route"
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

# build_scene's spot cones (inner, outer) in degrees
SPOT_CONES = (25.0, 40.0)
APP_FRAMES = 5
PHYSICS_FRAMES = 5
PHYSICS_BODIES = 64
ORACLE_SIZES = ((96, 72), (480, 270))
ORACLE_TIMES = (0.2, 0.9)
ORACLE_RMSE = 1e-3  # tests/test_reference_backend.py's bar for the AOV modes
# tests/test_golden_configs.py's OBJ scene
OBJ_SRC = (
    "mtllib gold.mtl\n"
    "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
    "v -0.4 0 -0.4\nv 0.4 0 -0.4\nv 0 1.0 0\n"
    "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
    "vn 0 1 0\n"
    "usemtl floor\n"
    "f 1/1/1 3/3/1 2/2/1\nf 1/1/1 4/4/1 3/3/1\n"
    "usemtl pyramid\n"
    "f 5/1 6/2 7/3\n"
)
MTL_SRC = (
    "newmtl floor\nKd 0.6 0.62 0.65\nNs 40\n"
    "\nnewmtl pyramid\nKd 0.8 0.25 0.2\nNs 160\n"
)


def skinned_gltf() -> dict:
    """A small skinned glTF: a ribbon of 8 triangles (x in [-0.5, 0.5],
    y in [0, 2]) weighted between two joints (the tip joint at y = 1), one
    LINEAR animation turning the tip joint 60 degrees about z over one
    second; one embedded base64 buffer, no image."""
    import base64

    f32 = np.float32
    pos = np.array([[x, y, 0] for y in np.linspace(0, 2, 5) for x in (-0.5, 0.5)], f32)
    w1 = np.clip(pos[:, 1] - 0.5, 0, 1)
    parts = [
        ("VEC3", 5126, pos),
        ("VEC3", 5126, np.tile(np.array([0, 0, 1], f32), (10, 1))),
        ("VEC4", 5121, np.tile(np.array([0, 1, 0, 0], np.uint8), (10, 1))),
        ("VEC4", 5126, np.stack([1 - w1, w1, 0 * w1, 0 * w1], -1).astype(f32)),
        ("SCALAR", 5123, np.array([[2 * i, 2 * i + 1, 2 * i + 3, 2 * i, 2 * i + 3, 2 * i + 2]
                                   for i in range(4)], np.uint16).reshape(-1)),
        # inverse bind matrices, column-major: the identity and a move by -1 in y
        ("MAT4", 5126, np.stack([np.eye(4, dtype=f32),
                                 np.array([[1, 0, 0, 0], [0, 1, 0, -1], [0, 0, 1, 0],
                                           [0, 0, 0, 1]], f32)]).transpose(0, 2, 1)
         .reshape(2, 16)),
        ("SCALAR", 5126, np.array([0.0, 1.0], f32)),
        ("VEC4", 5126, np.array([[0, 0, 0, 1], [0, 0, np.sin(np.pi / 6), np.cos(np.pi / 6)]],
                                f32)),
    ]
    buf, views, accessors = b"", [], []
    for type_, ctype, arr in parts:
        raw = np.ascontiguousarray(arr).tobytes()
        views.append({"buffer": 0, "byteOffset": len(buf), "byteLength": len(raw)})
        accessors.append({"bufferView": len(views) - 1, "componentType": ctype,
                          "count": len(arr), "type": type_})
        buf += raw + b"\0" * (-len(raw) % 4)
    return {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode(), "byteLength": len(buf)}],
        "bufferViews": views, "accessors": accessors,
        "materials": [{"name": "ribbon", "pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.5, 0.2, 1], "metallicFactor": 0.0}}],
        "meshes": [{"name": "ribbon", "primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "JOINTS_0": 2, "WEIGHTS_0": 3},
            "indices": 4, "material": 0}]}],
        "skins": [{"joints": [0, 1], "inverseBindMatrices": 5}],
        "nodes": [{"name": "root", "children": [1]},
                  {"name": "tip", "translation": [0, 1, 0]},
                  {"name": "ribbon", "mesh": 0, "skin": 0}],
        "animations": [{"samplers": [{"input": 6, "output": 7, "interpolation": "LINEAR"}],
                        "channels": [{"sampler": 0,
                                      "target": {"node": 1, "path": "rotation"}}]}],
        "scenes": [{"nodes": [0, 2]}], "scene": 0,
    }


def sync_full(scene, backend) -> None:
    """Re-trigger every change feed of `scene`, then drain it into
    `backend` (the pump is consuming, so a second backend needs a full
    re-trigger; tests/test_reference_backend.py::sync_full)."""
    scene.meshes_3d.trigger_changed_all()
    scene.meshes_2d.trigger_changed_all()
    for il in scene.instances_2d.values():
        il.changed[il.active] = True
        il.any_changed = bool(il.active.any())
    scene.materials.materials.trigger_changed_all()
    scene.materials.textures.trigger_changed_all()
    scene._instances_changed = True
    scene.lights.point.trigger_changed_all()
    scene.lights.spot.trigger_changed_all()
    scene.lights.directional.trigger_changed_all()
    scene.lights.area_changed = True
    scene.skybox.trigger_changed()
    scene.skins.trigger_changed_all()
    scene.synchronize(backend)


def clocked_window(backend, n_frames: int, on_first=None):
    """A HeadlessWindow of W x H that scripts `n_frames` empty polls and
    keeps, per presented frame, its wall milliseconds (from the poll that
    began it to its present) and `backend`'s render ms and Mrays/s;
    `on_first()` runs at the first present."""
    from rfw_tpu_torch.app.window import HeadlessWindow

    class ClockedWindow(HeadlessWindow):
        def __init__(self):
            super().__init__(W, H, script=[[] for _ in range(n_frames)])
            self.frames = []
            self._t0 = None

        def poll_events(self):
            self._t0 = time.perf_counter()
            return super().poll_events()

        def present(self, frame):
            super().present(frame)
            self.frames.append(((time.perf_counter() - self._t0) * 1e3,
                                backend.stats["render_ms"].last(),
                                backend.stats["mrays_per_s"].last()))
            if self.presented == 1 and on_first is not None:
                on_first()

    return ClockedWindow()


def phase11(card, dev, parts, scene_np, camera) -> dict:
    """The app on the card: the flagship scene authored through the port's
    Instance and Scene and run through run_windowed; a physics system; the
    loaders, skinning and the numpy oracle. Returns the first frame's
    launches."""
    from rfw_tpu_torch.app import Instance
    from rfw_tpu_torch.backend.contract import RenderMode
    from rfw_tpu_torch.backend.lights import PointLightsView
    from rfw_tpu_torch.mathx import compose_trs, normalize, quat_identity
    from rfw_tpu_torch.render.cpu_reference import CpuReferenceBackend
    from rfw_tpu_torch.render.lights_pack import pack_lights
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
    from rfw_tpu_torch.scene import Camera3D, Scene
    from rfw_tpu_torch.utils.physics import SphereWorld

    t_phase = time.perf_counter()
    # ---- (a) the flagship scene through Instance and Scene (the host
    # routes; phase 12 drives the device routes)
    settings = TorchSettings(samples_per_frame=1, max_bounces=BOUNCES, clamp=20.0,
                             sky_intensity=0.35, sampler="sobol", device_dynamics=False,
                             device_motion=False)
    be = TorchBackend(W, H, settings)
    assert be.device.type == "cuda", be.device
    app = Instance(be, W, H)
    scene = app.scene
    mats = parts["materials"]
    for i, tex in mats.textures:
        if i > 0:  # slot 0: each store's own default texture
            assert scene.add_texture(tex) == i
    for i, mat in mats.materials:
        if i > 0:
            assert scene.add_material(dataclasses.replace(mat)) == i
    handles = {}
    for slot, mesh, _ in parts["meshes"]:
        assert scene.add_3d_object(mesh) == slot
    for slot, matrices in parts["instances"]:
        handles[slot] = [scene.add_3d_instance(slot, m) for m in matrices]
    spot, sun = parts["spot"], parts["sun"]
    for i in range(spot.count):
        scene.add_spot_light(spot.position[i], spot.direction[i], spot.energy[i], *SPOT_CONES)
    for i in range(sun.count):
        scene.add_directional_light(sun.direction[i], sun.energy[i])
    app.world.insert(camera)

    syncs = []  # per Scene.synchronize: (its ms in all, the backend's own)
    first = {}
    scene_sync = scene.synchronize

    def timed_sync(backend):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene_sync(backend)
        torch.cuda.synchronize()
        syncs.append(((time.perf_counter() - t0) * 1e3, be.stats["sync_ms"].last()))
        if not first:
            first.update(host=be._scene_host, lights=be._pack_lights())

    scene.synchronize = timed_sync  # what Instance's synchronize system calls
    launches = {}
    win = clocked_window(be, APP_FRAMES, lambda: launches.update(read_launches()))
    torch.cuda.synchronize()
    reset_launches()
    n = app.run_windowed(win, max_frames=APP_FRAMES)
    assert n == win.presented == APP_FRAMES, (n, win.presented)
    for f in scene_np._fields:
        a, b = getattr(scene_np, f), getattr(first["host"], f)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), \
            f"Scene.synchronize's first pack differs from build_scene's in {f}"
    # Scene normalizes light directions; build_scene hands its views over as
    # they are: the same lights with the directions normalized
    want = pack_lights(PointLightsView.empty(),
                       dataclasses.replace(spot, direction=normalize(spot.direction)),
                       dataclasses.replace(sun, direction=normalize(sun.direction)),
                       parts["area"])
    for f in want._fields:
        assert np.array_equal(getattr(want, f), getattr(first["lights"], f)), \
            f"Scene.synchronize's first lights differ in {f}"
    log(card, f"phase 11 (a): Instance(TorchBackend({W}, {H})) on {be.device}, the flagship "
              f"scene authored through app.scene; the first Scene.synchronize packs "
              f"build_scene's arenas in all {len(scene_np._fields)} TraceScene fields and its "
              f"lights (directions normalized); first synchronize {syncs[0][0]:.2f} ms in all, "
              f"{syncs[0][1]:.2f} ms of it in TorchBackend.synchronize (BLAS builds, pack, "
              f"upload), Scene.synchronize's own host work {syncs[0][0] - syncs[0][1]:.2f} ms")
    log(card, f"first frame through run_windowed: launches {launches}")
    for k in ("closest", "occluded"):
        assert launches[k] > 0, f"the app's first frame never launched {k}"
    assert launches["items_closest"] == 0, "the app's first frame took the two-phase route"
    frame = win.last_frame
    assert frame.shape == (H, W, 4) and frame.dtype == np.uint8 and frame[..., :3].std() > 1.0
    for i, (ms, render_ms, mrays) in enumerate(win.frames):
        log(card, f"app frame {i}: {ms:.2f} ms in all (poll to present), render "
                  f"{render_ms:.2f} ms, {mrays:.3f} Mrays/s; Scene.synchronize "
                  f"{syncs[i][0]:.3f} ms, its own host work {syncs[i][0] - syncs[i][1]:.3f} ms")
    steady = [f[0] for f in win.frames[1:]]
    log(card, f"app frames 1-{APP_FRAMES - 1}: {np.mean(steady):.2f} ms mean, "
              f"{min(steady):.2f}-{max(steady):.2f} ms; Scene.synchronize's own host work "
              f"{np.mean([a - b for a, b in syncs[1:]]):.3f} ms mean, "
              f"{np.mean([a - b for a, b in syncs[1:]]) / np.mean(steady):.5f} of a frame")

    # ---- (b) a physics system: SphereWorld drives 64 sphere instances
    world = SphereWorld.new()
    bodies = handles[0][:PHYSICS_BODIES]
    radii = []
    for h in bodies:
        m = h.get_matrix()
        radii.append(float(m[0, 0]))
        world.add_sphere(m[:3, 3] + np.array([0, 2.0, 0], np.float32), radius=radii[-1])
    start = np.stack([h.get_matrix() for h in bodies])

    def physics(w):
        world.step(1.0 / 30.0)
        for i, h in enumerate(bodies):
            h.set_trs(world.positions[i], (0, 0, 0, 1), (radii[i],) * 3)
        scene._instances_changed = True  # handle edits do not raise the scene's flag

    routes = Counter()
    for name in ("_sync_instances", "_rebuild_scene"):
        def counted(*a, _fn=getattr(be, name), _name=name, **k):
            routes[_name] += 1
            return _fn(*a, **k)
        setattr(be, name, counted)
    geo = be._scene_dev.tri_v0
    app.with_system(physics)
    syncs.clear()
    pwin = clocked_window(be, PHYSICS_FRAMES)
    assert app.run_windowed(pwin, max_frames=PHYSICS_FRAMES) == PHYSICS_FRAMES
    taken = dict(routes)
    assert routes == Counter(_sync_instances=PHYSICS_FRAMES), \
        f"the physics frames took the routes {taken}, not one motion sync each"
    assert be._scene_dev.tri_v0 is geo, "a physics frame re-uploaded geometry"
    moved = np.abs(np.stack([h.get_matrix() for h in bodies]) - start).max()
    assert moved > 0.1, f"the bodies moved only {moved}"
    after = be._scene_host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    be._rebuild_scene()
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t0) * 1e3
    for f in after._fields:
        assert np.array_equal(getattr(after, f), getattr(be._scene_host, f)), \
            f"the physics frames' arenas and a full repack differ in {f}"
    for i, (ms, render_ms, mrays) in enumerate(pwin.frames):
        log(card, f"physics frame {i}: {ms:.2f} ms in all, Scene.synchronize "
                  f"{syncs[i][0]:.2f} ms ({syncs[i][1]:.2f} ms of it TorchBackend.synchronize: "
                  f"a motion sync of {PHYSICS_BODIES} bodies, repack_instances), render "
                  f"{render_ms:.2f} ms, {mrays:.3f} Mrays/s")
    log(card, f"phase 11 (b): {PHYSICS_FRAMES} physics frames, "
              f"{np.mean([f[0] for f in pwin.frames]):.2f} ms "
              f"mean; one motion sync a frame (routes {taken}); the last frame's arenas "
              f"equal a full repack of the same state ({full_ms:.2f} ms, BLAS cached); the "
              f"bodies moved up to {moved:.3f}")

    # ---- (c) the loaders, skinning and the numpy oracle
    import tempfile

    small = Scene()
    aov = TorchSettings(samples_per_frame=1, max_bounces=0, pixel_center=True)
    with tempfile.TemporaryDirectory() as d:
        Path(d, "gold.mtl").write_text(MTL_SRC)
        Path(d, "gold.obj").write_text(OBJ_SRC)
        Path(d, "ribbon.gltf").write_text(json.dumps(skinned_gltf()))
        obj = small.add_3d(small.load(str(Path(d, "gold.obj"))))
        small.add_3d_instance(obj, compose_trs(np.array([3.2, 0, 0.3], np.float32),
                                               quat_identity(), np.ones(3, np.float32)))
        ribbon = small.add_3d(small.load(str(Path(d, "ribbon.gltf"))))
    small.add_directional_light((0.3, -1, -0.4), (2.0, 1.9, 1.8))
    cam = Camera3D(fov=50).look_at(np.array([1.4, 2.0, 5.2], np.float32),
                                   np.array([1.2, 0.6, 0.0], np.float32))
    modes = (RenderMode.NORMAL, RenderMode.ALBEDO, RenderMode.GBUFFER)
    backends = {wh: (TorchBackend(*wh, aov), CpuReferenceBackend(*wh, aov)) for wh in ORACLE_SIZES}
    frames = {}
    for t in ORACLE_TIMES:
        small.set_animations_time(t)
        for (w, h), (card_be, oracle) in backends.items():
            sync_full(small, card_be)
            sync_full(small, oracle)
            view = cam.get_view(w, h)
            for mode in modes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = card_be.render(None, view, mode)
                card_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                ref = oracle.render(None, view, mode)
                oracle_ms = (time.perf_counter() - t0) * 1e3
                e = float(np.sqrt(np.mean((got[..., :3].astype(np.float32) / 255.0
                                           - ref[..., :3].astype(np.float32) / 255.0) ** 2)))
                log(card, f"oracle t={t} {w}x{h} {mode.name}: RMSE {e:.6f} (bar "
                          f"{ORACLE_RMSE}), {(got != ref).any(-1).mean():.6f} of pixels differ; "
                          f"card {card_ms:.2f} ms, CpuReferenceBackend {oracle_ms:.2f} ms")
                assert got.shape == ref.shape == (h, w, 4)
                assert e <= ORACLE_RMSE, f"{mode.name} {w}x{h} t={t}: RMSE {e} against the oracle"
                frames[t, w, mode] = got
    for (w, h) in ORACLE_SIZES:
        for mode in modes:
            differ = (frames[ORACLE_TIMES[0], w, mode] != frames[ORACLE_TIMES[1], w, mode]).any(-1)
            assert differ.any(), f"{mode.name} {w}x{h}: the two animation times give one frame"
        log(card, f"{w}x{h}: the animation times {ORACLE_TIMES} differ on "
                  f"{differ.mean():.4f} of the GBUFFER frame's pixels")
    jm = ribbon.graph.skins[0].joint_matrices
    assert np.isfinite(jm).all() and jm.shape == (2, 4, 4)
    log(card, f"phase 11: {time.perf_counter() - t_phase:.2f} s")
    return launches


# ---- phase 12: dynamics and the random sampler
DYN_FRAMES = 8
TUBE_RINGS, TUBE_SEGMENTS, TUBE_JOINTS = 160, 64, 24  # 20,480 triangles
TUBE_SLOT = 6
# the device TLAS build's instance counts: phase 8's (whose Morton tree
# outgrows the host collapse's padded rows, so the gate keeps the host
# collapse) and one the gate lets through
TLAS_COUNTS = (N_HEAVY, 4000)
# tests/test_torch_wavefront.py's radiance tolerance, and
# tests/test_refit_device.py's on the refit arenas
PX_ATOL = PX_RTOL = 1e-3
PX_SHARE = 0.99
REFIT_TOL = 1e-4


def skinned_tube(material_id: int):
    """A closed tube of TUBE_RINGS x TUBE_SEGMENTS quads (20,480 triangles),
    radius 0.6 and height 6 along y, skinned to a chain of TUBE_JOINTS
    joints along its axis (each vertex blends its two nearest joints), with
    two morph targets: a radial bulge (with normal deltas) and a shear in
    x."""
    from rfw_tpu_torch.models.mesh3d import build_mesh3d

    rings, seg = TUBE_RINGS + 1, TUBE_SEGMENTS
    y = np.repeat(np.linspace(0.0, 6.0, rings), seg)
    a = np.tile(np.arange(seg) * (2 * np.pi / seg), rings)
    radial = np.stack([np.cos(a), np.zeros_like(a), np.sin(a)], 1)
    pos = (radial * 0.6 + np.stack([0 * y, y, 0 * y], 1)).astype(np.float32)
    uvs = np.stack([a / (2 * np.pi), y / 6.0], 1).astype(np.float32)
    r, s = np.meshgrid(np.arange(TUBE_RINGS), np.arange(seg), indexing="ij")
    v00, v01 = r * seg + s, r * seg + (s + 1) % seg
    v10, v11 = v00 + seg, v01 + seg
    idx = np.concatenate([np.stack([v00, v11, v10], -1).reshape(-1, 3),
                          np.stack([v00, v01, v11], -1).reshape(-1, 3)]).astype(np.int32)
    f = y / 6.0 * (TUBE_JOINTS - 1)
    j0 = np.minimum(np.floor(f), TUBE_JOINTS - 2).astype(np.int32)
    w1 = (f - j0).astype(np.float32)
    joints = np.stack([j0, j0 + 1, 0 * j0, 0 * j0], 1).astype(np.int32)
    weights = np.stack([1 - w1, w1, 0 * w1, 0 * w1], 1).astype(np.float32)
    bulge = (radial * (0.25 * np.sin(np.pi * y / 6.0))[:, None]).astype(np.float32)
    shear = np.stack([0.4 * y / 6.0, 0 * y, 0 * y], 1).astype(np.float32)
    d_nrm = np.zeros((2,) + pos.shape, np.float32)
    d_nrm[0, :, 1] = -0.3 * np.cos(np.pi * y / 6.0)  # the bulge's slope
    return build_mesh3d(pos, idx, normals=radial.astype(np.float32), uvs=uvs,
                        material_ids=material_id, joints=joints, weights=weights,
                        name="tube", morph_targets=np.stack([bulge, shear]),
                        morph_normals=d_nrm)


def tube_pose(t: float) -> np.ndarray:
    """The chain's (TUBE_JOINTS, 4, 4) skinning matrices at time t: joint
    j turns about z by 0.06 sin(t + 0.4 j) at its pivot on the axis,
    composed down the chain."""
    out, m = [], np.eye(4)
    for j in range(TUBE_JOINTS):
        th = 0.06 * np.sin(t + 0.4 * j)
        rot = np.eye(4)
        rot[0, 0], rot[0, 1], rot[1, 0], rot[1, 1] = np.cos(th), -np.sin(th), np.sin(th), np.cos(th)
        piv = np.eye(4)
        piv[1, 3] = j * 6.0 / (TUBE_JOINTS - 1)
        m = m @ piv @ rot @ np.linalg.inv(piv)
        out.append(m)
    return np.stack(out).astype(np.float32)


def feed_flagship(be, parts, extra_meshes=(), extra_instances=()):
    """The flagship scene through the contract (phase 10's calls), with
    extra meshes and instance views."""
    from rfw_tpu_torch.backend import InstancesView3D

    meshes = {slot: mesh for slot, mesh, _ in parts["meshes"]}
    views = []
    for slot, m in parts["instances"]:
        n = m.shape[0]
        views.append((slot, InstancesView3D(
            matrices=m, skin_ids=np.full(n, -1, np.int32), changed=np.ones(n, bool),
            local_aabb_min=meshes[slot].aabb_min, local_aabb_max=meshes[slot].aabb_max)))
    mats = parts["materials"]
    be.set_3d_meshes([(slot, mesh.view()) for slot, mesh in meshes.items()]
                     + list(extra_meshes))
    be.set_3d_instances(views + list(extra_instances))
    be.set_materials(mats.to_device(), [i for i, _ in mats.materials])
    be.set_textures([(i, t.view()) for i, t in mats.textures])
    for name, setter in (("spot", be.set_spot_lights), ("sun", be.set_directional_lights),
                         ("area", be.set_area_lights)):
        if name in parts:
            setter(parts[name])
    be.synchronize()


def phase12a(card, parts, camera, settings):
    """Device dynamics: the flagship scene plus four instances of the
    skinned, morphed tube under two skins, 8 animated frames by the device
    route against the host route. Returns the first dynamic frame's
    launches."""
    import rfw_tpu_torch.render.torch_backend as tb
    from rfw_tpu_torch.backend import InstancesView3D, SkinView
    from rfw_tpu_torch.render import refit_device
    from rfw_tpu_torch.render.torch_backend import TorchBackend

    tube = skinned_tube(next(i for i, m in parts["materials"].materials
                             if m.name == "diffuse"))
    spots = np.array([[-4.5, 0, -4.5], [4.5, 0, -4.5], [-4.5, 0, 4.5], [4.5, 0, 4.5]], np.float32)
    mats = np.stack([np.eye(4, dtype=np.float32)] * 4)
    mats[:, :3, 3] = spots
    skin_ids = np.array([0, 0, 1, 1], np.int32)

    def frame_calls(t, lag=1.3):
        """Skin 1 lags skin 0 by `lag`; its instances' weights by as much."""
        w = np.array([[0.5 + 0.5 * np.sin(t), 0.5 + 0.5 * np.cos(t)]] * 2
                     + [[0.5 + 0.5 * np.sin(t - lag), 0.5 + 0.5 * np.cos(t - lag)]] * 2,
                     np.float32)
        iv = InstancesView3D(matrices=mats, skin_ids=skin_ids, changed=np.ones(4, bool),
                             local_aabb_min=tube.aabb_min, local_aabb_max=tube.aabb_max,
                             morph_weights=w)
        skins = [(0, SkinView(joint_matrices=tube_pose(t))),
                 (1, SkinView(joint_matrices=tube_pose(t - lag)))]
        return skins, [(TUBE_SLOT, iv)]

    view = camera.get_view(W, H)
    backends = {"device": TorchBackend(W, H, settings),
                "host": TorchBackend(W, H, dataclasses.replace(settings, device_dynamics=False))}
    assert backends["device"].settings.device_dynamics and backends["device"].device.type == "cuda"
    for be in backends.values():
        # both pose groups start in one pose: the first pack builds one BLAS
        # topology for both, which the host route's later repacks refit (a
        # group's own first build would differ from the cached one)
        skins, inst = frame_calls(0.0, lag=0.0)
        be.set_skins(skins)
        feed_flagship(be, parts, [(TUBE_SLOT, tube.view())], inst)
        be.render(None, view)
    dyn = backends["device"]._dyn
    n_levels = sum(len(p.levels) + len(p.levels8) for p in dyn["plans"])
    log(card, f"phase 12 (a): flagship scene + {tube.indices.shape[0]}-triangle tube "
              f"({TUBE_JOINTS} joints in a chain, 2 morph targets), 4 instances under 2 skins: "
              f"{len(dyn['plans'])} deform units, {n_levels} BVH levels to refit, "
              f"{dyn['tlas_plan'].passes_shape.shape[0]} Jacobi sweeps over the TLAS; "
              f"{backends['device']._scene_host.tri_v0.shape[0]} triangle rows")

    uploads, routes = [], Counter()
    real_to_tensor = tb.to_tensor

    def counted_upload(x, device):
        uploads.append(np.asarray(x).nbytes)
        return real_to_tensor(x, device)

    dev_be = backends["device"]
    for name in ("_rebuild_scene", "_apply_device_dynamics"):
        def counted(*a, _fn=getattr(dev_be, name), _name=name, **k):
            routes[_name] += 1
            return _fn(*a, **k)
        setattr(dev_be, name, counted)
    host_before = dev_be._scene_host
    sync_ms = defaultdict(list)
    render_ms = defaultdict(list)
    launches = {}
    with patched(tb, to_tensor=counted_upload):
        for k in range(DYN_FRAMES):
            skins, inst = frame_calls(0.35 * (k + 1))
            for name, be in backends.items():
                if k == 0 and name == "device":
                    torch.cuda.synchronize()
                    reset_launches()
                be.set_skins(skins)
                be.set_3d_instances(inst)
                be.synchronize()
                sync_ms[name].append(be.stats["sync_ms"].last())
                be.render(None, view)
                render_ms[name].append(be.stats["render_ms"].last())
                if k == 0 and name == "device":
                    launches = read_launches()
                    device_uploads = sum(uploads)
    log(card, f"first dynamic frame (device route): launches {launches}")
    for kind in ("closest", "occluded"):
        assert launches[kind] > 0, f"the first dynamic frame never launched {kind}"
    assert launches["items_closest"] == 0, "the first dynamic frame took the two-phase route"
    assert routes == Counter(_apply_device_dynamics=DYN_FRAMES), \
        f"the dynamic syncs took the routes {dict(routes)}"
    assert dev_be._scene_host is host_before, "a dynamic sync repacked"
    log(card, f"device route: {DYN_FRAMES} syncs, routes {dict(routes)}, uploads of the first "
              f"sync {device_uploads} B (joint matrices and morph weights), no repack")
    assert device_uploads < 64 * 1024, f"the dynamic sync uploaded {device_uploads} B"
    for name in backends:
        log(card, f"{name} route: sync ms per frame "
                  f"{', '.join(f'{x:.2f}' for x in sync_ms[name])}; render ms "
                  f"{', '.join(f'{x:.2f}' for x in render_ms[name])}")
    dev_sync, host_sync = np.mean(sync_ms["device"][1:]), np.mean(sync_ms["host"][1:])
    log(card, f"dynamic sync, frames 1-{DYN_FRAMES - 1}: device route {dev_sync:.2f} ms mean "
              f"({min(sync_ms['device'][1:]):.2f}-{max(sync_ms['device'][1:]):.2f}), host "
              f"route {host_sync:.2f} ms mean ({min(sync_ms['host'][1:]):.2f}-"
              f"{max(sync_ms['host'][1:]):.2f}): {host_sync / dev_sync:.2f}x")

    # the last frame's arenas against a full host repack of the same pose
    # (the host route's last pack), on the fields tests/test_refit_device.py
    # compares; the TLAS topologies differ (the refit keeps the first)
    dev, host = dev_be._scene_dev, backends["host"]._scene_host
    worst = 0.0
    for f in refit_device.UNIT_FIELDS + ("inst_aabb_min", "inst_aabb_max"):
        a, b = getattr(dev, f).cpu().numpy(), getattr(host, f)
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), f
        np.testing.assert_allclose(a[fin], b[fin], rtol=REFIT_TOL, atol=REFIT_TOL, err_msg=f)
        worst = max(worst, float(np.abs(a[fin] - b[fin]).max()))
    hd, hh = dev_be.hdr_frame(), backends["host"].hdr_frame()
    share = float((np.abs(hd - hh) <= PX_ATOL + PX_RTOL * np.abs(hh)).all(axis=-1).mean())
    rel = float(abs(hd.mean() - hh.mean()) / hh.mean())
    log(card, f"last dynamic frame: device arenas within {worst:.3e} of the host repack's "
              f"(bar {REFIT_TOL} abs + rel); HDR frame vs the host route's: {share:.6f} of "
              f"pixels within {PX_ATOL} abs + {PX_RTOL} rel, mean {hd.mean():.6f} vs "
              f"{hh.mean():.6f} ({rel:.2e} relative)")
    assert np.isfinite(hd).all() and share >= PX_SHARE and rel <= 1e-3, \
        "the device route's frame disagrees with the host route's"

    # the device refit alone, and its TLAS sweep alone
    poses = [torch.from_numpy(tube_pose(9.0)).to(dev.tri_v0.device)] * len(dyn["plans"])
    morphs = [torch.tensor([0.3, 0.7], device=dev.tri_v0.device)] * len(dyn["plans"])
    apply_ms = cuda_ms(lambda: refit_device.apply_dynamic(
        dev, dyn["plans"], dyn["tlas_plan"], poses, morphs), 5)
    tlas_ms = cuda_ms(lambda: refit_device._refit_tlas(
        dev, dyn["tlas_plan"], dev.inst_aabb_min, dev.inst_aabb_max), 5)
    log(card, f"apply_dynamic alone: {apply_ms:.3f} ms ({len(dyn['plans'])} units, their level "
              f"loops and the TLAS sweeps, eager); its TLAS refit alone {tlas_ms:.3f} ms")
    return dict(launches=launches, sync_ms=sync_ms, apply_ms=apply_ms, tlas_ms=tlas_ms)


def phase12b(card, parts, camera, settings):
    """Device motion: the 256 sphere instances of the flagship scene moved
    for 8 frames by the device route (TorchSettings' default device_motion)
    against the host rebuild (device_motion=False)."""
    import rfw_tpu_torch.render.torch_backend as tb
    from rfw_tpu_torch.backend import InstancesView3D
    from rfw_tpu_torch.render.torch_backend import TorchBackend

    view = camera.get_view(W, H)
    backends = {"device": TorchBackend(W, H, settings),
                "host": TorchBackend(W, H, dataclasses.replace(settings, device_motion=False))}
    assert backends["device"].settings.device_motion, "RFW_DEVICE_MOTION turned it off"
    for be in backends.values():
        feed_flagship(be, parts)
        be.render(None, view)
    meshes = {slot: mesh for slot, mesh, _ in parts["meshes"]}
    rng = np.random.default_rng(SEED + 12)
    spheres = [(slot, m.copy()) for slot, m in parts["instances"][:4]]
    n_moved = sum(m.shape[0] for _, m in spheres)
    repacks = Counter()
    real = tb.repack_instances

    def counted(*a, **k):
        repacks["n"] += 1
        return real(*a, **k)

    geo = backends["device"]._scene_dev.tri_v0
    sync_ms, frames = defaultdict(list), {}
    differ = []
    with patched(tb, repack_instances=counted):
        for k in range(DYN_FRAMES):
            moved = []
            for slot, m in spheres:
                m[:, :3, 3] += rng.uniform(-0.15, 0.15, (m.shape[0], 3)).astype(np.float32)
                n = m.shape[0]
                moved.append((slot, InstancesView3D(
                    matrices=m.copy(), skin_ids=np.full(n, -1, np.int32),
                    changed=np.ones(n, bool), local_aabb_min=meshes[slot].aabb_min,
                    local_aabb_max=meshes[slot].aabb_max)))
            for name, be in backends.items():
                if name == "device":
                    before = repacks["n"]
                be.set_3d_instances(moved)
                be.synchronize()
                if name == "device":
                    assert repacks["n"] == before, "a device motion sync repacked on the host"
                sync_ms[name].append(be.stats["sync_ms"].last())
                frames[name] = be.render(None, view)
            d = (frames["device"] != frames["host"]).any(-1)
            differ.append(int(d.sum()))
    dev_be = backends["device"]
    assert dev_be._motion_syncs == DYN_FRAMES and dev_be._scene_dev.tri_v0 is geo
    assert repacks["n"] == DYN_FRAMES, f"host route repacks {repacks['n']}"
    for name in backends:
        log(card, f"phase 12 (b) {name} route: motion sync of {n_moved} instances, ms per "
                  f"frame {', '.join(f'{x:.2f}' for x in sync_ms[name])}")
    dm, hm = np.mean(sync_ms["device"][1:]), np.mean(sync_ms["host"][1:])
    log(card, f"motion sync, frames 1-{DYN_FRAMES - 1}: device route {dm:.2f} ms mean "
              f"({min(sync_ms['device'][1:]):.2f}-{max(sync_ms['device'][1:]):.2f}; zero "
              f"repack_instances calls in {DYN_FRAMES} syncs), host rebuild {hm:.2f} ms mean "
              f"({min(sync_ms['host'][1:]):.2f}-{max(sync_ms['host'][1:]):.2f})")
    diff = np.abs(frames["device"].astype(np.int32) - frames["host"].astype(np.int32)).max(-1)
    log(card, f"device-route frames vs the host rebuild's: differing pixels per frame "
              f"{differ} of {W * H}; the last frame's largest difference {diff.max()}, "
              f"{int((diff > 1).sum())} pixels off by more than 1")
    # the refit keeps the first TLAS topology and computes the instance
    # inverses on the card, so hits agree but for exact-t ties and
    # last-ulp t; a differing pixel is counted and printed
    assert max(differ) <= 1e-3 * W * H, f"motion frames differ on {max(differ)} pixels"

    # the device refit alone
    mo = dev_be._motion
    mats = dev_be._scene_dev.inst_matrix.clone()
    refit_ms = cuda_ms(lambda: tb.refit_device.instance_motion_update(
        dev_be._scene_dev, mo["plan"], mats, mo["lmin"], mo["lmax"], mo["live"]), 5)
    log(card, f"instance_motion_update alone: {refit_ms:.3f} ms "
              f"({mo['plan'].passes_shape.shape[0]} Jacobi sweeps, eager)")
    return dict(sync_ms=sync_ms, differ=differ, refit_ms=refit_ms)


def phase12c(card, dev, settings):
    """The device TLAS build: one motion sync of the instance-heavy scene
    with device_motion=False, at phase 8's instance count and at one whose
    Morton tree fits the host collapse's padded rows; K1 on the 1080p
    primaries over the device-built tree and over the host collapse."""
    import rfw_tpu_torch.render.torch_backend as tb
    from rfw_tpu_torch.accel.tlas_device import tlas8_node_count
    from rfw_tpu_torch.backend import InstancesView3D
    from rfw_tpu_torch.convert import to_tensor
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.render.torch_backend import TorchBackend
    from rfw_tpu_torch.render.wavefront import camera_rays_c
    from rfw_tpu_torch.scenes import build_heavy_scene

    out = {}
    for n_req in TLAS_COUNTS:
        scene_np, _, _, _, camera, parts = build_heavy_scene(SEED + 1, n_req, views=True)
        be = TorchBackend(W, H, dataclasses.replace(settings, device_motion=False))
        feed_flagship(be, parts)
        n_inst = int((be._scene_host.inst_mesh >= 0).sum())
        meshes = {slot: mesh for slot, mesh, _ in parts["meshes"]}
        rng = np.random.default_rng(SEED + 13)
        moved = []
        for slot, m in parts["instances"]:
            m = m.copy()
            m[:, :3, 3] += rng.uniform(-0.2, 0.2, (m.shape[0], 3)).astype(np.float32)
            moved.append((slot, InstancesView3D(
                matrices=m, skin_ids=np.full(m.shape[0], -1, np.int32),
                changed=np.ones(m.shape[0], bool), local_aabb_min=meshes[slot].aabb_min,
                local_aabb_max=meshes[slot].aabb_max)))
        calls = Counter()
        real = tb.build_tlas8_device

        def counted(*a, **k):
            calls["n"] += 1
            return real(*a, **k)

        be.set_3d_instances(moved)
        with patched(tb, build_tlas8_device=counted):
            be.synchronize()
        sync_ms = be.stats["sync_ms"].last()
        rows, need = be._scene_host.tlas8_box.shape[0], tlas8_node_count(n_inst)
        log(card, f"phase 12 (c) {n_inst} instances: motion sync {sync_ms:.2f} ms (host SAH "
                  f"rebuild), the Morton tree needs {need} supernodes, the host collapse's "
                  f"padded arrays hold {rows}: build_tlas8_device ran {calls['n']} time(s)")
        assert calls["n"] == (1 if need <= rows else 0)
        if not calls["n"]:
            out[n_inst] = dict(sync_ms=sync_ms, device_tlas=False)
            continue
        # the same scene with the host collapse's tlas8 mirror
        sd = be._scene_dev
        host8 = sd._replace(**{f: to_tensor(getattr(be._scene_host, f), dev)
                               for f in ("tlas8_box", "tlas8_code", "tlas8_cnt")})
        view = torch.from_numpy(camera.get_view(W, H).as_array()).to(dev)
        o, d = camera_rays_c(view, W, H, jitter=(
            torch.full((W * H, 2), 0.5, device=dev), torch.zeros((W * H, 2), device=dev)))
        o, d = torch.stack(o, 1), torch.stack(d, 1)
        hits = {}
        for name, s in (("device tree", sd), ("host collapse", host8)):
            ps = tr.prepare_scene(s)
            hits[name], ms = timed(lambda: tr.closest_hit(ps, o, d))
            log(card, f"K1 on the {W}x{H} primaries over the {name}: {ms:.4f} ms")
        a, b = hits["device tree"], hits["host collapse"]
        mask_a, mask_b = a.prim >= 0, b.prim >= 0
        assert torch.equal(mask_a, mask_b), "hit masks differ between the two TLAS trees"
        assert torch.equal(bits(a.t), bits(b.t)), "t differs between the two TLAS trees"
        # t is identical on every ray, so a ray whose ids differ hit two
        # triangles at the same t: an exact-t tie that the walk order breaks
        ties = int(((a.prim != b.prim) | (a.inst != b.inst)).sum())
        log(card, f"K1 over the device-built tree vs the host collapse: hit masks and t "
                  f"identical ({int(mask_a.sum())} hits), ids differ on {ties} rays (exact-t "
                  f"ties: t identical)")
        out[n_inst] = dict(sync_ms=sync_ms, device_tlas=True, ties=ties)
        del be, sd, host8
    return out


def phase12d(card, dev, scene, mats, atlas, lights, view, base):
    """threefry on the card: one 1080p sample with sampler="random", every
    uniform it drew against the same call on the CPU; ms per sample against
    "sobol"."""
    from rfw_tpu_torch.render import threefry
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample

    cfg_r = RenderConfig(**{**base, "two_phase": "on", "sampler": "random"})
    cfg_s = dataclasses.replace(cfg_r, sampler="sobol")
    key = threefry.fold_in(threefry.PRNGKey(42), 0)
    drawn = []
    real = threefry.uniform

    def recorded(k, shape, device=None):
        u = real(k, shape, device=device)
        drawn.append((k.clone(), tuple(shape), u.cpu()))
        return u

    with patched(threefry, uniform=recorded):
        res = render_sample(scene, mats, atlas, lights, view, W, H, cfg_r, key=key)
    torch.cuda.synchronize()
    for k, shape, u in drawn:
        assert u.device.type == "cpu" and torch.equal(u, real(k, shape)), \
            f"threefry uniform {shape} differs between the card and the CPU"
    n = sum(u.numel() for _, _, u in drawn)
    log(card, f"phase 12 (d): one {W}x{H} sample with sampler=\"random\" drew {len(drawn)} "
              f"uniform calls ({n} floats) on the card, each identical to the same call on "
              f"the CPU")
    rad = res.radiance
    assert bool(torch.isfinite(rad).all()) and rad.mean().item() > 0
    times = defaultdict(list)
    means = {}
    for label, cfg in (("sobol", cfg_s), ("random", cfg_r), ("random", cfg_r),
                       ("sobol", cfg_s)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = render_sample(scene, mats, atlas, lights, view, W, H, cfg, sample_index=1,
                          key=key).radiance
        torch.cuda.synchronize()
        times[label].append((time.perf_counter() - t0) * 1e3)
        means[label] = r.mean().item()
    u_ms = cuda_ms(lambda: real(key, (W * H, 3), device=dev), 10)
    log(card, f"ms per sample, in turns sobol, random, random, sobol: sobol "
              f"{', '.join(f'{x:.2f}' for x in times['sobol'])}, random "
              f"{', '.join(f'{x:.2f}' for x in times['random'])}; mean radiance sobol "
              f"{means['sobol']:.6f}, random {means['random']:.6f}; one threefry uniform of "
              f"({W * H}, 3) {u_ms:.4f} ms")
    assert abs(means["random"] - means["sobol"]) <= 0.05 * means["sobol"], \
        "the random and sobol samples disagree on the mean radiance"
    return dict(times=times, uniform_ms=u_ms)


def phase12(card, dev, parts, camera, scene, mats, atlas, lights, view, base):
    """Dynamics and the random sampler on the card (TorchSettings' defaults:
    device_dynamics, device_motion). Returns the first dynamic frame's
    launches."""
    from rfw_tpu_torch.render.torch_backend import TorchSettings

    t_phase = time.perf_counter()
    settings = TorchSettings(samples_per_frame=1, max_bounces=BOUNCES, clamp=20.0,
                             sky_intensity=0.35, sampler="sobol")
    a = phase12a(card, parts, camera, settings)
    phase12b(card, parts, camera, settings)
    phase12c(card, dev, settings)
    phase12d(card, dev, scene, mats, atlas, lights, view, base)
    log(card, f"phase 12: {time.perf_counter() - t_phase:.2f} s")
    return a["launches"]


# ------------------------------------------------------------------ phase 13
N_STRIPS = 4
PAR_SPP = 4
EXAMPLE_TIMEOUT = 300
# each example counterpart as a user runs it, with its output in a
# temporary directory (OUT) and, for those that loop, the frame count
EXAMPLES = (
    ("torch_cornell.py", ["--size", "256", "--spp", "4", "--out", "OUT/cornell.png"]),
    ("torch_physics.py", ["--balls", "64", "--frames", "4", "--out-dir", "OUT/physics"]),
    ("torch_d2.py", ["--frames", "2", "--out-dir", "OUT/d2"]),
    ("torch_interactive.py", ["--no-pica", "--frames", "2", "--port", "0"]),
)


def _ray_keys(o, d, tl) -> torch.Tensor:
    """An int64 hash of each ray's bits (origin, direction, t_limit)."""
    cols = torch.cat([o, d, tl[:, None]], dim=1).contiguous().view(torch.int32).long()
    h = torch.zeros(cols.shape[0], dtype=torch.int64, device=cols.device)
    for j in range(cols.shape[1]):
        h = (h ^ (cols[:, j] & 0xFFFFFFFF)) * 0x100000001B3 + j
    return h


def capture_hits(run):
    """Run `run()` with render_sample's traversal calls recorded (primaries,
    shadows, the two-phase bounce calls): returns (run()'s result,
    {"closest": (keys, t, prim, inst), "occluded": (keys, flags)}) over the
    live rays (t_limit > 0) of every call; the calls still run."""
    from rfw_tpu_torch.render import wavefront as wf

    rec = defaultdict(list)

    def recorder(kind, fn):
        def record(ps, o, d, tl, **kw):
            out = fn(ps, o, d, tl, **kw)
            tl = torch.as_tensor(tl, dtype=torch.float32, device=o.device).expand(o.shape[0])
            live = tl > 0
            keys = _ray_keys(o[live], d[live], tl[live])
            if kind == "closest":
                rec[kind].append((keys, out.t[live], out.prim[live], out.inst[live]))
            else:
                rec[kind].append((keys, out[live]))
            return out
        return record

    with patched(wf, closest_hit=recorder("closest", wf.closest_hit),
                 occluded=recorder("occluded", wf.occluded),
                 twophase_closest_with_fallback=recorder(
                     "closest", wf.twophase_closest_with_fallback)):
        res = run()
    return res, {k: tuple(torch.cat(c) for c in zip(*v)) for k, v in rec.items()}


def match_hits(full: dict, strips: dict) -> dict:
    """Each live strip ray matched by its bits to the full frame's same ray:
    counts of rays not found (a path that left the full frame's after a
    tie), closest hits with the same t but other ids (exact-t ties), with
    another t, and occlusion flags that differ."""
    out = {}
    for kind in ("closest", "occluded"):
        fk, sk = full[kind][0], strips[kind][0]
        order = torch.argsort(fk)
        fs = fk[order]
        idx = torch.searchsorted(fs, sk).clamp(max=fs.shape[0] - 1)
        found = fs[idx] == sk
        j = order[idx[found]]
        out[f"{kind}_rays"] = int(sk.shape[0])
        out[f"{kind}_unmatched"] = int((~found).sum())
        f_vals = [x[j] for x in full[kind][1:]]
        s_vals = [x[found] for x in strips[kind][1:]]
        if kind == "closest":
            same_t = bits(f_vals[0]) == bits(s_vals[0])
            other_id = (f_vals[1] != s_vals[1]) | (f_vals[2] != s_vals[2])
            out["ties"] = int((same_t & other_id).sum())
            out["t_differs"] = int((~same_t).sum())
        else:
            out["flags_differ"] = int((f_vals[0] != s_vals[0]).sum())
    return out


def phase13a(card, scene, mats, atlas, lights, view, base):
    """Strips in turn: the 1080p frame as four row0 strips of 270 rows, one
    after another, against the full frame (phase 5's settings,
    two_phase="on", Sobol): differing pixels, each strip ray matched to
    the full frame's (exact-t ties counted); the strips' time against one
    full-frame sample; the launches of one strip's counted run."""
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample

    cfg = RenderConfig(**{**base, "two_phase": "on"})
    hs = H // N_STRIPS

    def full():
        return render_sample(scene, mats, atlas, lights, view, W, H, cfg, sample_index=5)

    def strip(k):
        return render_sample(scene, mats, atlas, lights, view, W, hs, cfg, sample_index=5,
                             row0=k * hs)

    strip(1)  # warm-up of the strip's shapes
    torch.cuda.synchronize()
    reset_launches()
    strip(1)
    torch.cuda.synchronize()
    launches = read_launches()
    log(card, f"phase 13 (a): one counted strip (rows {hs}-{2 * hs - 1} of {H}) launched "
              f"{ {k: n for k, n in launches.items() if n} }")
    for kind in ("closest", "occluded", "items_closest"):
        assert launches[kind] > 0, f"the strip never launched the {kind} kernel"

    ref, hits_full = capture_hits(full)
    parts, hits = [], defaultdict(list)
    for k in range(N_STRIPS):
        r, h = capture_hits(lambda: strip(k))
        parts.append(r)
        for kind, cols in h.items():
            hits[kind].append(cols)
    hits = {kind: tuple(torch.cat(c) for c in zip(*v)) for kind, v in hits.items()}
    differ = {}
    for f in ("radiance", "albedo", "normal", "depth", "position", "ao"):
        cat, whole = torch.cat([getattr(p, f) for p in parts]), getattr(ref, f)
        assert cat.shape == whole.shape, (f, cat.shape, whole.shape)
        ne = bits(cat) != bits(whole)
        differ[f] = int((ne.any(1) if ne.dim() > 1 else ne).sum())
    m = match_hits(hits_full, hits)
    log(card, f"phase 13 (a): {N_STRIPS} strips of {W}x{hs} against the {W}x{H} frame: "
              f"differing pixels {differ}; strip rays matched to the frame's: {m}")
    assert bool(torch.isfinite(ref.radiance).all()) and ref.radiance.mean().item() > 0
    assert m["t_differs"] == 0 and m["flags_differ"] == 0, f"strip rays disagree: {m}"
    if max(differ.values()) or m["closest_unmatched"] or m["occluded_unmatched"]:
        assert m["ties"] > 0, "strips differ from the frame without an exact-t tie"

    times = defaultdict(list)
    for label in ("full", "strips", "strips", "full"):
        if label == "full":
            times[label].append(timed(full)[1])
        else:
            times[label].append(sum(timed(lambda: strip(k))[1] for k in range(N_STRIPS)))
    log(card, f"phase 13 (a): ms in turns (CUDA events, each call from its launch to its "
              f"end): one full-frame sample {', '.join(f'{x:.2f}' for x in times['full'])}; "
              f"the {N_STRIPS} strips one after another "
              f"{', '.join(f'{x:.2f}' for x in times['strips'])}")
    return dict(launches=launches, differ=differ, match=m, times=times)


def phase13b(card, dev, scene, mats, atlas, lights, view, base):
    """A one-rank NCCL group made by film_mesh(): the sharded entry points
    against the plain calls they stand for at 1080p; broadcast_scene of the
    packed arenas; the NCCL all-reduce of one sample's radiance."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from rfw_tpu_torch.parallel import broadcast_scene, film_mesh, render_sample_sharded
    from rfw_tpu_torch.parallel.mesh import mesh_2d, render_sharded_2d, render_spp_sharded
    from rfw_tpu_torch.render import threefry
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample

    sob = RenderConfig(**{**base, "two_phase": "on"})
    rnd = dataclasses.replace(sob, sampler="random")
    key = threefry.fold_in(threefry.PRNGKey(SEED), 13)
    args = (scene, mats, atlas, lights, view, key, W, H)
    try:
        mesh = film_mesh()
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        assert mesh.device_type == "cuda"
        res = render_sample_sharded(mesh, *args, sob, sample_index=2)
        assert isinstance(res.radiance, DTensor)
        got = res.radiance.full_tensor()
        ref = render_sample(scene, mats, atlas, lights, view, W, H, sob, sample_index=2).radiance
        n_diff = int((bits(got) != bits(ref)).any(1).sum())
        log(card, f"phase 13 (b): one-rank NCCL film mesh {tuple(mesh.shape)} "
                  f"{mesh.mesh_dim_names}: render_sample_sharded vs render_sample at "
                  f"{W}x{H}, Sobol: {n_diff} differing pixels")
        assert n_diff == 0, "render_sample_sharded differs from render_sample"

        keys = threefry.split(key, PAR_SPP)
        seq = {}
        for name, cfg in (("sobol", sob), ("random", rnd)):
            acc = torch.zeros((W * H, 3), dtype=torch.float32, device=dev)
            for s in range(PAR_SPP):
                acc += render_sample(scene, mats, atlas, lights, view, W, H, cfg,
                                     sample_index=s if cfg is sob else None,
                                     key=keys[s]).radiance
            seq[name] = acc / PAR_SPP
        spp_mesh = film_mesh(axis="spp")
        checks = {
            "render_spp_sharded sobol": render_spp_sharded(spp_mesh, *args, PAR_SPP, sob),
            "render_spp_sharded random": render_spp_sharded(spp_mesh, *args, PAR_SPP, rnd),
            "render_sharded_2d (1, 1) sobol": render_sharded_2d(mesh_2d(1, 1), *args,
                                                                PAR_SPP, sob),
        }
        for name, r in checks.items():
            got = r.full_tensor()
            want = seq[name.split()[-1]]
            err = (got - want).abs()
            ok = bool((err <= 1e-6 + 1e-5 * want.abs()).all())
            log(card, f"phase 13 (b): {name}, {PAR_SPP} samples, against the sequential mean: "
                      f"max abs err {err.max().item():.3e}, "
                      f"{int((bits(got) != bits(want)).any(1).sum())} pixels not bit-identical")
            assert ok, f"{name} differs from the sequential mean beyond rtol 1e-5 / atol 1e-6"

        assert broadcast_scene(scene) is scene  # one rank: the tree unchanged
        arenas = [t for part in (scene, lights, atlas) for t in part if t is not None] + [
            getattr(mats, f.name) for f in dataclasses.fields(mats)]
        n_bytes = sum(t.numel() * t.element_size() for t in arenas)

        def bcast():
            for t in arenas:
                dist.broadcast(t, 0)
        bc_ms = cuda_ms(bcast, 5)
        rad = seq["sobol"].clone()
        ar_ms = cuda_ms(lambda: dist.all_reduce(rad), 10)
        log(card, f"phase 13 (b): broadcast_scene at one rank returns the tree; NCCL "
                  f"broadcast of the {len(arenas)} packed arenas ({n_bytes} B) {bc_ms:.4f} ms; "
                  f"NCCL all-reduce (SUM) of a ({W * H}, 3) f32 radiance {ar_ms:.4f} ms "
                  f"(one rank, CUDA events over 10)")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return dict(allreduce_ms=ar_ms, broadcast_ms=bc_ms)


def phase13c(card):
    """The examples' counterparts, each as a subprocess on the card (run at
    once, so their times share the card): exit 0, their frame and timing
    lines logged, their PNGs present."""
    import tempfile

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as out:
        procs = []
        for name, argv in EXAMPLES:
            argv = [a.replace("OUT", out) for a in argv]
            procs.append((name, subprocess.Popen(
                [sys.executable, str(root / "examples" / name), *argv], cwd=str(root),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        try:
            for name, p in procs:
                stdout, stderr = p.communicate(timeout=EXAMPLE_TIMEOUT)
                for line in stdout.strip().splitlines():
                    log(card, f"phase 13 (c) {name}: {line}")
                assert p.returncode == 0, f"{name} exited {p.returncode}:\n{stderr[-3000:]}"
        finally:
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        pngs = sorted(str(p.relative_to(out)) for p in Path(out).rglob("*.png"))
        log(card, f"phase 13 (c): {len(pngs)} PNGs written: {pngs}")
        want = ["cornell.png", *(f"physics/frame_{i:04d}.png" for i in range(4)),
                *(f"d2/frame_{i:04d}.png" for i in range(2))]
        assert pngs == sorted(want), pngs
        for p in want:
            assert (Path(out) / p).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", p


def phase13(card, dev, scene, mats, atlas, lights, view, base):
    """The scale-out layer and the examples on the card. Returns the
    launches of one strip's counted run."""
    t_phase = time.perf_counter()
    a = phase13a(card, scene, mats, atlas, lights, view, base)
    phase13b(card, dev, scene, mats, atlas, lights, view, base)
    phase13c(card)
    log(card, f"phase 13: {time.perf_counter() - t_phase:.2f} s")
    return a["launches"]


# ------------------------------------------------------------------ phase 14
#: phase 4's frame size and gate: the share of pixels within 1e-3 abs +
#: 1e-3 rel of the reference frame
TIER_W, TIER_H = 256, 144
PX_GATE = 0.995
#: the traversal tiers held against "auto" (phase 14 (b))
TIERS = ("packet", "lockstep", "pallas", "pallas_hbm")
#: TraceScene fields that are nodes, leaf links or instance rows: a native
#: and a numpy pack give the same ones
NODE_PREFIXES = ("tlas", "blas", "inst", "mesh_tri_range")


def px_agree(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of pixels whose every channel is within 1e-3 + 1e-3 |ref|."""
    return ((a - ref).abs() <= 1e-3 + 1e-3 * ref.abs()).all(dim=1).float().mean().item()


def leaf_rows(scene_np) -> np.ndarray:
    """Per treelet of the triangle arena, its (v0, e1, e2) rows sorted by
    their bytes: a leaf's triangles whatever their order inside it."""
    from rfw_tpu_torch.accel.bvh_cpu import TREELET

    tri = np.ascontiguousarray(
        np.concatenate([scene_np.tri_v0, scene_np.tri_e1, scene_np.tri_e2], 1), np.float32)
    rows = tri.view(np.dtype((np.void, 36))).reshape(-1, TREELET)
    return np.sort(rows, axis=1)


def pack_turns(card, label, meshes, instances) -> dict:
    """pack_trace_scene of one scene by the native builders and by numpy
    (RFW_NO_NATIVE=1), in turns (native, numpy, numpy, native); host
    seconds and the identity of the two packs."""
    from rfw_tpu_torch.render.pack import pack_trace_scene

    secs, packs = defaultdict(list), {}
    for name in ("native", "numpy", "numpy", "native"):
        with env(RFW_NO_NATIVE="1" if name == "numpy" else "0"):
            t0 = time.perf_counter()
            packs[name] = pack_trace_scene(meshes, instances)
            secs[name].append(time.perf_counter() - t0)
    a, b = packs["native"], packs["numpy"]
    nodes = [f for f in a._fields if f.startswith(NODE_PREFIXES)]
    same_nodes = all(np.array_equal(getattr(a, f), getattr(b, f)) for f in nodes)
    same_leaves = np.array_equal(leaf_rows(a), leaf_rows(b))
    moved = int((a.tri_v0 != b.tri_v0).any(axis=1).sum())
    log(card, f"phase 14 (a) {label} pack, host seconds in turns (native, numpy, numpy, "
              f"native): {secs['native'][0]:.3f}, {secs['numpy'][0]:.3f}, "
              f"{secs['numpy'][1]:.3f}, {secs['native'][1]:.3f}; {len(nodes)} node, leaf-link "
              f"and instance arrays identical {same_nodes}; every leaf's triangles the same "
              f"set {same_leaves}; triangle rows in another order inside their leaf {moved} "
              f"of {a.tri_v0.shape[0]}")
    assert same_nodes and same_leaves, f"the native and numpy {label} packs differ"
    return dict(secs=secs, packs=packs)


def host_sync_turns(card, parts, camera, settings) -> dict:
    """The host routes of TorchBackend (device_dynamics=False,
    device_motion=False) on phase 12 (a)'s scene, the flagship plus four
    skinned, morphed tubes: dynamic syncs (skin and morph on the host, BLAS
    refit, repack) and motion syncs (the 256 spheres moved: TLAS rebuild),
    each by the native and the numpy builders in turns."""
    from rfw_tpu_torch.backend import InstancesView3D, SkinView
    from rfw_tpu_torch.render.torch_backend import TorchBackend

    tube = skinned_tube(next(i for i, m in parts["materials"].materials
                             if m.name == "diffuse"))
    mats = np.stack([np.eye(4, dtype=np.float32)] * 4)
    mats[:, :3, 3] = [[-4.5, 0, -4.5], [4.5, 0, -4.5], [-4.5, 0, 4.5], [4.5, 0, 4.5]]

    def tube_calls(t):
        w = np.array([[0.5 + 0.5 * np.sin(t), 0.5 + 0.5 * np.cos(t)]] * 4, np.float32)
        iv = InstancesView3D(matrices=mats, skin_ids=np.zeros(4, np.int32),
                             changed=np.ones(4, bool), local_aabb_min=tube.aabb_min,
                             local_aabb_max=tube.aabb_max, morph_weights=w)
        return [(0, SkinView(joint_matrices=tube_pose(t)))], [(TUBE_SLOT, iv)]

    be = TorchBackend(TIER_W, TIER_H, dataclasses.replace(
        settings, device_dynamics=False, device_motion=False))
    skins, inst = tube_calls(0.0)
    be.set_skins(skins)
    feed_flagship(be, parts, [(TUBE_SLOT, tube.view())], inst)
    meshes = {slot: mesh for slot, mesh, _ in parts["meshes"]}
    spheres = [(slot, m.copy()) for slot, m in parts["instances"][:4]]
    rng = np.random.default_rng(SEED + 14)
    out = {"dynamic": defaultdict(list), "motion": defaultdict(list)}
    order = ("native", "numpy", "numpy", "native") * 2
    for k, name in enumerate(order):
        with env(RFW_NO_NATIVE="1" if name == "numpy" else "0"):
            skins, inst = tube_calls(0.4 * (k + 1))
            be.set_skins(skins)
            be.set_3d_instances(inst)
            be.synchronize()
            out["dynamic"][name].append(be.stats["sync_ms"].last())
            moved = []
            for slot, m in spheres:
                m[:, :3, 3] += rng.uniform(-0.1, 0.1, (m.shape[0], 3)).astype(np.float32)
                n = m.shape[0]
                moved.append((slot, InstancesView3D(
                    matrices=m.copy(), skin_ids=np.full(n, -1, np.int32),
                    changed=np.ones(n, bool), local_aabb_min=meshes[slot].aabb_min,
                    local_aabb_max=meshes[slot].aabb_max)))
            be.set_3d_instances(moved)
            be.synchronize()
            out["motion"][name].append(be.stats["sync_ms"].last())
    for kind, ms in out.items():
        log(card, f"phase 14 (a) host-route {kind} sync of phase 12 (a)'s scene, ms in turns "
                  f"({', '.join(order)}): native "
                  f"{', '.join(f'{x:.2f}' for x in ms['native'])} (mean "
                  f"{np.mean(ms['native']):.2f}); numpy "
                  f"{', '.join(f'{x:.2f}' for x in ms['numpy'])} (mean "
                  f"{np.mean(ms['numpy']):.2f})")
    return out


def phase14a(card, dev, parts, flagship_np, camera, base, native_build) -> dict:
    """The native host builder: its first-use build, flagship and heavy
    packs native against numpy, a render from each flagship pack, and the
    backend's host-route syncs."""
    from rfw_tpu_torch import native
    from rfw_tpu_torch.convert import from_numpy_scene
    from rfw_tpu_torch.render.torch_backend import TorchSettings
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample
    from rfw_tpu_torch.scenes import build_heavy_scene

    log(card, f"phase 14 (a): native library {'/'.join(native_build.path.parts[-4:])} "
              f"built by g++ at first use in {native_build.seconds:.3f} s (phase 1); "
              f"native path active {native.available()}")
    flag = pack_turns(card, "flagship", parts["meshes"], parts["instances"])
    heavy_parts = build_heavy_scene(SEED + 1, N_HEAVY, views=True)
    heavy = pack_turns(card, "heavy", heavy_parts[-1]["meshes"], heavy_parts[-1]["instances"])
    mats_np, lights_np, atlas_np = flagship_np
    view = torch.from_numpy(camera.get_view(TIER_W, TIER_H).as_array()).to(dev)
    frames = {}
    for name, sc in flag["packs"].items():
        s, m, li, a = from_numpy_scene(sc, mats_np, lights_np, atlas_np, dev)
        frames[name] = render_sample(s, m, a, li, view, TIER_W, TIER_H, RenderConfig(**base),
                                     sample_index=1).radiance
    share = px_agree(frames["native"], frames["numpy"])
    log(card, f"phase 14 (a) {TIER_W}x{TIER_H} Sobol render from the native pack vs the numpy "
              f"pack: {share:.6f} of pixels within 1e-3 abs + 1e-3 rel, mean "
              f"{frames['native'].mean().item():.6f} vs {frames['numpy'].mean().item():.6f}")
    assert share >= PX_GATE, f"native and numpy packs render apart ({share})"
    settings = TorchSettings(samples_per_frame=1, max_bounces=BOUNCES, clamp=20.0,
                             sky_intensity=0.35, sampler="sobol")
    syncs = host_sync_turns(card, parts, camera, settings)
    return dict(flagship=flag["secs"], heavy=heavy["secs"], syncs=syncs,
                heavy_scene=heavy_parts[0])


def phase14b(card, dev, scene, mats, atlas, lights, camera, base) -> dict:
    """The traversal tiers at phase 4's size against "auto"; ms per sample
    by CUDA events, one timed sample each after one warm-up sample of
    "auto" (the tiers compile nothing); the "pallas" frame's launches
    counted."""
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample, resolve_traversal

    view = torch.from_numpy(camera.get_view(TIER_W, TIER_H).as_array()).to(dev)
    kw = {**base, "two_phase": "on"}

    def frame(traversal, s=1):
        return render_sample(scene, mats, atlas, lights, view, TIER_W, TIER_H,
                             RenderConfig(traversal=traversal, **kw), sample_index=s).radiance

    out, ref = {}, None
    frame("auto", 2)  # warm-up
    for trav in ("auto", *TIERS):
        tier = resolve_traversal(RenderConfig(traversal=trav), TIER_W * TIER_H)
        if trav == "pallas":
            torch.cuda.synchronize()
            reset_launches()
        r, ms = timed(lambda: frame(trav))
        if trav == "pallas":
            out["launches"] = read_launches()
        if ref is None:
            ref = r
        share = px_agree(r, ref)
        out[trav] = dict(ms=ms, share=share, tier=tier)
        log(card, f"phase 14 (b) traversal={trav!r} ({tier[0]} tier, tiles of {tier[1]}): "
                  f"{ms:.2f} ms per {TIER_W}x{TIER_H} sample (CUDA events), {share:.6f} of "
                  f"pixels within 1e-3 abs + 1e-3 rel of \"auto\", mean {r.mean().item():.6f}")
        assert bool(torch.isfinite(r).all()), f"non-finite radiance ({trav})"
        assert share >= PX_GATE, f"traversal={trav!r} renders apart from auto ({share})"
    launches = out["launches"]
    log(card, f"phase 14 (b) the \"pallas\" frame launched {launches}")
    for kind in ("closest", "occluded", "items_closest"):
        assert launches[kind] > 0, f"the pallas frame never launched {kind}"

    # off the 1,024-ray grain the Pallas names stay on the kernels
    w = TIER_W - 8
    view_w = torch.from_numpy(camera.get_view(w, TIER_H).as_array()).to(dev)

    def frame_w(traversal):
        return render_sample(scene, mats, atlas, lights, view_w, w, TIER_H,
                             RenderConfig(traversal=traversal, **kw), sample_index=1).radiance

    tier = resolve_traversal(RenderConfig(traversal="pallas"), w * TIER_H)
    ref_w = frame_w("auto")
    torch.cuda.synchronize()
    reset_launches()
    r, ms = timed(lambda: frame_w("pallas"))
    off = read_launches()
    share = px_agree(r, ref_w)
    log(card, f"phase 14 (b) traversal='pallas' at {w}x{TIER_H} ({tier}): {ms:.2f} ms per "
              f"sample (CUDA events), {share:.6f} of pixels within 1e-3 abs + 1e-3 rel of "
              f"\"auto\" at that size; launched {off}")
    assert tier.trace == "kernel" and not tier.two_phase, tier
    assert off["closest"] > 0 and off["occluded"] > 0, off
    assert off["items_closest"] == 0, "two-phase ran off the Pallas grain"
    assert bool(torch.isfinite(r).all()) and share >= PX_GATE, share
    out["pallas_off_grain"] = dict(ms=ms, share=share, launches=off)
    return out


def phase14c(card, ps, rays, cfg) -> dict:
    """The public two-phase call (`ops.pallas_twophase_closest_hit`, phase A
    by K4, phase B by K3, no retrace) on phase 7's captured bounce rays
    against K1."""
    from rfw_tpu_torch import ops
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.render.intersect import Hit

    o, d, tl = rays
    torch.cuda.synchronize()
    reset_launches()
    hit, trunc = ops.pallas_twophase_closest_hit(ps, o, d, tl, K=cfg.tp_K)
    torch.cuda.synchronize()
    launches = read_launches()
    log(card, f"phase 14 (c) public two-phase call on {o.shape[0]} bounce rays (K={cfg.tp_K}, "
              f"default capacity): launches {launches}; truncated {int(trunc.sum())}")
    assert launches["entries"] == 1 and launches["items_closest"] == 1, launches
    assert launches["closest"] == 0, "the public call retraced"
    ref = tr.closest_hit(ps, o, d, tl)
    keep = ~trunc
    err = check_nearest(card, "phase 7's bounce rays not marked truncated",
                        Hit(*[x[keep] for x in hit]), Hit(*[x[keep] for x in ref]),
                        "public two-phase call vs K1")
    call_ms = cuda_ms(lambda: ops.pallas_twophase_closest_hit(ps, o, d, tl, K=cfg.tp_K), 5)
    k1_ms = cuda_ms(lambda: tr.closest_hit(ps, o, d, tl), 5)
    log(card, f"phase 14 (c) public two-phase call {call_ms:.4f} ms per call against K1's "
              f"{k1_ms:.4f} ms on the same rays (CUDA events, 5 calls each)")
    return dict(launches=launches, ms=call_ms, k1_ms=k1_ms, max_abs_err=err)


def phase14d(card, dev, heavy_np) -> dict:
    """build_lbvh_device on the heavy scene's instance boxes, on the card
    against the CPU."""
    from rfw_tpu_torch.accel.lbvh import build_lbvh_device

    live = heavy_np.inst_mesh >= 0
    mn = torch.from_numpy(heavy_np.inst_aabb_min[live])
    mx = torch.from_numpy(heavy_np.inst_aabb_max[live])
    cpu = build_lbvh_device(mn, mx)
    gmn, gmx = mn.to(dev), mx.to(dev)
    card_bvh = build_lbvh_device(gmn, gmx)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(card_bvh, cpu))
    ms = cuda_ms(lambda: build_lbvh_device(gmn, gmx), 5)
    log(card, f"phase 14 (d) build_lbvh_device on {mn.shape[0]} instance boxes: card result "
              f"bit-identical to the CPU's {same}; {ms:.3f} ms per build on the card (CUDA "
              f"events, 5 builds)")
    assert same, "the card's LBVH differs from the CPU's"
    return dict(ms=ms)


def phase14(card, dev, parts, flagship_np, camera, scene, mats, atlas, lights, base, ps,
            tp_rays, native_build) -> dict:
    """The slice that closes the port: the native host builder, the
    traversal tiers, the public two-phase call and the device LBVH."""
    from rfw_tpu_torch.render.wavefront import RenderConfig

    t_phase = time.perf_counter()
    a = phase14a(card, dev, parts, flagship_np, camera, base, native_build)
    b = phase14b(card, dev, scene, mats, atlas, lights, camera, base)
    c = phase14c(card, ps, tp_rays, RenderConfig(**{**base, "two_phase": "on"}))
    phase14d(card, dev, a["heavy_scene"])
    log(card, f"phase 14: {time.perf_counter() - t_phase:.2f} s")
    return dict(tiers=b["launches"], twophase_call=c["launches"])


# ------------------------------------------------------------------ phase 15
BENCH_REPEATS = 3
BENCH_ARGV = ("--width", W, "--height", H, "--spp", SPP, "--repeats", BENCH_REPEATS)
#: the kernels' launches a bench sample makes, as phases 10-14 found them
BENCH_LAUNCHES = {"off": {"closest": 2, "occluded": 2},
                  "on": {"closest": 2, "occluded": 2, "items_closest": 1}}
#: the layer tools at the reference tools' default sizes, with the flags
#: that reach every call they time
TOOL_RUNS = (("bisect_e2e", ()), ("profile_e2e", ()),
             ("bench_traverse", ("--occluded", "--tp-occluded", "--stats")),
             ("bench_items", ()), ("bench_items", ("--fused",)),
             ("bench_items", ("--breakdown", "--pallas-A")), ("check_traverse", ()),
             ("diag_live", ()))
ANIM_ARGV = ("--size", "64x36", "--frames", 2, "--no-pica")


def phase15a(card) -> dict:
    """`python -m rfw_tpu_torch.bench` at 1920x1080, 8 samples, 3 repeats,
    with two_phase "off" and "on": each line parsed, a positive value
    and a finite film, and the launches of the whole run (counters reset
    just before it, read just after) a sample as BENCH_LAUNCHES says.
    Returns the "on" run's launches."""
    from rfw_tpu_torch import bench

    n_samples = 1 + SPP * BENCH_REPEATS  # the warm-up and the timed loops
    out = {}
    for mode in ("off", "on"):
        torch.cuda.synchronize()
        reset_launches()
        line = run_tool(card, bench.main, [*BENCH_ARGV, "--two-phase", mode])
        torch.cuda.synchronize()
        launches = read_launches()
        assert line["value"] > 0 and line["vs_baseline"] is None, line
        assert line["film_finite"] and line["film_mean"] > 0, "the bench's film"
        per_sample = {k: n / n_samples for k, n in launches.items() if n}
        log(card, f"phase 15 (a) bench, two_phase={mode}: {line['value']:.3f} Mrays/s, "
                  f"{line['ms_per_sample']:.2f} ms/sample (median of {BENCH_REPEATS}; all "
                  f"{', '.join(f'{x:.2f}' for x in line['ms_per_sample_all'])}), peak "
                  f"{line['peak_mem_mb']} MiB, set-up {line['setup_s']:.3f} s; launches "
                  f"{launches} over {n_samples} samples, {per_sample} a sample")
        assert per_sample == BENCH_LAUNCHES[mode], \
            f"two_phase={mode}: launches a sample {per_sample}"
        out[mode] = launches
    return out["on"]


def phase15b(card) -> None:
    """Each layer tool at its reference default size on the flagship
    scene; check_traverse's gate must pass."""
    import importlib

    for name, flags in TOOL_RUNS:
        tool = importlib.import_module(f"rfw_tpu_torch.tools.{name}")
        t0 = time.perf_counter()
        res = run_tool(card, tool.main, list(flags))
        log(card, f"phase 15 (b) {name} {' '.join(flags)}: {time.perf_counter() - t0:.2f} s")
        if name == "check_traverse":
            assert res["ok"], f"check_traverse's gate failed: {res}"
        if name == "bench_items":
            assert res["mask_mismatch"] == 0 and res["t_mismatch"] == 0, res
            assert res.get("A_entry_set_mismatch", 0) == 0, res
        if name == "bench_traverse":
            assert all(v == 0 for k, v in res.items() if k.endswith("occl_mismatch")), res


def phase15c(card) -> None:
    """examples/torch_animated.py at 64x36, 2 frames, without pica, with a
    skinned glTF written here as its CesiumMan: two PNGs, and the second
    frame's sync takes the device skin and refit route."""
    import tempfile

    from examples import torch_animated
    from rfw_tpu_torch.render.torch_backend import TorchBackend

    routes = Counter()
    wrapped = {}
    for name in ("_apply_device_dynamics", "_rebuild_scene"):
        def counted(self, *a, _fn=getattr(TorchBackend, name), _name=name, **k):
            routes[_name] += 1
            return _fn(self, *a, **k)
        wrapped[name] = counted
    with tempfile.TemporaryDirectory() as root, patched(TorchBackend, **wrapped):
        man = Path(root) / "models" / "CesiumMan"
        man.mkdir(parents=True)
        (man / "CesiumMan.gltf").write_text(json.dumps(skinned_gltf()))
        buf = io.StringIO()
        with redirect_stdout(buf):
            torch_animated.main([*map(str, ANIM_ARGV), "--assets", str(man.parent),
                                 "--out-dir", str(Path(root) / "out")])
        for line in buf.getvalue().strip().splitlines():
            log(card, f"phase 15 (c) torch_animated: {line}")
        pngs = sorted(p.name for p in (Path(root) / "out").glob("*.png"))
    log(card, f"phase 15 (c): PNGs {pngs}, sync routes {dict(routes)}")
    assert pngs == ["frame_0000.png", "frame_0001.png"], pngs
    assert routes == Counter(_rebuild_scene=1, _apply_device_dynamics=1), dict(routes)


def phase15(card) -> dict:
    """The measurement entry point, its layer tools and the animated
    example on the card. Returns the launches of the "on" bench run."""
    t_phase = time.perf_counter()
    launches = phase15a(card)
    phase15b(card)
    phase15c(card)
    log(card, f"phase 15: {time.perf_counter() - t_phase:.2f} s")
    return launches


# ------------------------------------------------------------------ phase 16
WIDE = (16, 32)
#: the bench's runs of phase 16 (c): `python -m rfw_tpu_torch.bench` under
#: each RFW_WIDE_ARITY, then at arity 8 under each other RFW_SORT_KEY, with
#: "off" and "on" each
WIDE_BENCH_ARGV = ("--width", W, "--height", H, "--spp", SPP, "--repeats", 1)
WIDE_BENCH_RUNS = (*((dict(RFW_WIDE_ARITY=str(a)) for a in (8, *WIDE))),
                   *(dict(RFW_SORT_KEY=k) for k in ("morton", "mortonoct", "instance")))
BENCH_TIMEOUT = 300
#: the walk kernels of a wide scene: (entry, source, the TPU kernel it replaces)
WIDE_KERNELS = (
    ("K1 closest_hit", "closest", "rfw_tpu_torch/csrc/traverse.cu",
     "rfw_tpu/ops/traverse.py:335"),
    ("K2 occluded", "occluded", "rfw_tpu_torch/csrc/traverse.cu", "rfw_tpu/ops/traverse.py:335"),
    ("K3 items closest", "items_closest", "rfw_tpu_torch/csrc/traverse_items.cu",
     "rfw_tpu/ops/traverse_items.py:107"),
    ("K5 items any-hit", "items_occluded", "rfw_tpu_torch/csrc/traverse_items.cu",
     "rfw_tpu/ops/traverse_items.py:107"),
    ("K4 tlas_entries", "entries", "rfw_tpu_torch/csrc/traverse_entries.cu",
     "rfw_tpu/ops/traverse_entries.py:53"),
)


def wide_pack(card, label, arity, build, dev):
    """build() (a scenes.py builder) under RFW_WIDE_ARITY=arity, uploaded:
    (its numpy TraceScene, the tensors, the prepared scene)."""
    from rfw_tpu_torch.convert import from_numpy_scene
    from rfw_tpu_torch.ops import traverse as tr

    t0 = time.perf_counter()
    with env(RFW_WIDE_ARITY=str(arity)):
        out = build()
    tensors = from_numpy_scene(*out[:4], dev)
    ps = tr.prepare_scene(tensors[0])
    torch.cuda.synchronize()
    assert ps.arity == arity and ps.nodes.shape[1] == 8 * arity
    log(card, f"phase 16: {label} packed {arity}-wide in {time.perf_counter() - t0:.2f} s: "
              f"{ps.nodes.shape[0]} supernode rows of {4 * ps.nodes.shape[1]} B "
              f"({nbytes(ps.nodes) / 1e6:.2f} MB of nodes; TLAS root {ps.tlas_root})")
    return out, tensors, ps


def launch_shapes(card, n, arity=8):
    """Registers, local and shared bytes, residency and grid for n rays of
    each walk kernel K1-K5 at `arity` (and of K6, which has no arity, at
    8), its default and its counting instance."""
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.ops import traverse_entries as te
    from rfw_tpu_torch.ops import traverse_items as ti
    from rfw_tpu_torch.render.wavefront import RenderConfig

    k = RenderConfig().tp_K
    kernels = [("K1", lambda c: tr.launch_shape(False, c, n, arity=arity)),
               ("K2", lambda c: tr.launch_shape(True, c, n, arity=arity)),
               ("K3", lambda c: ti.launch_shape(False, c, n, arity=arity)),
               ("K5", lambda c: ti.launch_shape(True, c, n, arity=arity)),
               (f"K4 (K={k})", lambda c: te.launch_shape(k, c, n, arity=arity))]
    if arity == 8:
        kernels += [("K6 closest", lambda c: ti.dense_launch_shape(False, c, n)),
                    ("K6 any hit", lambda c: ti.dense_launch_shape(True, c, n))]
    wide = "" if arity == 8 else f" {arity}-wide"
    for stats in (False, True):
        for name, query in kernels:
            s = query(stats)
            log(card, f"{name}{wide}{' counting instance' if stats else ''}: "
                      f"{s['registers']} registers, {s['local_bytes']} B local, "
                      f"{s['shared_bytes']} B shared per block of {s['block']}, "
                      f"{s['blocks_per_sm']} blocks per SM on {s['sms']} SMs -> theoretical "
                      f"occupancy {occupancy(s)[0]:.3f}; {s['grid']} blocks launched for {n} rays")


def spills(card, built) -> None:
    """ptxas's spill report of the walk kernels' instances by arity (phase
    1's build log, each line of which phase 1 printed): how many instances
    spill under the register cap (kMinBlocks), and the largest spill."""
    by_arity = defaultdict(lambda: [0, 0, 0])  # instances, spilling, largest bytes
    for b in built:
        if b.name not in WALK_LIBS:
            continue
        fn = None
        for line in b.log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if fn and m and "_kernel" in fn:
                a = re.search(r"ELi(8|16|32)E", fn)
                row = by_arity[int(a.group(1)) if a else 8]
                row[0] += 1
                spill = max(int(m.group(1)), int(m.group(2)))
                row[1] += spill > 0
                row[2] = max(row[2], spill)
    for a, (n, spilling, largest) in sorted(by_arity.items()):
        log(card, f"ptxas, walk kernels (K1-K6) of arity {a}: {spilling} of {n} instances "
                  f"spill (largest {largest} B)")


def phase16a(card, dev, arity, flagship, heavy_build, main_calls, tp, heavy) -> dict:
    """The wide walks against their plain versions at the same arity, on
    the inputs phases 5, 7 and 8 captured (the rays and items do not depend
    on the width): K1/K2 on the 1080p sample's four traversal calls, and K1
    and K2 of `arity` against the 8-wide kernels on the same rays; K3, K5
    and K4 on phase 7's flagship items and rays and phase 8's heavy ones.
    Each compare_* row holds its gate, counts (no push finds the stack
    full), times and bound. Returns {kind: [rows]}."""
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.render.wavefront import RenderConfig

    K = RenderConfig().tp_K
    rows = defaultdict(list)  # by launch kind
    ps = flagship[2]
    for label, kind, ps8, o, d, tl in main_calls:
        lab = f"{label}, {arity}-wide"
        rows[kind].append(compare_call(card, lab, kind, ps, o, d, tl))
        if kind == "closest":  # K1 of `arity` against K1 8-wide
            check_nearest(card, lab, tr.closest_hit(ps, o, d, tl), tr.closest_hit(ps8, o, d, tl),
                          f"K1 {arity}-wide vs K1 8-wide")
        else:
            check_occluded(card, lab, tr.occluded(ps, o, d, tl), tr.occluded(ps8, o, d, tl),
                           f"K2 {arity}-wide vs K2 8-wide")
    _, _, hps = wide_pack(card, "the instance-heavy scene", arity, heavy_build, dev)
    # K6 reads the per-treelet tables, which the wide pack names alike
    assert torch.equal(hps.tbox, heavy["ps"].tbox) and torch.equal(hps.tcount, heavy["ps"].tcount)
    for scene_ps, inputs in ((ps, tp["inputs"]), (hps, heavy["inputs"])):
        for name, kind, any_hit in (("K3", "items_closest", False),
                                    ("K5", "items_occluded", True)):
            for label, items in inputs[name]:
                rows[kind].append(compare_items(card, name, f"{label}, {arity}-wide", False,
                                                any_hit, scene_ps, *items))
        for label, (o, d, tl) in inputs["K4"]:
            rows["entries"].append(compare_entries(card, f"{label}, {arity}-wide", scene_ps, o,
                                                   d, tl, K))
    del hps
    return rows


def phase16_counted(card, dev, arity, tensors, mats, atlas, lights, view, base) -> dict:
    """The wide main path's counted run: one 1080p sample on the flagship
    at `arity` with two_phase="on", RFW_TP_SHADOW=1 and phase A by K4
    (the dense-scan gate forced to 0), so that K1, K2, K4, K3 and K5 each
    launch (launch counters reset just before it, read just after)."""
    from rfw_tpu_torch.ops import traverse_items as ti
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample

    cfg = RenderConfig(**{**base, "two_phase": "on"})
    with env(RFW_TP_SHADOW="1"), patched(ti, DENSE_A_MAX_INST=0):
        render_sample(tensors[0], mats, atlas, lights, view, W, H, cfg, sample_index=200)
        torch.cuda.synchronize()
        reset_launches()
        out = render_sample(tensors[0], mats, atlas, lights, view, W, H, cfg, sample_index=201)
        torch.cuda.synchronize()
        launches = read_launches()
    log(card, f"phase 16 counted sample, {arity}-wide flagship (two_phase on, RFW_TP_SHADOW=1, "
              f"phase A by K4): launches {launches}, mean radiance "
              f"{out.radiance.mean().item():.6f}")
    assert bool(torch.isfinite(out.radiance).all()) and out.radiance.mean().item() > 0
    for _, kind, *_ in WIDE_KERNELS:
        assert launches[kind] > 0, f"the {arity}-wide path never launched {kind}"
    return launches


def phase16_sort_keys(card, dev, scene, mats, atlas, lights, view, base, ps) -> dict:
    """K1 on the bounce rays of one 1080p sample (two_phase="off", 8-wide)
    under each sort key and in pixel order: the bounce state's rays, alive
    mask and instance hints captured at the sort, each key's stable order
    and its compacted prefix, as `render_sample` traces them. Returns
    {key: ms}."""
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.render import wavefront as wf
    from rfw_tpu_torch.render.intersect import T_MAX

    cfg = wf.RenderConfig(**base)
    seen = []

    def record(ray_o, ray_d, mn, mx, alive=None, hint=None, key=None):
        seen.append((ray_o, ray_d, mn, mx, alive.clone(), hint.clone()))
        return real(ray_o, ray_d, mn, mx, alive, hint, key)

    real = wf.sort_key
    with patched(wf, sort_key=record):
        wf.render_sample(scene, mats, atlas, lights, view, W, H, cfg, sample_index=300)
    assert len(seen) == 1, f"{len(seen)} bounce sorts in one 1-bounce sample"
    ray_o, ray_d, mn, mx, alive, hint = seen[0]
    o, d = torch.stack(ray_o, 1), torch.stack(ray_d, 1)
    R, live = o.shape[0], int(alive.sum())
    sizes = wf._prefix_sizes(R, wf.resolve_traversal(cfg, R).lanes, cfg.max_bounces)
    n = wf._pick_prefix(sizes, live)
    out = {}
    for key in (*wf.SORT_KEYS, "pixel order"):
        if key == "pixel order":  # no sort, no compaction
            perm = torch.arange(R, device=dev)
        else:
            perm = torch.sort(wf.sort_key(ray_o, ray_d, mn, mx, alive, hint, key=key),
                              stable=True).indices[:n]
            assert bool(alive[perm[:live]].all()), f"{key}: a dead lane before a live one"
        po, pd = o[perm].contiguous(), d[perm].contiguous()
        tl = torch.where(alive[perm], T_MAX, 0.0)
        out[key] = cuda_ms(lambda: tr.closest_hit(ps, po, pd, tl), 10)
    log(card, f"phase 16 K1 on one sample's bounce rays ({live} live of {R}; a sorted key traces "
              f"the prefix of {n}), ms by sort key: "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in out.items()))
    return out


def bench_subprocesses(card, tag, argv, runs) -> list:
    """`python -m rfw_tpu_torch.bench` as a subprocess per (environment,
    two_phase mode, extra flags) of `runs`, with no other RFW_* variable
    set: each line parsed (a positive value, a finite film); ms per
    sample, Mrays/s, peak memory and launches a sample logged."""
    root = Path(__file__).resolve().parent
    torch.cuda.empty_cache()
    lines = []
    for extra, mode, flags in runs:
        e = {k: v for k, v in os.environ.items() if not k.startswith("RFW_")}
        e.update(extra)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "rfw_tpu_torch.bench", *map(str, argv), *map(str, flags),
             "--two-phase", mode], cwd=root, env=e, capture_output=True, text=True,
            timeout=BENCH_TIMEOUT)
        name = " ".join([*(f"{k}={v}" for k, v in extra.items()), *map(str, flags)])
        assert res.returncode == 0, f"bench {name} {mode}: {res.stderr[-3000:]}"
        line = json.loads(res.stdout.strip().splitlines()[-1])
        assert line["value"] > 0 and line["film_finite"] and line["film_mean"] > 0, line
        log(card, f"{tag} bench {name}, two_phase={mode}: {line['value']:.3f} Mrays/s, "
                  f"{line['ms_per_sample']:.2f} ms/sample (all "
                  f"{', '.join(f'{x:.2f}' for x in line['ms_per_sample_all'])}), peak "
                  f"{line['peak_mem_mb']} MiB, set-up {line['setup_s']:.3f} s, launches a "
                  f"sample {line['launches_per_sample']} (process "
                  f"{time.perf_counter() - t0:.1f} s)")
        lines.append(dict(env=extra, flags=list(flags), two_phase=mode, line=line))
    return lines


def phase16_backend(card, dev, parts, camera, base) -> None:
    """TorchBackend(1920, 1080) with TorchSettings' device routes on the
    flagship scene plus phase 12 (a)'s skinned tube, packed 16-wide: its
    first HDR frame equals render_sample at sample 0 on its own tensors (bit
    for bit); a skin pose sync takes the host repack (the refit plans are
    8-wide) and a motion sync of the spheres the host TLAS rebuild (the
    TLAS refit plan and the device TLAS builder are 8-wide)."""
    import rfw_tpu_torch.render.torch_backend as tb
    from rfw_tpu_torch.backend import InstancesView3D, SkinView
    from rfw_tpu_torch.ops import traverse as tr
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
    from rfw_tpu_torch.render.wavefront import (
        RenderConfig, mat_feature_mask, render_sample, tex_kinds_mask,
    )

    settings = TorchSettings(samples_per_frame=1, max_bounces=BOUNCES, clamp=20.0,
                             sky_intensity=0.35, sampler="sobol")
    tube = skinned_tube(next(i for i, m in parts["materials"].materials if m.name == "diffuse"))
    mats = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    mats[:, :3, 3] = [[-4.5, 0, -4.5], [4.5, 0, 4.5]]

    def tube_view():
        return InstancesView3D(matrices=mats, skin_ids=np.zeros(2, np.int32),
                               changed=np.ones(2, bool), local_aabb_min=tube.aabb_min,
                               local_aabb_max=tube.aabb_max,
                               morph_weights=np.full((2, 2), 0.5, np.float32))

    view = camera.get_view(W, H)
    routes = Counter()
    be = TorchBackend(W, H, settings)
    assert be.device.type == "cuda" and settings.device_dynamics and settings.device_motion
    for name in ("_rebuild_scene", "_apply_device_dynamics", "_try_device_motion"):
        def counted(*a, _fn=getattr(be, name), _name=name, **k):
            out = _fn(*a, **k)
            routes[_name if out is not False else f"{_name} declined"] += 1
            return out
        setattr(be, name, counted)
    repacks = Counter()
    real_repack = tb.repack_instances

    def counted_repack(*a, **k):
        repacks["n"] += 1
        return real_repack(*a, **k)

    with env(RFW_WIDE_ARITY="16"), patched(tb, repack_instances=counted_repack):
        be.set_skins([(0, SkinView(joint_matrices=tube_pose(0.0)))])
        feed_flagship(be, parts, [(TUBE_SLOT, tube.view())], [(TUBE_SLOT, tube_view())])
        assert be._scene_host.blas8_code.shape[1] == 16 and be._dyn is None
        be.render(None, view)
        hdr = be.hdr_frame()
        cfg = RenderConfig(max_bounces=BOUNCES, clamp=20.0, sky_intensity=0.35,
                           sampler="sobol", aovs=False, tex_mask=tex_kinds_mask(be._materials.tex),
                           mat_features=mat_feature_mask(be._materials),
                           has_area_lights=be._area.count > 0)
        assert tr.prepare_scene(be._scene_dev).arity == 16
        ref = render_sample(be._scene_dev, be._mats_dev, be._atlas_dev, be._lights_dev,
                            torch.from_numpy(view.as_array()).to(dev), W, H, cfg,
                            sample_index=0).radiance.cpu().numpy().reshape(H, W, 3)
        same = np.array_equal(hdr, ref)
        log(card, f"phase 16 (c) TorchBackend({W}, {H}) on a 16-wide pack: first frame "
                  f"{be.stats['render_ms'].last():.2f} ms; its HDR frame equals render_sample "
                  f"on its own tensors bit for bit {same} (max abs err "
                  f"{np.abs(hdr - ref).max():.3e})")
        assert same, "the 16-wide backend frame differs from render_sample's"
        before = dict(routes)
        be.set_skins([(0, SkinView(joint_matrices=tube_pose(0.7)))])
        be.synchronize()
        be.render(None, view)
        dyn = {k: routes[k] - before.get(k, 0) for k in routes}
        meshes = {slot: mesh for slot, mesh, _ in parts["meshes"]}
        moved = []
        for slot, m in parts["instances"][:4]:
            m = m.copy()
            m[:, :3, 3] += 0.1
            moved.append((slot, InstancesView3D(
                matrices=m, skin_ids=np.full(m.shape[0], -1, np.int32),
                changed=np.ones(m.shape[0], bool), local_aabb_min=meshes[slot].aabb_min,
                local_aabb_max=meshes[slot].aabb_max)))
        before = dict(routes)
        be.set_3d_instances(moved)
        be.synchronize()
        frame = be.render(None, view)
        motion = {k: routes[k] - before.get(k, 0) for k in routes}
    log(card, f"phase 16 (c) 16-wide backend routes: skin pose sync {dyn}, motion sync "
              f"{motion}, host TLAS repacks {repacks['n']}; frames {frame.shape}")
    assert dyn.get("_rebuild_scene") == 1 and not dyn.get("_apply_device_dynamics"), dyn
    assert motion.get("_try_device_motion declined") == 1 and repacks["n"] == 1, motion
    assert be._dyn is None and be._motion is None
    assert be._scene_host.tlas8_code.shape[1] == 16
    assert torch.equal(be._scene_dev.tlas8_code.cpu(),
                       torch.from_numpy(be._scene_host.tlas8_code)), "a device-built TLAS"


def kernel_row(name, source, replaces, launches, rows, extra_err=(), **extra) -> dict:
    """A kernel's entry of the `kernels` line from its compared calls' rows:
    their times, plain times and bounds summed, its largest disagreement
    (also over `extra_err`), the bound's kind of the call with the largest
    bound; the walks also sum their bounds by the plain walk's counts."""
    b = max(rows, key=lambda r: r["bound_ms"]) if rows else None
    if rows and all("bound_ms_plain_counts" in r for r in rows):  # the walks K1-K5
        extra["bound_ms_plain_counts"] = sum(r["bound_ms_plain_counts"] for r in rows)
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max([*extra_err, *(r["max_abs_err"] for r in rows)]),
                ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                bound_by=b["bound_by"] if b else None, library_ms=None, calls=rows, **extra)


def phase16(card, dev, built, main_calls, tp, heavy, parts, camera, tensors, base, ps) -> dict:
    """Wide supernodes and the bounce sort keys on the card: (a) K1-K5 at
    16 and 32 against their plain versions at the same arity on phases 5,
    7 and 8's inputs, and the wide K1/K2 against the 8-wide ones; (b) no
    push finds a kernel's stack full (walk_counts asserts it); (c) the
    counted 16- and 32-wide main path, the bench under each arity and sort
    key, K1 on one sample's bounce rays under each key, and the backend's
    16-wide routes. Returns the kernels line's wide entries."""
    from rfw_tpu_torch.scenes import build_heavy_scene, build_scene

    t_phase = time.perf_counter()
    spills(card, built)
    scene, mats, lights, atlas = tensors
    view = torch.from_numpy(camera.get_view(W, H).as_array()).to(dev)
    entries = []
    for arity in WIDE:
        launch_shapes(card, W * H, arity)
        flagship = wide_pack(card, "the flagship scene", arity, lambda: build_scene(SEED), dev)
        rows = phase16a(card, dev, arity, flagship, lambda: build_heavy_scene(SEED + 1, N_HEAVY),
                        main_calls, tp, heavy)
        launches = phase16_counted(card, dev, arity, flagship[1], mats, atlas, lights, view,
                                   base)
        for name, kind, source, replaces in WIDE_KERNELS:
            entries.append(kernel_row(f"{name} ({arity}-wide)", source, replaces,
                                      launches[kind], rows[kind], arity=arity,
                                      stack_full=sum(r["stack_full"] for r in rows[kind])))
        del flagship, rows
        torch.cuda.empty_cache()
    keys_ms = phase16_sort_keys(card, dev, scene, mats, atlas, lights, view, base, ps)
    bench = bench_subprocesses(card, "phase 16 (c)", WIDE_BENCH_ARGV,
                               [(extra, mode, ()) for extra in WIDE_BENCH_RUNS
                                for mode in ("off", "on")])
    phase16_backend(card, dev, parts, camera, base)
    log(card, f"phase 16: {time.perf_counter() - t_phase:.2f} s")
    return dict(entries=entries, keys_ms=keys_ms, bench=bench)


# ------------------------------------------------------------------ phase 17
#: the bench's A/B runs of phase 17 (b): RFW_COMPACTION 1 and 0 with
#: two_phase "off" and "on", then RFW_DEEP_LADDER 1 and 0 at 3 bounces
#: (where the ladder has its sub-floor rungs) with "off"
COMPACTION_BENCH_RUNS = (
    *((dict(RFW_COMPACTION=c), mode, ()) for c in ("1", "0") for mode in ("off", "on")),
    *((dict(RFW_DEEP_LADDER=lad), "off", ("--bounces", 3)) for lad in ("1", "0")))
#: bench_nee in its default mode, then its sweep at one light count on
#: each side of POTENTIAL_MAX's default 16
NEE_ARGV = ((), ("--sweep", "--counts", "4,32"))
#: the shading and gather tools and the two-phase stages, at the reference
#: tools' default sizes
SHADING_TOOL_RUNS = (("profile_shading", ()), ("ubench_atlas", ()), ("ubench_gather", ()),
                     ("ubench_gather", ("--sweep-size",)),
                     ("ubench_gather", ("--sweep-width",)),
                     ("bench_fused_stages", ("--case", "sorted")),
                     ("bench_fused_stages", ("--case", "sorted", "--pallas-A")))
PROFILE_DYNAMICS_ARGV = ("--no-pica",)


@contextmanager
def host_reads():
    """Count render_sample's host reads of a live count: the calls of
    `_pick_prefix` (the bounce vertex's and vertex 0's prefix lengths) and
    the vertex-0 compaction sort (a torch.sort called from `_vertex0`
    itself; the bounce sort runs in `_sort_state`)."""
    from rfw_tpu_torch.render import wavefront as wf

    reads = Counter()
    pick, sort = wf._pick_prefix, torch.sort

    def counted_pick(sizes, live):
        reads["_pick_prefix"] += 1
        return pick(sizes, live)

    def counted_sort(*a, **k):
        if sys._getframe(1).f_code.co_name == "_vertex0":
            reads["vertex-0 sort"] += 1
        return sort(*a, **k)

    with patched(wf, _pick_prefix=counted_pick), patched(torch, sort=counted_sort):
        yield reads


def phase17a(card, dev, scene, mats, atlas, lights, view, base) -> dict:
    """RFW_COMPACTION=0 on the flagship at 1080p, two_phase "off" then
    "on": no host read of a live count (the compacted sample makes two
    `_pick_prefix` calls and the vertex-0 sort), the Sobol HDR frame equal
    to the compacted one per pixel within the wavefront tolerance, and,
    under "off", K1/K2 against their plain versions on the captured
    uncompacted calls (every lane of the frame, dead ones included; the
    primaries are phase 5's); then ms per sample compacted against
    uncompacted in turns, the uncompacted "on" run counted. Returns the
    compared rows by kind and that run's launches."""
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample

    def sample(c, s):
        return render_sample(scene, mats, atlas, lights, view, W, H, c, sample_index=s)

    def uncompacted():
        return env(RFW_COMPACTION="0")

    rows = defaultdict(list)
    cfgs = {}
    for mode in ("off", "on"):
        cfg = cfgs[mode] = RenderConfig(**{**base, "two_phase": mode})
        with host_reads() as on:
            ref = sample(cfg, 7).radiance
        with uncompacted(), host_reads() as off:
            got = sample(cfg, 7).radiance
        torch.cuda.synchronize()
        log(card, f"phase 17 (a) two_phase={mode}: host reads of a live count a sample, "
                  f"compacted {dict(on)}, RFW_COMPACTION=0 {dict(off)}")
        assert on["_pick_prefix"] == 1 + BOUNCES and on["vertex-0 sort"] == 1, dict(on)
        assert not off, f"RFW_COMPACTION=0 read a live count: {dict(off)}"
        err = (got - ref).abs()
        px_ok = (err <= 1e-3 + 1e-3 * ref.abs()).all(dim=1).float().mean().item()
        m_got, m_ref = got.mean().item(), ref.mean().item()
        log(card, f"phase 17 (a) two_phase={mode}: RFW_COMPACTION=0 against the compacted "
                  f"sample: {px_ok:.6f} of pixels within 1e-3 abs + 1e-3 rel, pixels equal "
                  f"{(got == ref).all(dim=1).float().mean().item():.6f}, max abs err "
                  f"{err.max().item():.3e}, mean {m_got:.6f} vs {m_ref:.6f}")
        assert bool(torch.isfinite(got).all()), "non-finite radiance (RFW_COMPACTION=0)"
        assert px_ok >= 0.99 and abs(m_got - m_ref) <= 1e-3 * m_ref, (px_ok, m_got, m_ref)
        if mode == "off":
            with uncompacted():
                calls = capture_traversal(lambda: sample(cfg, 8))
            labels = [(label, o.shape[0]) for label, _, _, o, _, _ in calls]
            assert [n for _, n in labels] == [W * H] * 4, labels
            for label, kind, ps, o, d, tl in calls[1:]:  # the primaries are phase 5's
                rows[kind].append(compare_call(card, f"uncompacted {label}", kind, ps, o, d,
                                               tl))
            bounce = calls[2][5]
            log(card, f"phase 17 (a): the uncompacted bounce call traced {bounce.shape[0]} "
                      f"lanes, {int((bounce > 0).sum())} live")
            assert int((bounce <= 0).sum()) > 0, "the uncompacted bounce call has no dead lane"
            del calls
    launches, _, _ = ab_samples(card, dev, "flagship scene, compaction on and off", [
        ("compacted, off", cfgs["off"], env), ("RFW_COMPACTION=0, off", cfgs["off"], uncompacted),
        ("compacted, on", cfgs["on"], env),
        ("RFW_COMPACTION=0, on", cfgs["on"], uncompacted)],
        sample, counted="RFW_COMPACTION=0, on")
    for k in BENCH_LAUNCHES["on"]:
        assert launches[k] > 0, f"the uncompacted two-phase path never launched {k}"
    return dict(rows=rows, launches=launches)


def phase17b(card) -> list:
    """The bench as subprocesses under RFW_COMPACTION 1 and 0 ("off",
    "on") and RFW_DEEP_LADDER 1 and 0 (3 bounces, "off"): each run
    launches the kinds its path needs, and no other."""
    lines = bench_subprocesses(card, "phase 17 (b)", BENCH_ARGV, COMPACTION_BENCH_RUNS)
    for run in lines:
        got = set(run["line"]["launches_per_sample"])
        assert got == set(BENCH_LAUNCHES[run["two_phase"]]), (run["env"], run["flags"], got)
    return lines


def phase17c(card) -> list:
    """bench_nee in its default mode and sweeping 4 and 32 point lights:
    finite variances, each child with the POTENTIAL_MAX it was given."""
    from rfw_tpu_torch.tools import bench_nee

    out = []
    for argv in NEE_ARGV:
        t0 = time.perf_counter()
        res = run_tool(card, bench_nee.main, list(argv))
        pairs = ([(x, pm) for row in res["sweep"] for x, pm in ((row["potential"], 4096),
                                                                 (row["power"], 0))]
                 if "sweep" in res else [(res["potential"], 16), (res["power"], 0)])
        for child, pm in pairs:
            assert child["potential_max"] == pm, (child, pm)
            assert all(math.isfinite(child[k]) and child[k] > 0
                       for k in ("var_mean", "var_median", "lum_mean", "sec_frame")), child
        log(card, f"phase 17 (c) bench_nee {' '.join(map(str, argv))}: "
                  f"{time.perf_counter() - t0:.2f} s")
        out.append(res)
    return out


def phase17d(card) -> None:
    """The shading, atlas and gather tools and the two-phase stages at the
    reference tools' defaults: every stage reported, and positive."""
    import importlib

    from rfw_tpu_torch.tools import profile_shading, ubench_atlas, ubench_gather

    for name, flags in SHADING_TOOL_RUNS:
        tool = importlib.import_module(f"rfw_tpu_torch.tools.{name}")
        t0 = time.perf_counter()
        res = run_tool(card, tool.main, list(flags))
        log(card, f"phase 17 (d) {name} {' '.join(map(str, flags))}: "
                  f"{time.perf_counter() - t0:.2f} s")
        keys = {"profile_shading": profile_shading.STAGES, "ubench_atlas": ubench_atlas.STAGES,
                "ubench_gather": ([f"{c[0]}_{loc}" for c in ubench_gather.sweep_cases()
                                   for loc in ("rand", "sorted")]
                                  if "--sweep-size" in flags else
                                  [f"f32x{c}_{form}" for c in ubench_gather.WIDTHS
                                   for form in ubench_gather.FORMS]
                                  if "--sweep-width" in flags else ubench_gather.GATHERS),
                "bench_fused_stages": ("A.k4" if "--pallas-A" in flags else "A.dense",
                                       "B.pack", "C.items", "D.merge")}[name]
        assert all(res[k] > 0 for k in keys), (name, flags, res)
        if name == "bench_fused_stages":
            assert 0 < res["occupied_slots"] <= res["slots"], res


def phase17e(card) -> None:
    """profile_dynamics with skinned_gltf() as its CesiumMan, without
    pica: its dirty skin sync takes the device route."""
    import tempfile

    from rfw_tpu_torch.tools import profile_dynamics

    with tempfile.TemporaryDirectory() as root:
        man = Path(root) / "CesiumMan"
        man.mkdir()
        (man / "CesiumMan.gltf").write_text(json.dumps(skinned_gltf()))
        res = run_tool(card, profile_dynamics.main, [*PROFILE_DYNAMICS_ARGV, "--assets", root])
    assert res["mode"] == "device", f"profile_dynamics' skin sync took the {res['mode']} route"


def phase17(card, dev, scene, mats, atlas, lights, view, base) -> dict:
    """The port's last switches and tools on the card: (a) RFW_COMPACTION=0
    in-process, (b) the bench A/B of RFW_COMPACTION and RFW_DEEP_LADDER,
    (c) bench_nee, (d) the shading tools and the two-phase stages, (e)
    profile_dynamics. Returns (a)'s compared rows and launches."""
    t_phase = time.perf_counter()
    out = phase17a(card, dev, scene, mats, atlas, lights, view, base)
    log(card, f"phase 17 (a): {time.perf_counter() - t_phase:.2f} s")
    phase17b(card)
    phase17c(card)
    phase17d(card)
    phase17e(card)
    log(card, f"phase 17: {time.perf_counter() - t_phase:.2f} s")
    return out


# ---- phase 18: textures without Pillow
TEXTURES = Path(__file__).resolve().parent / "tests" / "golden" / "textures"
#: the fixtures the phase's glTF embeds: a non-power-of-two baseline 4:2:0
#: JPEG as baseColor, a PNG as metallic-roughness
TEX_BASE, TEX_MR = "base420_37x53.jpg", "mr_24x20.png"
TEX_W, TEX_H = 640, 360
BIG_PNG = 2048  # side of the PNG the phase writes with utils/png.py and times
TIMED_JPEG = "gradient_1024.jpg"


def textured_gltf(base: bytes, mr: bytes) -> dict:
    """A 4 x 4 quad (uv 0-1, 2 triangles) instanced by two nodes, a floor
    and a wall standing at its back edge, its material textured by `base`
    (baseColorTexture) and `mr` (metallicRoughnessTexture), both embedded
    as data URIs."""
    import base64

    f32 = np.float32
    parts = [("VEC3", 5126, np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], f32)),
             ("VEC3", 5126, np.tile(np.array([0, 1, 0], f32), (4, 1))),
             ("VEC2", 5126, np.array([[0, 0], [1, 0], [1, 1], [0, 1]], f32)),
             ("SCALAR", 5123, np.array([0, 2, 1, 0, 3, 2], np.uint16))]
    buf, views, accessors = b"", [], []
    for type_, ctype, arr in parts:
        raw = arr.tobytes()
        views.append({"buffer": 0, "byteOffset": len(buf), "byteLength": len(raw)})
        accessors.append({"bufferView": len(views) - 1, "componentType": ctype,
                          "count": len(arr), "type": type_})
        buf += raw + b"\0" * (-len(raw) % 4)

    def uri(mime, raw):
        return f"data:{mime};base64," + base64.b64encode(raw).decode()

    s = float(np.sin(np.pi / 4))
    return {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": uri("application/octet-stream", buf), "byteLength": len(buf)}],
        "bufferViews": views, "accessors": accessors,
        "images": [{"uri": uri("image/jpeg", base)}, {"uri": uri("image/png", mr)}],
        "textures": [{"source": 0}, {"source": 1}],
        "materials": [{"name": "textured", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "metallicRoughnessTexture": {"index": 1},
            "metallicFactor": 0.3, "roughnessFactor": 0.8}}],
        "meshes": [{"name": "quad", "primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2}, "indices": 3,
            "material": 0}]}],
        "nodes": [{"name": "floor", "mesh": 0},
                  {"name": "wall", "mesh": 0, "translation": [0, 2, -2],
                   "rotation": [s, 0, 0, s]}],
        "scenes": [{"nodes": [0, 1]}], "scene": 0,
    }


def atlas_texels(atlas, tex_id: int) -> np.ndarray:
    """Mip 0 of texture `tex_id` as (H, W, 4) uint8, read back from the
    atlas's packed texel rows (each row's first column is its own texel)."""
    off, w, h = (int(a[tex_id, 0]) for a in (atlas.offset, atlas.width, atlas.height))
    packed = atlas.texels[off:off + w * h, 0].cpu().numpy().astype(np.uint32)
    return (packed[:, None] >> np.array([0, 8, 16, 24], np.uint32) & 0xFF).astype(
        np.uint8).reshape(h, w, 4)


def decode_ms_per_mp(card, label, data: bytes, pixels: int, reps: int = 3):
    """Decode `data` `reps` times on the host clock: (the array, the fastest
    run's ms per megapixel)."""
    from rfw_tpu_torch.utils.image import decode_image

    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = decode_image(data, label)
        runs.append((time.perf_counter() - t0) * 1e3)
    per_mp = min(runs) / (pixels / 1e6)
    log(card, f"host decode of {label} ({len(data)} B, {pixels / 1e6:.3f} MP): "
              f"{', '.join(f'{r:.2f}' for r in runs)} ms, {per_mp:.2f} ms per megapixel "
              f"(fastest of {reps})")
    return out, per_mp


@contextmanager
def without_pillow():
    """Make `import PIL` raise ImportError inside the block, whether or not
    Pillow is installed, and restore sys.modules after it."""
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == "PIL" or k.startswith("PIL.")}
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved)


def phase18(card, dev) -> dict:
    """Phase 18's checks (`textures_on_card`) with `import PIL` blocked:
    the port must not need Pillow, whether or not the machine has it."""
    import importlib.util

    log(card, f"phase 18: Pillow installed here: {importlib.util.find_spec('PIL') is not None}; "
              f"its import is blocked for the phase")
    with without_pillow():
        return textures_on_card(card, dev)


def textures_on_card(card, dev) -> dict:
    """Textures without Pillow on the card's machine: (a) the committed
    fixtures of tests/golden/textures decoded by utils/image.py and held to
    the arrays Pillow decoded when they were made (bit for bit: every .npy,
    and the 1024x1024 JPEG's SHA-256); (b) a glTF embedding TEX_BASE as
    baseColor and TEX_MR as metallic-roughness loaded through Scene into
    TorchBackend: both textures' mip 0, on the host and in the card's atlas,
    equal the committed 64x64 arrays Pillow's bilinear resize made; one
    frame, launch counters reset just before it and read just after, must
    launch K1 and K2 and no K3 (the bounce rays by K1 under "auto" on the
    card) and be finite and non-zero; (c) host decode ms per
    megapixel of a 2048x2048 PNG written here by utils/png.py and of the
    committed 1024x1024 JPEG. Returns (b)'s launches."""
    import hashlib
    import tempfile

    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
    from rfw_tpu_torch.scene import Camera3D, Scene
    from rfw_tpu_torch.utils.image import read_image
    from rfw_tpu_torch.utils.png import encode_png

    t_phase = time.perf_counter()
    # ---- (a) the fixtures
    manifest = json.loads((TEXTURES / "manifest.json").read_text())
    for name, meta in sorted(manifest.items()):
        got = read_image(TEXTURES / name)
        digest = hashlib.sha256(got.tobytes()).hexdigest()
        ref = TEXTURES / f"{name}.npy"
        same = np.array_equal(got, np.load(ref)) if ref.exists() else None
        log(card, f"fixture {name}: {got.shape[1]}x{got.shape[0]}, equal to Pillow's decode: "
                  f"{'array ' + str(same) if same is not None else 'not stored'}, "
                  f"SHA-256 equal {digest == meta['sha256']}")
        assert list(got.shape) == meta["shape"] and digest == meta["sha256"], name
        assert same in (True, None), name

    # ---- (b) the textured glTF through Scene and TorchBackend
    scene = Scene()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d, "textured.gltf")
        path.write_text(json.dumps(textured_gltf((TEXTURES / TEX_BASE).read_bytes(),
                                                 (TEXTURES / TEX_MR).read_bytes())))
        scene.add_3d(scene.load(str(path)))
    scene.add_directional_light((0.3, -1.0, -0.5), (2.0, 1.9, 1.8))
    mat = next(m for _, m in scene.materials.materials if m.name == "textured")
    slots = {TEX_BASE: mat.diffuse_tex, TEX_MR: mat.metallic_roughness_tex}
    settings = TorchSettings(samples_per_frame=1, max_bounces=BOUNCES, clamp=20.0,
                             sky_intensity=0.35, sampler="sobol")
    be = TorchBackend(TEX_W, TEX_H, settings)
    assert be.device.type == "cuda", be.device
    scene.synchronize(be)
    cam = Camera3D(fov=50).look_at(np.array([0.0, 2.2, 6.0], np.float32),
                                   np.array([0.0, 1.0, -1.0], np.float32))
    view = cam.get_view(TEX_W, TEX_H)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    frame = be.render(None, view)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    for name, slot in slots.items():
        want = np.load(TEXTURES / f"{name}.pow2.npy")
        host = scene.materials.textures[slot].mips[0]
        card_texels = atlas_texels(be._atlas_dev, slot)
        log(card, f"glTF texture {name} (slot {slot}, srgb "
                  f"{scene.materials.textures[slot].srgb}): mip 0 {host.shape[1]}x"
                  f"{host.shape[0]}, host equal to Pillow's resize {np.array_equal(host, want)}, "
                  f"card atlas equal {np.array_equal(card_texels, want)}")
        assert np.array_equal(host, want) and np.array_equal(card_texels, want), name
    hdr = be.hdr_frame()
    log(card, f"textured glTF frame {TEX_W}x{TEX_H} (first render, with the first upload): "
              f"{frame_ms:.2f} ms, launches {launches}, mean radiance {hdr.mean():.6f}, "
              f"mean 8-bit value {frame[..., :3].mean():.3f}")
    assert np.isfinite(hdr).all() and hdr.mean() > 0 and frame[..., :3].max() > 0
    for k in ("closest", "occluded"):
        assert launches[k] > 0, f"the textured glTF's frame never launched {k}"
    assert launches["items_closest"] == 0, "the textured glTF's frame took the two-phase route"

    # ---- (c) host decode time per megapixel
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:BIG_PNG, 0:BIG_PNG]
    big = np.stack([xx // 8, yy // 8, (xx + yy) // 16, 255 - xx // 8], -1) % 256
    big = (big + rng.integers(0, 4, big.shape)).astype(np.uint8)
    png = encode_png(big)
    got, png_ms = decode_ms_per_mp(card, f"{BIG_PNG}x{BIG_PNG} RGBA PNG (utils/png.py, "
                                         f"filter 0)", png, BIG_PNG * BIG_PNG)
    assert np.array_equal(got, big), "the PNG decode differs from the encoded array"
    jpeg = (TEXTURES / TIMED_JPEG).read_bytes()
    got, jpeg_ms = decode_ms_per_mp(card, f"{TIMED_JPEG} (baseline 4:2:0)", jpeg, 1024 * 1024)
    assert hashlib.sha256(got.tobytes()).hexdigest() == manifest[TIMED_JPEG]["sha256"]
    log(card, f"phase 18: {time.perf_counter() - t_phase:.2f} s")
    return launches


# ------------------------------------------------------------------ phase 19
#: the card's INT32 rate: 64 a clock per SM (half its fp32 lanes), 132 SMs,
#: 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SOBOL_REPS = 10


def sobol_ops(n: int) -> int:
    """32-bit operations of one lane of csrc/sampler.cu's n-uniform draw, as
    its source writes them: a hash 8 (three shifts, three xors, two
    products), a Laine-Karras permutation 9 (a sum, four products, four
    xors), an Owen scramble 11 (two __brev and the permutation), a bit of
    sobol_dim1 2 (a test, an xor), a uniform 2 (a conversion, a scaling)."""
    hash_, owen = 8, 2 + 9
    ops = 3 + hash_  # seed: two products, a sum, the hash
    ops += hash_ + owen  # the scrambled index
    ops += 1 + 1 + hash_ + owen  # d0: __brev, the seed's xor, its hash, the scramble
    ops += 2 * 32 + 1 + hash_ + owen  # d1
    ops += 2 * 2
    if n == 3:
        ops += 1 + hash_ + owen + 1 + 2  # d2
    return ops


def sobol_bound(n: int, lanes: int, per_lane_index: bool = False) -> tuple:
    """(least ms, "bytes" or "operations") of one n-uniform draw over
    `lanes`: the pixel ids (and per-lane indices) read and the uniforms
    written at 3.35 TB/s against sobol_ops at the INT32 rate."""
    n_bytes = lanes * (4 + 4 * per_lane_index + 4 * n)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = lanes * sobol_ops(n) / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def capture_sobol(run) -> list:
    """run()'s Sobol draws: (sample_index, pixel ids, slot, n) of each."""
    from rfw_tpu_torch.render import wavefront as wf

    calls, draw = [], wf.sample_slot

    def capture(sample_index, pid, slot, n=2):
        calls.append((sample_index, pid.clone(), slot, n))
        return draw(sample_index, pid, slot, n)

    with patched(wf, sample_slot=capture):
        run()
    torch.cuda.synchronize()
    return calls


def phase19(card, dev, scene, mats, atlas, lights, view, base) -> dict:
    """The Sobol kernel on the main path's pixel ids: one 1080p sample's
    draws captured (camera jitter on the swizzled ids, vertex 0's sorted
    hit prefix, a bounce's live prefix), each launched once and bit for
    bit the plain version's, also with a per-lane index; its card ms over
    SOBOL_REPS launches beside its bound and the plain version's ms.
    Returns the kernels line's entry."""
    from rfw_tpu_torch.render import sampler
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample

    t_phase = time.perf_counter()
    cfg = RenderConfig(**dict(base, two_phase="auto"))
    before = sampler.LAUNCHES
    calls = capture_sobol(lambda: render_sample(scene, mats, atlas, lights, view, W, H, cfg,
                                                sample_index=3))
    draws = sampler.LAUNCHES - before
    log(card, f"phase 19: one 1080p sample draws {len(calls)} times, {draws} Sobol kernel "
              f"launches: " + ", ".join(f"slot {c[2]} n={c[3]} {c[1].shape[0]} lanes"
                                        for c in calls))
    assert draws == len(calls) == 5, (draws, len(calls))
    rows = []
    for si, pid, slot, n in calls:
        before = sampler.LAUNCHES
        got = sampler.sample_slot(si, pid, slot, n)
        assert sampler.LAUNCHES == before + 1
        ref = sampler.sample_slot_plain(si, pid, slot, n)
        assert torch.equal(bits(got), bits(ref)), f"slot {slot}: kernel and plain differ"
        ms = cuda_ms(lambda: sampler.sample_slot(si, pid, slot, n), SOBOL_REPS)
        plain_ms = cuda_ms(lambda: sampler.sample_slot_plain(si, pid, slot, n), SOBOL_REPS)
        bound_ms, bound_by = sobol_bound(n, pid.shape[0])
        rows.append(dict(slot=slot, n=n, lanes=pid.shape[0], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0))
        log(card, f"phase 19 sobol slot {slot} n={n} on {pid.shape[0]} lanes: identical; "
                  f"kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                  f"{sobol_ops(n)} operations a lane), {100 * bound_ms / ms:.1f}% of it; "
                  f"plain {plain_ms:.3f} ms")
    si, pid, slot, n = calls[2]
    idx = torch.arange(pid.shape[0], dtype=torch.int64, device=dev) * 2654435761 + 2**32
    for n in (2, 3):
        assert torch.equal(bits(sampler.sample_slot(idx, pid, slot, n)),
                           bits(sampler.sample_slot_plain(idx, pid, slot, n))), "per-lane index"
    ms, plain_ms = sum(r["ms"] for r in rows), sum(r["plain_ms"] for r in rows)
    log(card, f"phase 19: a sample's 5 draws: kernel {ms:.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in rows):.4f} ms, plain {plain_ms:.2f} ms; a per-lane "
              f"index identical too; {time.perf_counter() - t_phase:.2f} s")
    return kernel_row("S1 sobol_slot", "rfw_tpu_torch/csrc/sampler.cu", None, draws, rows)


# ------------------------------------------------------------------ phase 20
DISNEY_REPS = 10
#: float planes a lane of csrc/disney.cu reads: the 14 of the material
#: (`anisotropic` unread), wo, and wi or the 3 uniforms
DISNEY_PLANES_IN = 20


def capture_disney(run) -> list:
    """run()'s BSDF calls at wavefront.py's sites: ("eval_pdf", p, wo, wi,
    features, with_pdf) or ("sample", p, wo, u0, u1, u2, features) each,
    its inputs held as they lie (the main path writes none of them in
    place), so their strides are the main path's."""
    from rfw_tpu_torch.render import disney

    calls, eval_pdf, sample = [], disney.disney_eval_pdf_c, disney.disney_sample_c

    def cap_eval_pdf(p, wo, wi, features=disney.FEAT_ALL, with_pdf=True):
        calls.append(("eval_pdf", p, wo, wi, features, with_pdf))
        return eval_pdf(p, wo, wi, features, with_pdf)

    def cap_sample(p, wo, u0, u1, u2, features=disney.FEAT_ALL):
        calls.append(("sample", p, wo, u0, u1, u2, features))
        return sample(p, wo, u0, u1, u2, features)

    with patched(disney, disney_eval_pdf_c=cap_eval_pdf, disney_sample_c=cap_sample):
        run()
    torch.cuda.synchronize()
    return calls


def disney_call(call, plain: bool):
    """One captured BSDF call through the kernel or the plain versions, its
    outputs flattened: (float planes, is_delta or None)."""
    from rfw_tpu_torch.render import disney

    if call[0] == "eval_pdf":
        _, p, wo, wi, features, with_pdf = call
        if plain:
            f = disney.disney_eval_plain_c(p, wo, wi, features)
            pdf = disney.disney_pdf_plain_c(p, wo, wi, features) if with_pdf else None
        else:
            f, pdf = disney.disney_eval_pdf_c(p, wo, wi, features, with_pdf)
        return [*f, *([pdf] if with_pdf else [])], None
    _, p, wo, u0, u1, u2, features = call
    fn = disney.disney_sample_plain_c if plain else disney.disney_sample_c
    wi, f, pdf, is_delta = fn(p, wo, u0, u1, u2, features)
    return [*wi, *f, pdf], is_delta


def disney_bound(call) -> float:
    """Least ms of one BSDF call: its input planes read and its outputs
    written at 3.35 TB/s (bytes bound it: csrc/disney.cu's head note)."""
    lanes = call[2][2].shape[0]
    if call[0] == "eval_pdf":
        out_bytes = 4 * (4 if call[5] else 3)
    else:
        out_bytes = 4 * 7 + 1
    return lanes * (4 * DISNEY_PLANES_IN + out_bytes) / HBM_BYTES_PER_S * 1e3


def phase20(card, dev, scene, mats, atlas, lights, view, base) -> dict:
    """The Disney BSDF kernels (B1) on the main path's inputs: one 1080p
    1-bounce sample's 3 BSDF calls captured (vertex 0's NEE eval + pdf and
    its sample, the bounce's NEE eval + pdf), on their strided column views
    and the config's feature mask; each launched once (disney.LAUNCHES
    rises by exactly 1) and bit for bit the plain versions'; its card ms
    over DISNEY_REPS launches beside its bound and the plain versions' ms.
    Returns the kernels line's entry."""
    from rfw_tpu_torch.render import disney
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample

    t_phase = time.perf_counter()
    cfg = RenderConfig(**base)
    before = disney.LAUNCHES
    calls = capture_disney(lambda: render_sample(scene, mats, atlas, lights, view, W, H, cfg,
                                                 sample_index=3))
    launches = disney.LAUNCHES - before
    log(card, f"phase 20: one 1080p sample makes {len(calls)} BSDF calls, {launches} kernel "
              f"launches: " + ", ".join(f"{c[0]} {c[2][2].shape[0]} lanes" for c in calls))
    assert [c[0] for c in calls] == ["eval_pdf", "sample", "eval_pdf"], [c[0] for c in calls]
    assert launches == len(calls) == 3, (launches, len(calls))
    strided = sum(t.stride(0) != 1 for t in disney._planes(calls[0][1], calls[0][2], calls[0][3]))
    rows = []
    for call in calls:
        before = disney.LAUNCHES
        got, got_delta = disney_call(call, plain=False)
        assert disney.LAUNCHES == before + 1, "a BSDF call launched other than once"
        ref, ref_delta = disney_call(call, plain=True)
        assert len(got) == len(ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert torch.equal(bits(g), bits(r)), f"{call[0]} output {i}: kernel and plain differ"
        if got_delta is not None:
            assert torch.equal(got_delta, ref_delta), "sample is_delta: kernel and plain differ"
        ms = cuda_ms(lambda: disney_call(call, plain=False), DISNEY_REPS)
        plain_ms = cuda_ms(lambda: disney_call(call, plain=True), DISNEY_REPS)
        lanes = call[2][2].shape[0]
        bound_ms = disney_bound(call)
        rows.append(dict(call=call[0], features=call[-2] if call[0] == "eval_pdf" else call[-1],
                         lanes=lanes, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by="bytes", max_abs_err=0.0))
        log(card, f"phase 20 {call[0]} on {lanes} lanes: identical; kernel {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms (bytes), {100 * bound_ms / ms:.1f}% of it; plain "
                  f"{plain_ms:.3f} ms")
    ms, plain_ms = sum(r["ms"] for r in rows), sum(r["plain_ms"] for r in rows)
    log(card, f"phase 20: a sample's 3 BSDF calls ({strided} of the 20 input planes strided "
              f"views): kernel {ms:.4f} ms, bound {sum(r['bound_ms'] for r in rows):.4f} ms, "
              f"plain {plain_ms:.2f} ms; {time.perf_counter() - t_phase:.2f} s")
    return kernel_row("B1 disney", "rfw_tpu_torch/csrc/disney.cu", None, launches, rows)


def phase_alone(card, lib: str, phase) -> int:
    """Phase 19 or 20 alone (`python3 chip_smoke.py --sobol` or `--disney`)
    on phase 2's scene and phase 5's settings: `lib` builds first, the
    other kernels at first use."""
    from rfw_tpu_torch.convert import from_numpy_scene
    from rfw_tpu_torch.scenes import build_scene

    from rfw_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    (built,) = _build.build([lib])
    log(card, f"{lib} kernel build: {built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(card, f"ptxas {lib}: " + line.strip())
    scene_np, mats_np, lights_np, atlas_np, camera, _, _ = build_scene(SEED, views=True)
    scene, mats, lights, atlas = from_numpy_scene(scene_np, mats_np, lights_np, atlas_np, dev)
    view = torch.from_numpy(camera.get_view(W, H).as_array()).to(dev)
    base = main_path_settings(mats_np, lights_np)
    print(json.dumps({"kernels": [phase(card, dev, scene, mats, atlas, lights, view, base)]}))
    print(card)
    return 0


def sass_against(card, other: Path) -> None:
    """The walk kernels' SASS against another tree's (`python3 chip_smoke.py
    --sass-against DIR`, DIR e.g. the parent commit unpacked by `git
    archive`): each tree builds its own libraries (DIR's in a subprocess
    from its root) and this script's sass_census digests both. Logs, per
    instance of arity 8, whether its digest equals DIR's (instances match
    by symbol, the arity parameter and the anonymous namespace dropped)."""
    from rfw_tpu_torch.ops import _build

    code = ("import json; from rfw_tpu_torch.ops import _build; print(json.dumps("
            f"[str(b.path) for b in _build.build({list(WALK_LIBS)!r})]))")
    res = subprocess.run([sys.executable, "-c", code], cwd=other, capture_output=True,
                         text=True, timeout=900, check=True)
    theirs = sass_census(card, paths=json.loads(res.stdout.strip().splitlines()[-1]))[2]
    ours = sass_census(card, paths=[b.path for b in _build.build(list(WALK_LIBS))])[2]

    def key(fn):
        fn = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "", fn)
        return fn.replace("ELi8EEEv", "EEEv")

    theirs = {key(fn): h for fn, h in theirs.items()}
    rows = [(fn, h, theirs.get(key(fn))) for fn, h in sorted(ours.items())
            if not re.search(r"ELi(16|32)E", fn)]
    for fn, h, t in rows:
        log(card, f"SASS {'equal' if h == t else 'differs'}: {fn} {h} ({other}: {t})")
    log(card, f"SASS of arity 8 against {other}: {sum(h == t for _, h, t in rows)} of "
              f"{len(rows)} instances equal ({len(theirs)} there)")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    if sys.argv[1:2] == ["--sass-against"]:
        sass_against(card_line(), Path(sys.argv[2]).resolve())
        return 0
    if sys.argv[1:2] == ["--sobol"]:
        return phase_alone(card_line(), "sampler", phase19)
    if sys.argv[1:2] == ["--disney"]:
        return phase_alone(card_line(), "disney", phase20)
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
    from rfw_tpu_torch import native
    from rfw_tpu_torch.render.wavefront import RenderConfig

    # the native host runtime, at its first use (the host build's default)
    native_build = native.build()
    log(card, f"native host library: built by g++ in {native_build.seconds:.3f} s "
              f"({'/'.join(native_build.path.parts[-4:])})")

    launch_shapes(card, W * H)

    # ---- 2. scene
    from rfw_tpu_torch.convert import from_numpy_scene
    from rfw_tpu_torch.render.film import add_sample, new_film, tonemap
    from rfw_tpu_torch.render.wavefront import render_sample
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
    base = main_path_settings(mats_np, lights_np)
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
    from rfw_tpu_torch.render import disney

    cfg = RenderConfig(**base)

    def sample(s):
        return render_sample(scene, mats, atlas, lights, view_full, W, H, cfg, sample_index=s)

    # warm-up sample, its traversal inputs captured; the kernels against
    # their plain versions on exactly those inputs
    calls = capture_traversal(lambda: sample(0))  # phase 16 reuses them
    main_rows = compare_main_path(card, calls)
    assert set(main_rows) == {"closest", "occluded"}, f"traversal calls seen: {list(main_rows)}"
    torch.cuda.synchronize()
    film = new_film(W, H, device=dev)
    reset_launches()
    disney.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for s in range(SPP):
        add_sample(film, sample(s + 1).radiance)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: read_launches()[k] for k in tr.LAUNCHES}
    assert disney.LAUNCHES == 3 * SPP, f"B1 launched {disney.LAUNCHES} times in {SPP} samples"
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

    # ---- 11. the app on the card: Instance, Scene, run_windowed
    app_launches = phase11(card, dev, parts, scene_np, camera)

    # ---- 12. dynamics and the random sampler
    dyn_launches = phase12(card, dev, parts, camera, scene, mats, atlas, lights, view_full,
                           base)

    # ---- 13. the scale-out layer and the examples
    par_launches = phase13(card, dev, scene, mats, atlas, lights, view_full, base)

    # ---- 14. the native host builder, the traversal tiers, the public
    # two-phase call and the device LBVH
    closing = phase14(card, dev, parts, (mats_np, lights_np, atlas_np), camera, scene, mats,
                      atlas, lights, base, ps, tp["rays"], native_build)
    del tp["rays"]

    # ---- 15. the measurement entry point, the layer tools, torch_animated
    bench_launches = phase15(card)

    # ---- 16. wide supernodes (RFW_WIDE_ARITY 16, 32) and the sort keys
    wide = phase16(card, dev, built, calls, tp, heavy, parts, camera,
                   (scene, mats, lights, atlas), base, ps)
    del calls

    # ---- 17. RFW_COMPACTION, RFW_DEEP_LADDER, RFW_POTENTIAL_MAX and the
    # last tools
    p17 = phase17(card, dev, scene, mats, atlas, lights, view_full, base)

    # ---- 18. textures decoded without Pillow, a textured glTF on the card
    tex_launches = phase18(card, dev)

    # ---- 19. the Sobol kernel on the main path's pixel ids
    sobol_row = phase19(card, dev, scene, mats, atlas, lights, view_full, base)

    # ---- 20. the Disney BSDF kernels on the main path's inputs
    disney_row = phase20(card, dev, scene, mats, atlas, lights, view_full, base)

    row = kernel_row

    def fallback(kind):
        return [r for fb in (tp["fallback"], heavy["fallback"]) for r in fb[kind]]

    def walk_row(name, kind, cmp_err):
        rows = main_rows[kind]
        late = p17["rows"][kind]  # phase 17 (a)'s uncompacted calls
        return row(name, "rfw_tpu_torch/csrc/traverse.cu", "rfw_tpu/ops/traverse.py:335",
                   launches[kind], rows,
                   [cmp_err, *(r["max_abs_err"] for r in [*fallback(kind), *late])],
                   fallback_calls=fallback(kind), uncompacted_calls=late, arity=8)

    items_src = "rfw_tpu_torch/csrc/traverse_items.cu"
    kernels = [
        walk_row("K1 closest_hit", "closest", cmp["K1"]),
        walk_row("K2 occluded", "occluded", cmp["K2"]),
        row("K3 items closest", items_src, "rfw_tpu/ops/traverse_items.py:107",
            tp["launches"]["items_closest"], tp["K3"], [r["max_abs_err"] for r in heavy["K3"]],
            arity=8),
        row("K5 items any-hit", items_src, "rfw_tpu/ops/traverse_items.py:107",
            heavy["launches"]["items_occluded"], heavy["K5"],
            [r["max_abs_err"] for r in tp["K5"]], arity=8),
        row("K4 tlas_entries", "rfw_tpu_torch/csrc/traverse_entries.cu",
            "rfw_tpu/ops/traverse_entries.py:53", heavy["launches"]["entries"], heavy["K4"],
            [r["max_abs_err"] for r in tp["K4"]], arity=8),
        row("K6 dense items (closest + any-hit)", items_src, "rfw_tpu/ops/traverse_items.py:527",
            heavy["launches"]["dense_closest"] + heavy["launches"]["dense_occluded"],
            heavy["K6"]),
        row("U1 ubench_leaf", "rfw_tpu_torch/csrc/ubench_leaf.cu", "tools/ubench_leaf.py:51",
            ubench["launches"]["leaf"], ubench["U1"], fused_ms=ubench["U1"][0]["fused_ms"],
            staged_ms=ubench["U1"][0]["staged_ms"]),
        row("U2 ubench_grid", "rfw_tpu_torch/csrc/ubench_grid.cu", "tools/ubench_grid.py:60",
            ubench["launches"]["grid"], ubench["U2"]),
    ]
    # each kernel's launches in phase 11's counted run, the app's first
    # frame, in phase 12's, the first dynamic frame, in phase 13's, one
    # film strip, and in phase 14's, the "pallas" tier's frame and the
    # public two-phase call
    app_kinds = {"K1": ("closest",), "K2": ("occluded",), "K3": ("items_closest",),
                 "K5": ("items_occluded",), "K4": ("entries",),
                 "K6": ("dense_closest", "dense_occluded"), "U1": ("leaf",), "U2": ("grid",)}
    for k in kernels:
        kinds = app_kinds[k["name"].split()[0]]
        k["launches_app"] = sum(app_launches[kind] for kind in kinds)
        k["launches_dynamics"] = sum(dyn_launches[kind] for kind in kinds)
        k["launches_parallel"] = sum(par_launches[kind] for kind in kinds)
        k["launches_tiers"] = sum(closing["tiers"][kind] for kind in kinds)
        k["launches_twophase_call"] = sum(closing["twophase_call"][kind] for kind in kinds)
        k["launches_bench"] = sum(bench_launches.get(kind, 0) for kind in kinds)
        k["launches_uncompacted"] = sum(p17["launches"].get(kind, 0) for kind in kinds)
        k["launches_textures"] = sum(tex_launches.get(kind, 0) for kind in kinds)
    kernels += [*wide["entries"], sobol_row, disney_row]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
