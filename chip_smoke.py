"""Smoke check of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives rfw_tpu_torch's main path — one progressive path-traced sample per
call of `render_sample`, 1920x1080, 1 bounce + next-event estimation, Sobol
sampler, film accumulation and tonemap — on a procedural scene at the
flagship scene's scale (4 icosphere meshes of 20,480 triangles, 256
instances, textured floor, area + spot + sun lights; made from a seed).

Phases (any failed check raises, so the script exits nonzero):
  1. set-up: needs CUDA; builds the CUDA kernels from rfw_tpu_torch/csrc;
  2. scene build and upload;
  3. each kernel against its plain torch version on 65,536 rays;
  4. a 256x144 render through the kernels against the same render through
     the plain traversal (traversal="lockstep");
  5. the main path at 1920x1080: a warm-up sample whose traversal inputs
     are captured, each kernel against its plain version on exactly those
     inputs (with both times), then 8 timed samples with the kernels'
     launch counters reset just before them;
  6. where the time goes: one sample with every stage bracketed by
     torch.cuda.synchronize(), one profiled sample (device time by
     kernel), and 4 samples traced with device activity only (the share
     of their span the device spent busy).
Every number is printed beside the card's name and power limit. The line
before the last two is {"kernels": [...]}: per kernel, its launches in the
timed samples, its largest disagreement with the plain version, and its
time and the plain version's per 1080p sample (the sum over the sample's
calls, each timed on that call's captured inputs). The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch

SEED = 7
W, H = 1920, 1080
SPP = 8
BOUNCES = 1
N_CMP = 65536


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


def build_scene(seed: int):
    """Procedural scene at the flagship scale, packed by the port's own
    numpy packers. Returns host arenas + camera view vector builder."""
    from rfw_tpu_torch.backend.lights import (
        DirectionalLightsView, PointLightsView, SpotLightsView,
    )
    from rfw_tpu_torch.mathx import compose_trs, quat_identity
    from rfw_tpu_torch.models import cube, quad3d, sphere
    from rfw_tpu_torch.render.atlas import pack_atlas
    from rfw_tpu_torch.render.lights_pack import pack_lights
    from rfw_tpu_torch.render.pack import pack_trace_scene
    from rfw_tpu_torch.scene import Camera3D, Material, Materials, Texture, extract_area_lights

    rng = np.random.default_rng(seed)
    mats = Materials()
    checker = ((np.indices((256, 256)).sum(0) // 32) % 2 * 170 + 60).astype(np.uint8)
    floor_tex = mats.push_texture(Texture.from_array(checker))
    m_floor = mats.push(Material(name="floor", color=np.array([0.8, 0.8, 0.8, 1], np.float32),
                                 roughness=0.7, diffuse_tex=floor_tex))
    sphere_mats = [
        mats.push(Material(name="diffuse", color=np.array([0.7, 0.25, 0.2, 1], np.float32),
                           roughness=0.8)),
        mats.push(Material(name="rough metal", color=np.array([0.9, 0.7, 0.4, 1], np.float32),
                           metallic=1.0, roughness=0.35)),
        mats.push(Material(name="clearcoat plastic", color=np.array([0.15, 0.3, 0.8, 1], np.float32),
                           roughness=0.5, clearcoat=1.0, clearcoat_gloss=0.9)),
        mats.push(Material(name="glass", color=np.array([0.95, 0.97, 1.0, 1], np.float32),
                           roughness=0.05, transmission=1.0, eta=1.5)),
    ]
    m_emit = mats.push(Material(name="emitter", color=np.array([9.0, 8.5, 7.5, 1], np.float32)))

    meshes, instances = [], []
    spacing = 3.0
    cells = [(i, j) for i in range(16) for j in range(16)]
    order = rng.permutation(len(cells))
    for k, mid in enumerate(sphere_mats):
        meshes.append((k, sphere(quality=5, material_id=mid), None))
        mk = []
        for c in order[64 * k:64 * (k + 1)]:
            i, j = cells[c]
            r = float(rng.uniform(0.5, 1.1))
            t = np.array([(i - 7.5) * spacing + rng.uniform(-0.6, 0.6), r,
                          (j - 7.5) * spacing + rng.uniform(-0.6, 0.6)], np.float32)
            mk.append(compose_trs(t, quat_identity(), np.full(3, r, np.float32)))
        instances.append((k, np.stack(mk)))
    half = 8 * spacing + 2.0
    floor = cube(position=(0.0, -0.1, 0.0), size=(2 * half, 0.2, 2 * half), material_id=m_floor)
    meshes.append((4, floor, None))
    instances.append((4, np.eye(4, dtype=np.float32)[None]))
    lamp = quad3d(normal=(0.0, -1.0, 0.0), position=(0.0, 9.0, 0.0), width=6.0, height=6.0,
                  material_id=m_emit)
    flags, emission = mats.light_flags(), mats.emission_table()
    area, light_id = extract_area_lights(
        flags[lamp.tri_material], emission[lamp.tri_material], lamp.tri_vertices(),
        np.eye(4, dtype=np.float32)[None], 5, np.array([257]))
    lamp.tri_light[:] = light_id
    meshes.append((5, lamp, None))
    instances.append((5, np.eye(4, dtype=np.float32)[None]))

    t0 = time.perf_counter()
    scene = pack_trace_scene(meshes, instances)
    pack_s = time.perf_counter() - t0

    mn, mx = scene.tlas_min[0], scene.tlas_max[0]
    center = 0.5 * (mn + mx)
    ext = float(np.linalg.norm(mx - mn))
    spot = SpotLightsView(
        position=np.array([center + [0, ext * 0.4, 0],
                           center + [ext * 0.2, ext * 0.3, ext * 0.2]], np.float32),
        direction=np.array([[0, -1, 0], [-0.4, -0.8, -0.4]], np.float32),
        energy=np.array([[80, 78, 70], [40, 40, 48]], np.float32) * ext,
        cos_inner=np.array([np.cos(np.deg2rad(25))] * 2, np.float32),
        cos_outer=np.array([np.cos(np.deg2rad(40))] * 2, np.float32),
        changed=np.ones(2, bool),
    )
    sun = DirectionalLightsView(
        direction=np.array([[0.4, -0.8, 0.3]], np.float32),
        energy=np.array([[3.0, 2.9, 2.6]], np.float32),
        changed=np.ones(1, bool),
    )
    lights = pack_lights(PointLightsView.empty(), spot, sun, area)
    camera = Camera3D(fov=55).look_at(
        center + np.array([0.55, 0.35, 0.75], np.float32) * ext * 0.62, center)
    atlas = pack_atlas([t for _, t in mats.textures])
    return scene, mats.to_device(), lights, atlas, camera, pack_s


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


def check_hits(card, label, kh, ph) -> float:
    """Hold a kernel closest-hit result against the plain one: hit masks
    agree on >= 99.99% of rays; where both hit, t to 1e-5 relative, the
    same (prim, inst) unless t ties within 1e-6, and u/v to 1e-4. Returns
    the largest |t| difference where both hit."""
    km, pm = kh.prim >= 0, ph.prim >= 0
    mask_agree = (km == pm).float().mean().item()
    both = km & pm
    t_rel = ((kh.t - ph.t).abs() / ph.t.abs().clamp(min=1e-30))[both]
    t_abs = (kh.t - ph.t).abs()[both]
    same = (kh.prim == ph.prim) & (kh.inst == ph.inst) & both
    # a different triangle is only allowed on an exact-t tie
    tie = both & ~same & ((kh.t - ph.t).abs() <= 1e-6 * ph.t.abs())
    bad_id = (both & ~same & ~tie).sum().item()
    uv_err = torch.maximum((kh.u - ph.u).abs(), (kh.v - ph.v).abs())[same]
    t_err = t_abs.max().item() if t_abs.numel() else 0.0
    log(card, f"K1 closest_hit kernel vs plain, {label}: hit-mask agreement "
              f"{mask_agree:.6f}, hits {int(both.sum())}, max t rel err "
              f"{t_rel.max().item() if t_rel.numel() else 0.0:.3e}, max t abs err {t_err:.3e}, "
              f"prim/inst differ (not a t tie) {bad_id}, t ties {int(tie.sum())}, "
              f"max u/v err {uv_err.max().item() if uv_err.numel() else 0.0:.3e}")
    assert mask_agree >= 0.9999, f"K1 ({label}): hit masks agree on only {mask_agree}"
    assert t_rel.numel() == 0 or t_rel.max().item() <= 1e-5, f"K1 ({label}): t differs by more than 1e-5"
    assert bad_id == 0, f"K1 ({label}): {bad_id} rays hit another triangle at another t"
    assert uv_err.numel() == 0 or uv_err.max().item() <= 1e-4, f"K1 ({label}): u/v differ"
    return t_err


def check_occluded(card, label, ko, po) -> float:
    """Hold a kernel occlusion result against the plain one: the flags
    agree on >= 99.99% of rays. Returns the largest flag difference."""
    occ_agree = (ko == po).float().mean().item()
    log(card, f"K2 occluded kernel vs plain, {label}: flag agreement {occ_agree:.6f}, "
              f"occluded {int(po.sum())}")
    assert occ_agree >= 0.9999, f"K2 ({label}): occlusion agrees on only {occ_agree}"
    return float((ko.int() - po.int()).abs().max().item()) if ko.numel() else 0.0


def compare_rays(card, ps, view, dev, seed):
    """K1/K2 against the plain torch walk on 65,536 rays: half subsampled
    1080p camera rays, half random directions from hit points."""
    from rfw_tpu_torch.ops import traverse as tr
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
    k1_err = check_hits(card, label, tr.closest_hit(ps, ray_o, ray_d),
                        tr.closest_hit_plain(ps, ray_o, ray_d))
    k2_err = check_occluded(card, label, tr.occluded(ps, ray_o, ray_d, t_lim),
                            tr.occluded_plain(ps, ray_o, ray_d, t_lim))

    k1_ms = cuda_ms(lambda: tr.closest_hit(ps, ray_o, ray_d), 20)
    k1_plain = cuda_ms(lambda: tr.closest_hit_plain(ps, ray_o, ray_d), 2)
    k2_ms = cuda_ms(lambda: tr.occluded(ps, ray_o, ray_d, t_lim), 20)
    k2_plain = cuda_ms(lambda: tr.occluded_plain(ps, ray_o, ray_d, t_lim), 2)
    log(card, f"K1 closest_hit at {N_CMP} rays: kernel {k1_ms:.4f} ms, plain {k1_plain:.2f} ms")
    log(card, f"K2 occluded at {N_CMP} rays: kernel {k2_ms:.4f} ms, plain {k2_plain:.2f} ms")
    return dict(K1=k1_err, K2=k2_err)


@contextmanager
def patched(module, **fns):
    """Replace module-level functions for the duration of the block."""
    old = {k: getattr(module, k) for k in fns}
    for k, f in fns.items():
        setattr(module, k, f)
    yield
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
    1080p sample; kernel time by CUDA events over 10 launches, plain time
    of the one compared call. Returns per-kernel call rows."""
    from rfw_tpu_torch.ops import traverse as tr

    rows = defaultdict(list)
    for label, kind, ps, o, d, tl in calls:
        n = o.shape[0]
        tl_t = tl if isinstance(tl, torch.Tensor) else torch.full((n,), tl, device=o.device)
        live = int((tl_t > 0).sum())
        if kind == "closest":
            ph, plain_ms = timed(lambda: tr.closest_hit_plain(ps, o, d, tl))
            err = check_hits(card, f"{label}, {n} rays", tr.closest_hit(ps, o, d, tl), ph)
            ms = cuda_ms(lambda: tr.closest_hit(ps, o, d, tl), 10)
        else:
            po, plain_ms = timed(lambda: tr.occluded_plain(ps, o, d, tl))
            err = check_occluded(card, f"{label}, {n} rays", tr.occluded(ps, o, d, tl), po)
            ms = cuda_ms(lambda: tr.occluded(ps, o, d, tl), 10)
        log(card, f"{'K1' if kind == 'closest' else 'K2'} {label}: {n} rays ({live} live), "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
        rows[kind].append(dict(call=label, rays=n, live=live, ms=ms, plain_ms=plain_ms,
                               max_abs_err=err))
    return rows


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
    _build.load_library()
    log(card, f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {built.seconds:.2f} s) "
              f"-> {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(card, "ptxas: " + line.strip())

    # ---- 2. scene
    from rfw_tpu_torch.convert import from_numpy_scene
    from rfw_tpu_torch.render.film import add_sample, new_film, tonemap
    from rfw_tpu_torch.render.wavefront import (
        RenderConfig, mat_feature_mask, render_sample, tex_kinds_mask,
    )

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
    for k in tr.LAUNCHES:
        tr.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for s in range(SPP):
        add_sample(film, sample(s + 1).radiance)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(tr.LAUNCHES)
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

    kernels = []
    for kind, name in (("closest", "K1 closest_hit"), ("occluded", "K2 occluded")):
        rows = main_rows[kind]
        kernels.append(dict(
            name=name, route="cuda", source="rfw_tpu_torch/csrc/traverse.cu",
            replaces="rfw_tpu/ops/traverse.py:335", launches=launches[kind],
            max_abs_err=max([cmp["K1" if kind == "closest" else "K2"]]
                            + [r["max_abs_err"] for r in rows]),
            ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
            calls=rows))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
