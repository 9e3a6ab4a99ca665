"""Equal-spp variance of next-event estimation: the potential-weighted
light pick against the global power CDF (RFW_POTENTIAL_MAX=0 turns the
potential pick off).

Counterpart of the reference's `tools/bench_nee.py`: renders `--frames`
independent 1-spp frames of the bench scene (`sampler="random"`, threefry
key 17 folded with the frame index) and reports the mean and median
per-pixel sample variance of luminance, the mean luminance and the
seconds a frame (the least over the frames after the first, the clock
stopped after a device synchronize). Two modes:

  * default: the bench scene's lights (two spots and a sun), once with
    the potential pick (RFW_POTENTIAL_MAX=16) and once with the power CDF
    (0), and their variance ratios;
  * --sweep: per light count of `--counts`, that many point lights on a
    jittered grid (and a sun) in place of the scene's lights, with the
    potential pick for every row (RFW_POTENTIAL_MAX=4096) and with the
    power CDF: variance, time and their product's ratio (below 1 where the
    potential pick still pays).

The constant is read at import, so each mode runs in a child process,
`python -m rfw_tpu_torch.tools.bench_nee --mode ...` with RFW_POTENTIAL_MAX
set; the child's line carries the constant it ran with. A child that
fails makes the parent raise with the child's stderr (the reference drops
that row).

    python -m rfw_tpu_torch.tools.bench_nee [--width 512 --height 288 --frames 8]
        [--lights N] [--sweep --counts 4,16,32,64] [--gltf PATH] [--device cuda|cpu]

prints one JSON line (per light count with --sweep, then the whole sweep).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from rfw_tpu_torch.tools import card_line, device_of

#: the reference's key (`tools/bench_nee.py:94`)
KEY_SEED = 17
#: the repository root, the child processes' working directory
ROOT = Path(__file__).resolve().parents[2]


def _grid_point_lights(scene_min, scene_max, n):
    """n point lights on a deterministic jittered grid inside the scene
    box (upper half, pulled off the walls so most are visible)."""
    rng = np.random.default_rng(1234)
    mn = np.asarray(scene_min, np.float32)
    mx = np.asarray(scene_max, np.float32)
    span = mx - mn
    u = rng.uniform(0.15, 0.85, size=(n, 3)).astype(np.float32)
    pos = mn + u * span
    pos[:, 1] = mn[1] + (0.45 + 0.45 * u[:, 1]) * span[1]
    # varied energies so the potential pick has real signal
    scale = (0.5 + 1.5 * rng.uniform(size=(n, 1))).astype(np.float32)
    ext = float(np.linalg.norm(span))
    energy = scale * np.array([[14.0, 13.5, 12.0]], np.float32) * ext
    return pos, energy


def grid_lights(scene, n: int, device):
    """The sweep's lights on `device`: n grid point lights and a sun,
    packed by `lights_pack.pack_lights` (the reference's set)."""
    from rfw_tpu_torch.backend.lights import (
        AreaLightsView, DirectionalLightsView, PointLightsView, SpotLightsView,
    )
    from rfw_tpu_torch.render.lights_pack import pack_lights, upload_lights

    pos, energy = _grid_point_lights(scene.tlas_min[0].cpu().numpy(),
                                     scene.tlas_max[0].cpu().numpy(), n)
    pts = PointLightsView(position=pos, energy=energy, changed=np.ones(n, bool))
    sun = DirectionalLightsView(
        direction=np.array([[0.4, -0.8, 0.3]], np.float32),
        energy=np.array([[3.0, 2.9, 2.6]], np.float32), changed=np.ones(1, bool))
    return upload_lights(pack_lights(pts, SpotLightsView.empty(), sun,
                                     AreaLightsView.empty()), device)


def measure(width: int, height: int, frames: int, lights: int = 0, gltf=None,
            device="cuda"):
    """(var_mean, var_median, lum_mean, sec_frame) of `frames` 1-spp
    frames, as the reference's `measure`."""
    from rfw_tpu_torch.bench import build_scene
    from rfw_tpu_torch.render import threefry
    from rfw_tpu_torch.render.wavefront import (
        RenderConfig, mat_feature_mask, render_sample, tex_kinds_mask,
    )

    dev = torch.device(device)
    scene, mats, atlas, dlights, view = build_scene(width, height, gltf=gltf, device=dev)
    if lights:
        dlights = grid_lights(scene, lights, dev)
    cfg = RenderConfig(max_bounces=1, clamp=20.0, sky_intensity=0.35,
                       sampler="random",  # independent realizations
                       tex_mask=tex_kinds_mask(mats.tex), mat_features=mat_feature_mask(mats),
                       has_area_lights=bool(int(dlights.n_area[0]) > 0))
    key = threefry.PRNGKey(KEY_SEED)
    lum, secs = [], []
    for s in range(frames):
        t0 = time.perf_counter()
        r = render_sample(scene, mats, atlas, dlights, view, width, height, cfg,
                          key=threefry.fold_in(key, s))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        rad = r.radiance
        lum.append((0.2126 * rad[:, 0] + 0.7152 * rad[:, 1]
                    + 0.0722 * rad[:, 2]).cpu().numpy())
    lum = np.stack(lum)  # (frames, R)
    var = lum.var(axis=0, ddof=1)
    # the first frame pays the kernels' first use; steady state = min of the rest
    t_frame = min(secs[1:]) if len(secs) > 1 else secs[0]
    return (float(var.mean()), float(np.median(var)), float(lum.mean()), float(t_frame))


def _fork(mode: str, pm: int, args, lights: int = 0) -> dict:
    """One mode in a child process with RFW_POTENTIAL_MAX=pm; raises with
    the child's stderr if it fails or ran with another constant."""
    env = dict(os.environ, RFW_POTENTIAL_MAX=str(pm))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])])
    cmd = [sys.executable, "-m", "rfw_tpu_torch.tools.bench_nee", "--mode", mode,
           "--width", str(args.width), "--height", str(args.height),
           "--frames", str(args.frames), "--lights", str(lights), "--device", args.device]
    if args.gltf:
        cmd += ["--gltf", str(args.gltf)]
    p = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"bench_nee child {mode} (RFW_POTENTIAL_MAX={pm}, lights={lights}) "
                           f"exited {p.returncode}:\n{p.stderr[-4000:]}")
    line = json.loads(p.stdout.strip().splitlines()[-1])
    if line.get("potential_max") != pm:
        raise RuntimeError(f"bench_nee child {mode} ran with POTENTIAL_MAX "
                           f"{line.get('potential_max')}, not {pm}")
    return line


def _ratio(a: float, b: float, floor: float) -> float:
    return round(a / max(b, floor), 4)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--lights", type=int, default=0,
                    help="replace scene lights with N grid point lights")
    ap.add_argument("--sweep", action="store_true",
                    help="potential-vs-power crossover over light counts")
    ap.add_argument("--counts", default="4,16,32,64")
    ap.add_argument("--mode", choices=["potential", "power"], default=None)
    ap.add_argument("--gltf", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    if args.mode:
        from rfw_tpu_torch.render import wavefront

        m, med, mean, t = measure(args.width, args.height, args.frames, args.lights,
                                  args.gltf, dev)
        out = {"mode": args.mode, "var_mean": m, "var_median": med, "lum_mean": mean,
               "sec_frame": round(t, 4), "potential_max": wavefront.POTENTIAL_MAX,
               "lights": args.lights, "card": card_line(dev)}
        print(json.dumps(out), flush=True)
        return out

    if args.sweep:
        rows = []
        for n in [int(x) for x in args.counts.split(",")]:
            pot = _fork("potential", 4096, args, lights=n)
            pwr = _fork("power", 0, args, lights=n)
            vr = pot["var_mean"] / max(pwr["var_mean"], 1e-12)
            tr = pot["sec_frame"] / max(pwr["sec_frame"], 1e-9)
            row = {"lights": n, "var_ratio": round(vr, 4), "time_ratio": round(tr, 4),
                   "efficiency_ratio": round(vr * tr, 4), "potential": pot, "power": pwr}
            rows.append(row)
            print(json.dumps({k: row[k] for k in
                              ("lights", "var_ratio", "time_ratio", "efficiency_ratio")}),
                  flush=True)
        out = {"sweep": rows}
        print(json.dumps(out), flush=True)
        return out

    out = {mode: _fork(mode, pm, args, lights=args.lights)
           for mode, pm in (("potential", 16), ("power", 0))}
    pot, pwr = out["potential"], out["power"]
    out["var_ratio_mean"] = _ratio(pot["var_mean"], pwr["var_mean"], 1e-12)
    out["var_ratio_median"] = _ratio(pot["var_median"], pwr["var_median"], 1e-12)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
