"""Traversal kernels alone, over three ray populations.

Counterpart of the reference's `tools/bench_traverse.py`: times K1
(`ops.traverse.closest_hit`) and, with `--occluded`, K2 (`occluded`) on
the bench scene for

  coherent   primary camera rays in 32 x 32 pixel blocks (the best case)
  sorted     uniform-sphere directions from the first hits, in the
             integrator's bounce order (`wavefront.sort_key` under
             `RFW_SORT_KEY`; by default direction octant, origin Morton
             code)
  unsorted   the same rays in pixel-block order (the worst case)

`--tp-occluded` adds NEE-like finite limits (the distance to a point
above the scene's centre): K2 against the two-phase any hit
(`twophase_occluded_with_fallback`: phase A, K5, K2 retrace of undecided
rays), timed, with their disagreements counted. `--stats` adds the walk's
per-ray counts (`WalkStats`: node visits, box tests, leaf visits and slot
tests, as `nodes`, `boxes`, `leaves`, `tris`; the kernel's counting
instance on the card), where the reference
counts while-iterations per Pallas program. The reference's kernel
footprint (`pallas_scene_bytes`) and VMEM budgets are TPU quantities and
have no counterpart here.

Times are device times by CUDA events, the least of `--reps` calls.

    python -m rfw_tpu_torch.tools.bench_traverse [--width 1920 --height 1080 --reps 4]
        [--occluded] [--tp-occluded] [--stats] [--cases coherent,sorted,unsorted]
        [--gltf PATH] [--device cuda|cpu]

prints one JSON line: Mrays/s (and ms) per case and call, mismatches and
counts where asked, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rfw_tpu_torch.tools import (
    bounce_rays, call_ms, card_line, device_name, device_of, primary_rays, sorted_rays,
)

CASES = ("coherent", "sorted", "unsorted")


def populations(parts, ps, width: int, height: int) -> dict:
    """{case: (o, d)} of the three ray populations on the bench scene."""
    from rfw_tpu_torch.ops.traverse import closest_hit

    scene, view = parts[0], parts[4]
    o, d, _ = primary_rays(view, width, height)
    hit = closest_hit(ps, o, d)
    o_inc, d_inc = bounce_rays(o, d, hit)
    hint = torch.where(hit.prim >= 0, hit.inst, -1)  # the "instance" key's
    return {"coherent": (o, d), "sorted": sorted_rays(o_inc, d_inc, scene, hint),
            "unsorted": (o_inc, d_inc)}


def nee_limits(scene, o: torch.Tensor) -> torch.Tensor:
    """Per ray, the distance to a point a quarter of the TLAS box above its
    centre (`bench_traverse.py:120-121`)."""
    mn, mx = scene.tlas_min[0], scene.tlas_max[0]
    lp = 0.5 * (mn + mx) + torch.tensor([0.0, 0.25, 0.0], device=o.device) * (mx - mn)
    return torch.linalg.norm(lp[None] - o, dim=1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--occluded", action="store_true", help="also time the any-hit kernel")
    ap.add_argument("--tp-occluded", action="store_true",
                    help="also time and check the two-phase any hit against K2 at "
                         "NEE-like finite limits")
    ap.add_argument("--stats", action="store_true", help="also report per-ray walk counts")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--gltf", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    wanted = args.cases.split(",")
    if set(wanted) - set(CASES) or args.reps < 1:
        ap.error(f"--cases is a list of {CASES}, --reps at least 1")

    from rfw_tpu_torch.bench import build_scene
    from rfw_tpu_torch.ops.traverse import closest_hit, occluded, prepare_scene
    from rfw_tpu_torch.ops.traverse_items import twophase_occluded_with_fallback

    dev = device_of(args.device)
    W, H = args.width, args.height
    R = W * H
    parts = build_scene(W, H, gltf=args.gltf, device=dev)
    scene = parts[0]
    ps = prepare_scene(scene)
    card = card_line(dev)
    print(f"[{card}] scene: {scene.tri_v0.shape[0]} arena triangles, {ps.n_inst} instances",
          file=sys.stderr)
    pops = populations(parts, ps, W, H)

    results = {}
    for name in (c for c in CASES if c in wanted):
        o, d = pops[name]
        calls = [("closest", lambda: closest_hit(ps, o, d))]
        if args.occluded:
            calls.append(("occluded", lambda: occluded(ps, o, d, 1e26)))
        if args.tp_occluded:
            tl_nee = nee_limits(scene, o)
            calls.append(("occl_cl_nee", lambda: occluded(ps, o, d, tl_nee)))
            calls.append(("occl_tp_nee",
                          lambda: twophase_occluded_with_fallback(ps, o, d, tl_nee)))
        for fname, fn in calls:
            ms = min(call_ms(fn, args.reps, dev))
            results[f"{name}.{fname}"] = R / ms / 1e3
            results[f"{name}.{fname}_ms"] = ms
            print(f"[{card}] {name:9s} {fname:12s} {ms:9.4f} ms {R / ms / 1e3:9.2f} Mrays/s",
                  file=sys.stderr)
        if args.tp_occluded:
            mism = int((occluded(ps, o, d, tl_nee)
                        != twophase_occluded_with_fallback(ps, o, d, tl_nee)).sum())
            results[f"{name}.occl_mismatch"] = mism
            print(f"[{card}] {name:9s} occlusion, two-phase vs K2: {mism} of {R} differ",
                  file=sys.stderr)
        if args.stats:
            _, st = closest_hit(ps, o, d, stats=True)
            for field in ("nodes", "boxes", "leaves", "tris"):
                v = getattr(st, field).double()
                results[f"{name}.{field}_mean"] = v.mean().item()
                results[f"{name}.{field}_p95"] = torch.quantile(v, 0.95).item()
                results[f"{name}.{field}_max"] = v.max().item()
            print(f"[{card}] {name:9s} per ray: node visits mean "
                  f"{results[f'{name}.nodes_mean']:.2f}, slot tests mean "
                  f"{results[f'{name}.tris_mean']:.2f}", file=sys.stderr)
    out = dict(results, width=W, height=H, rays=R, device=device_name(dev), card=card,
               clock="cuda events" if dev.type == "cuda" else "host")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
