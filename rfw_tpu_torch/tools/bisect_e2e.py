"""Whole samples of `render_sample` under a grid of configs, whose
differences price a block of the sample exactly.

Counterpart of the reference's `tools/bisect_e2e.py`. The configs
(`bisect_e2e.py:56-68`):

  anchor   the bench's config (1 bounce + NEE, Sobol, compaction)
  b0       max_bounces=0: vertex 0 alone; anchor - b0 is the bounce
           vertex's block (sort, bounce trace, its NEE and shading)
  uniform  sampler="random": anchor - uniform is the Sobol sampler's cost
           over threefry's (its per-slot scrambles against per-lane draws)

Each config renders sample 0 as a warm-up (the kernels build at their
first use), then `--reps` samples, each bracketed by a device
synchronize on the host clock (a sample reads its live counts back to the
host, so device events would not bound it alone); the least is kept.

    python -m rfw_tpu_torch.tools.bisect_e2e [--width 1920 --height 1080 --reps 3]
        [--configs anchor,b0,uniform] [--gltf PATH] [--device cuda|cpu]

prints one JSON line: ms per config, `delta_bounce_block`,
`delta_sobol`, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys

from rfw_tpu_torch.tools import card_line, device_name, device_of, synced_ms

CONFIGS = ("anchor", "b0", "uniform")


def configs(mats, lights) -> dict:
    """The reference tool's grid of RenderConfigs for a scene."""
    from rfw_tpu_torch.bench import bench_config

    anchor = bench_config(mats, lights)
    return {"anchor": anchor,
            "b0": dataclasses.replace(anchor, max_bounces=0),
            "uniform": dataclasses.replace(anchor, sampler="random")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--gltf", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    names = args.configs.split(",")
    if set(names) - set(CONFIGS) or args.reps < 1:
        ap.error(f"--configs is a list of {CONFIGS}, --reps at least 1")

    from rfw_tpu_torch.bench import build_scene, sample

    dev = device_of(args.device)
    W, H = args.width, args.height
    parts = build_scene(W, H, gltf=args.gltf, device=dev)
    grid = configs(parts[1], parts[3])
    card = card_line(dev)

    results = {}
    for name in names:
        index = itertools.count()  # samples 0 (the warm-up), 1, 2, ...
        ms = synced_ms(lambda: sample(parts, W, H, grid[name], next(index)), args.reps, dev)
        results[name] = min(ms)
        print(f"[{card}] {name:10s} {results[name]:9.3f} ms (least of {args.reps})",
              file=sys.stderr)
    if "anchor" in results and "b0" in results:
        results["delta_bounce_block"] = results["anchor"] - results["b0"]
    if "anchor" in results and "uniform" in results:
        results["delta_sobol"] = results["anchor"] - results["uniform"]
    out = dict(results, width=W, height=H, device=device_name(dev),
               card=card, clock="host clock, synchronized")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
