"""U2: the fixed cost of K1's call shape, with the walk stripped out.

Counterpart of the reference's `tools/ubench_grid.py`, whose Pallas kernel
becomes the hand-written CUDA kernel `rfw_tpu_torch/csrc/ubench_grid.cu`
(built at first use by `ops._build`); `grid_plain` beside it computes the
same function in plain torch. A launch takes K1's operands (the prepared
scene, rays, t_limit) and writes K1's five closest-hit outputs, with the
walk replaced by:

  trivial    t = min(t_limit, 1e30), prim = inst = -1, u = v = 0
  init       trivial plus K1's prologue (each ray re-based through the
             identity instance row by K1's own `set_obj`)
  whiletriv  init plus a loop of (n_inst % 7 + 4) steps of t *= 0.9999
  fetch8     init plus 8 dependent node-row fetches

and the real K1 (`ops/traverse.py::closest_hit`) runs on the same rays.
`--tiles` tiles of 32 x 128 rays (the reference's tile at its defaults;
512 tiles are 2,097,152 rays, about the 1080p primaries) are drawn as the
reference draws them; the scene is the flagship-scale one of
`rfw_tpu_torch.scenes` (the reference tool loads pica, which is not in the
repository). Each launch is timed on the device (CUDA events, the least
of `--reps` calls) and on the host (back-to-back calls with no sync: the
checks, output allocation and ctypes call a caller pays per launch).
Several `--tiles` values sweep the launch size, so the per-launch cost
separates from the per-ray cost.

    python -m rfw_tpu_torch.tools.ubench_grid [--tiles 1 8 64 512 --reps 3 --device cuda|cpu]

prints one JSON line: per tile count and variant, microseconds per launch
and per 4,096-ray tile on each clock. Anything else goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from rfw_tpu_torch.ops.traverse import (
    PreparedScene, _rebase, _safe_inv, _t_limit, check_rays, closest_hit, node_arrays, ptr,
    stream_of,
)
from rfw_tpu_torch.render.intersect import Hit
from rfw_tpu_torch.tools import call_ms, device_name, device_of, host_us

LANE = 128
SUB = 32  # ray rows of the reference's tile at its defaults
TILE_RAYS = SUB * LANE
VARIANTS = ("trivial", "init", "whiletriv", "fetch8")
#: back-to-back calls of the host-clock measurement
HOST_CALLS = 20
SCENE_SEED = 7
INT32_MIN = -2**31

#: kernel launches; the wrapper adds one where it launches
LAUNCHES = {"grid": 0}

_F32 = torch.float32


def make_rays(tiles: int):
    """The reference tool's rays, drawn alike from seed 0: (o, d) (R, 3)
    f32 numpy with R = tiles * 4,096, ray (tile*32 + s)*128 + l taking
    o4[tile, :, s, l] of o4, d4 (tiles, 3, 32, 128) (drawn in that order)."""
    rng = np.random.default_rng(0)
    o4 = rng.normal(size=(tiles, 3, SUB, LANE)).astype(np.float32)
    d4 = rng.normal(size=(tiles, 3, SUB, LANE)).astype(np.float32)

    def rows(a):
        return np.ascontiguousarray(a.transpose(0, 2, 3, 1).reshape(-1, 3))
    return rows(o4), rows(d4)


def grid_plain(ps: PreparedScene, ray_o, ray_d, t_limit, variant: str) -> Hit:
    """Plain torch U2 (any device): K1's five outputs for each ray, each
    operation rounded as the kernel rounds it."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    R, dev = ray_o.shape[0], ray_o.device
    tl = _t_limit(t_limit, R, dev)
    t = torch.minimum(tl, torch.tensor(1e30, dtype=_F32, device=dev))
    prim = torch.full((R,), -1, dtype=torch.int32, device=dev)
    if variant != "trivial":
        ox, oy, oz, dx, dy, dz = _rebase(ps, torch.full((R,), -1, dtype=torch.int32, device=dev),
                                         ray_o, ray_d)
        acc = ox + oy + oz + dx + dy + dz + _safe_inv(dx) + _safe_inv(dy) + _safe_inv(dz)
        odd = torch.isnan(acc)
        if variant == "whiletriv":
            step = torch.tensor(0.9999, dtype=_F32, device=dev)
            for _ in range(ps.n_inst % 7 + 4):
                t = t * step
        if variant == "fetch8":
            codes = node_arrays(ps)[1]
            idx = code = 0
            for _ in range(8):
                code = int(codes[idx % codes.shape[0], 0])
                idx += 1 + code % 2
            odd = odd | (code == INT32_MIN)
        prim = torch.where(odd, -2, prim)
    return Hit(t, prim, torch.full_like(prim, -1), torch.zeros_like(t), torch.zeros_like(t))


def grid(ps: PreparedScene, ray_o, ray_d, t_limit, variant: str) -> Hit:
    """U2 over (R,3) rays: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if ps.arity != 8:  # the kernel's fetch chain reads 8-wide rows
        raise ValueError(f"U2 reads 8-wide supernodes, not {ps.arity}-wide")
    if ray_o.device.type == "cpu":
        return grid_plain(ps, ray_o, ray_d, t_limit, variant)
    from rfw_tpu_torch.ops._build import load_library

    check_rays(ps, ray_o, ray_d)
    lib = load_library("ubench_grid")
    R, dev = ray_o.shape[0], ray_o.device
    tl = _t_limit(t_limit, R, dev)
    t = torch.empty(R, dtype=_F32, device=dev)
    prim = torch.empty(R, dtype=torch.int32, device=dev)
    inst = torch.empty(R, dtype=torch.int32, device=dev)
    u = torch.empty(R, dtype=_F32, device=dev)
    v = torch.empty(R, dtype=_F32, device=dev)
    if R == 0:
        return Hit(t, prim, inst, u, v)
    with torch.cuda.device(dev):
        rc = lib.rfw_ubench_grid(
            VARIANTS.index(variant),
            ptr(ps.nodes), ps.nodes.shape[0],
            ptr(ps.tris), ps.tris.shape[0],
            ptr(ps.insts), ps.n_inst,
            ptr(ps.roots), ps.tlas_root,
            ptr(ray_o), ptr(ray_d), ptr(tl), R,
            ptr(t), ptr(prim), ptr(inst), ptr(u), ptr(v),
            stream_of(dev),
        )
    if rc != 0:
        raise RuntimeError(f"ubench_grid kernel launch failed: cudaError {rc}")
    LAUNCHES["grid"] += 1
    return Hit(t, prim, inst, u, v)


def flagship_scene(dev) -> PreparedScene:
    """The flagship-scale scene of `rfw_tpu_torch.scenes` (the seed
    `chip_smoke.py` renders), prepared on dev."""
    from rfw_tpu_torch.convert import from_numpy_scene
    from rfw_tpu_torch.ops.traverse import prepare_scene
    from rfw_tpu_torch.scenes import build_scene

    scene_np, mats, lights, atlas, _, _ = build_scene(SCENE_SEED)
    scene, *_ = from_numpy_scene(scene_np, mats, lights, atlas, dev)
    return prepare_scene(scene)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[512],
                    help="tile counts to sweep (x 4,096 rays)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if min(args.tiles) < 1 or args.reps < 1:
        ap.error("--tiles and --reps must be at least 1")
    dev = device_of(args.device)
    ps = flagship_scene(dev)

    results = {}
    for tiles in args.tiles:
        o, d = (torch.from_numpy(a).to(dev) for a in make_rays(tiles))
        tl = torch.full((o.shape[0],), 1e26, dtype=_F32, device=dev)
        calls = {v: (lambda v=v: grid(ps, o, d, tl, v)) for v in VARIANTS}
        calls["k1"] = lambda: closest_hit(ps, o, d, tl)
        row = {}
        for name, fn in calls.items():
            launch_us = min(call_ms(fn, args.reps, dev)) * 1e3
            h_us = host_us(fn, HOST_CALLS, dev)
            row[name] = dict(launch_us=launch_us, tile_us=launch_us / tiles, host_us=h_us,
                             host_tile_us=h_us / tiles)
            print(f"{tiles:5d} tiles {name:9s} {launch_us:11.3f} us/launch "
                  f"({launch_us / tiles:9.4f} us/tile), host {h_us:9.3f} us/call",
                  file=sys.stderr)
        results[str(tiles)] = row
    result = dict(device=device_name(dev),
                  clock="cuda events; host perf_counter" if dev.type == "cuda" else "host",
                  rays_per_tile=TILE_RAYS, n_inst=ps.n_inst, n_nodes=int(ps.nodes.shape[0]),
                  results=results)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
