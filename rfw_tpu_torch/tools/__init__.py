"""Microbenchmarks of the port's kernels, the counterparts of the Pallas
microbenchmarks in the reference's `tools/`:

  * `ubench_leaf` (U1, `tools/ubench_leaf.py`): the cost of K1's treelet
    leaf test, stage by stage, against a chain of dependent loads;
  * `ubench_grid` (U2, `tools/ubench_grid.py`): the fixed cost of K1's
    call shape with the walk stripped out.

Each is an entry point (`python -m rfw_tpu_torch.tools.ubench_leaf`) with a
hand-written CUDA kernel in `rfw_tpu_torch/csrc/` and a plain torch version
of the same function beside it.

Beside them, the layer tools, the counterparts of the reference tools that
split `bench.py`'s time by layer; each builds its scene with
`rfw_tpu_torch.bench.build_scene` (the flagship-scale procedural scene, or
`--gltf PATH`):

  * `bisect_e2e`: whole samples under three configs, whose differences
    price the bounce block and the Sobol sampler;
  * `profile_e2e`: time per stage of `render_sample`'s component stages;
  * `bench_traverse`: K1 (and K2, the two-phase any hit) over coherent,
    sorted and unsorted ray populations;
  * `bench_items`: the two-phase closest hit against K1 on sorted bounce
    rays;
  * `check_traverse`: K1/K2 against a brute-force oracle (exits nonzero on
    a mismatch);
  * `diag_live`: live-lane shares after each bounce, and the material and
    atlas fetch split;
  * `profile_shading`: ms per application of each shading ingredient
    alone (the tri_shade and texel gathers, the basis, the light pick,
    Disney eval, pdf and sample, a Sobol draw, the tangent frame);
  * `ubench_atlas`: the texel gather at the real vertex-0 indices,
    shuffled and sorted, the metadata gathers, a whole bilinear fetch, the
    unpack math and the sort a texel order would need;
  * `ubench_gather`: the integrator's row gathers and `searchsorted` at
    the reference's table shapes, and (`--sweep-size`) a row gather's ns
    against table size, f32 or bf16 rows, random or sorted indices;
  * `bench_nee`: the per-pixel variance and seconds a frame of the
    potential-weighted light pick against the power CDF
    (`RFW_POTENTIAL_MAX`, in a child process per mode), on the bench
    lights or (`--sweep`) per count of grid point lights;
  * `profile_dynamics`: the animated demo's frame taken apart: the lights
    upload field by field against two blobs, a dirty skin sync with its
    execution and its route, a quiescent and a dirty-skin frame;
  * `bench_fused_stages`: the stages of the two-phase closest-hit call
    (phase A by the dense scan or K4, pack, K3/K6, merge, K1 fallback),
    each alone on one captured call, and the call with every stage
    bracketed.

All run on the card unless `--device cpu` is given, and then they run the
plain versions and time them on the host clock. This module holds their
shared helpers.
"""

from __future__ import annotations

import math
import subprocess
import time
from contextlib import contextmanager
from typing import Callable, List

import torch

#: the key of the reference layer tools' rays (`tools/bench_traverse.py:66`)
RAY_SEED = 3
#: their pixel blocks: `_block_swizzle(W, H, 1024)`, 32 x 32 pixels
BLOCK_LANES = 1024

#: cycles of the spin kernel that holds the stream while the host enqueues
#: the timed calls (about 10 ms on an H100)
SPIN_CYCLES = 20_000_000


def device_of(name: str) -> torch.device:
    """The device a tool runs on: "cuda" (the default) raises without a
    card; "cpu" runs the plain versions."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"--device is cuda or cpu, not {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the card, or pass --device cpu "
                           "for the plain torch version")
    return torch.device("cuda", torch.cuda.current_device())


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


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them; "cpu (host clock)" for
    the CPU."""
    if dev.type != "cuda":
        return "cpu (host clock)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(dev.index or 0)], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def synced_ms(fn: Callable[[], object], reps: int, dev: torch.device) -> List[float]:
    """Milliseconds of each of `reps` calls of fn() on the host clock,
    every call bracketed by a device synchronize (for work that reads
    values back to the host inside, as a render does), after one warm-up
    call."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    out = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def call_ms(fn: Callable[[], object], reps: int, dev: torch.device) -> List[float]:
    """Milliseconds of each of `reps` calls of fn(), after one warm-up call.

    On the card: device time by CUDA events around each call, with a spin
    kernel enqueued first so the stream is busy while the host enqueues the
    calls; each event pair then spans the call's device work alone, not the
    host's pace. On the CPU: the host clock around each call."""
    fn()
    if dev.type != "cuda":
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    torch.cuda.synchronize(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(SPIN_CYCLES)
    ev[0].record()
    for k in range(reps):
        fn()
        ev[k + 1].record()
    torch.cuda.synchronize(dev)
    return [ev[k].elapsed_time(ev[k + 1]) for k in range(reps)]


def host_us(fn: Callable[[], object], calls: int, dev: torch.device) -> float:
    """Host microseconds per call over `calls` back-to-back calls of fn()
    with no synchronisation between them: what a caller pays to enqueue
    one (argument checks, output allocation, the ctypes call)."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return us


def primary_rays(view: torch.Tensor, width: int, height: int, seed: int = RAY_SEED):
    """The reference layer tools' coherent primaries: `camera_rays` under
    threefry key `seed` over the pixel ids of `_block_swizzle(width,
    height, 1024)`, or in pixel order where the frame does not split into
    32 x 32 blocks. Returns (o, d) (R,3) and the pixel ids (px, py) or None."""
    from rfw_tpu_torch.render import threefry
    from rfw_tpu_torch.render.wavefront import _block_swizzle, camera_rays

    sw = _block_swizzle(width, height, BLOCK_LANES, view.device)
    pix = None if sw is None else sw[:2]
    o, d = camera_rays(view, width, height, threefry.PRNGKey(seed), pix)
    return o, d, pix


def bounce_rays(o: torch.Tensor, d: torch.Tensor, hit, seed: int = RAY_SEED):
    """The reference layer tools' bounce-like rays (`bench_traverse.py:
    69-77`): from each primary's hit point (its point at t = 1 on a miss), a
    uniform-sphere direction drawn from threefry's split of key `seed`, the
    origin 1e-3 along it. Returns (o, d) (R,3)."""
    from rfw_tpu_torch.render import threefry

    R = o.shape[0]
    pos = o + torch.where(hit.prim >= 0, hit.t, 1.0)[:, None] * d
    k1, k2 = threefry.split(threefry.PRNGKey(seed))
    z = threefry.uniform(k1, (R,), device=o.device) * 2 - 1
    phi = threefry.uniform(k2, (R,), device=o.device) * 2 * math.pi
    s = torch.sqrt(torch.clamp(1 - z * z, min=0.0))
    d_inc = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=1)
    return pos + d_inc * 1e-3, d_inc


def sorted_rays(o: torch.Tensor, d: torch.Tensor, scene, hint=None):
    """Rays in the integrator's bounce order: a stable sort by
    `wavefront.sort_key` under the key it selects (`RFW_SORT_KEY`; the
    default orders by direction octant, then origin Morton code in the
    scene's TLAS box). `hint` is each ray's previous hit instance (-1 for
    none), which the "instance" key reads. Returns (o, d)."""
    from rfw_tpu_torch.render.disney import v3_split
    from rfw_tpu_torch.render.wavefront import sort_key

    key = sort_key(v3_split(o), v3_split(d), scene.tlas_min[0], scene.tlas_max[0],
                   hint=hint)
    perm = torch.sort(key, stable=True).indices
    return o[perm].contiguous(), d[perm].contiguous()
