"""One cell of `BENCHMARK.json`, run once: set-up, the window, the judge.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name: `configs/<config>.json` and its generator
`configs/<config>.py` (`build(seed, cfg) -> SceneSpec`), `traffic/<traffic>.json`
and the law it names, `laws/<law>.py` (`traffic_gen.py`), `metrics/<metric>.py`
(`read(trace) -> float or None`) and `limits/<workload>.json`.

The entry the window drives is `rfw_tpu_torch.render.torch_backend.
TorchBackend` with the program's defaults: the configuration sets
`TorchSettings` fields, and nothing here sets an `RFW_*` variable or a
`two_phase`. One frame is the traffic law's Backend calls, then
`synchronize()`, then `render(None, view)`, which returns the tonemapped
(H, W, 4) uint8 frame on the host. The loop is closed: one viewer, each
frame starts when the last has returned. A run needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from benchmark import judge, scene, stats, tracing, traffic_gen
from benchmark.by_name import load_module

HERE = Path(__file__).resolve().parent
#: frames the traced run profiles after its first (the profiler's start-up)
TRACE_FRAMES = 12
#: top-level module names no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "rfw_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `rfw_tpu_torch` is not `rfw_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def applies(entry: Dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(workload: str, root: Path = HERE):
    """(BENCHMARK.json, the cell, its configuration's dict, its traffic
    (`traffic_gen.Traffic`), the configuration's generator)."""
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root.parent / conf["file"]).read_text())
    gen = load_module(root / "configs" / f"{cell['config']}.py")
    return bench, cell, cfg, traffic_gen.load(cell["traffic"], root), gen


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def host_speed(device) -> Dict[str, float]:
    """How fast the host runs this process now, by two fixed pieces of
    work, each the median of 5 timings: a pure-Python loop of 100,000
    steps (ms), and 2,000 launches of a one-element add on the device
    (microseconds a launch, to the device synchronize after them). The
    cells are host-bound, so these show the host's load beside a run."""
    import torch

    loop, launch = [], []
    x = torch.zeros(1, device=device)
    for _ in range(5):
        t = time.perf_counter()
        acc = 0
        for i in range(100_000):
            acc += i * i
        loop.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        for _ in range(2000):
            x.add_(1.0)
        torch.cuda.synchronize(device)
        launch.append(1e6 * (time.perf_counter() - t) / 2000)
    return dict(py_loop_ms=statistics.median(loop), launch_us=statistics.median(launch))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             root: Path = HERE) -> Tuple[Dict, Dict]:
    """Run the cell once. Returns (the result line's object, an earlier
    line's object with the set-up's parts and the run's counts)."""
    import torch
    from torch.profiler import record_function

    # python, torch and the look for a card, before this call
    parts: Dict[str, float] = {"start_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings

    parts["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    parts["cuda_init_s"] = time.perf_counter() - t

    t = time.perf_counter()
    bench, _, cfg, traffic, gen = load_cell(workload, root)
    spec = gen.build(seed % (1 << 64), cfg)
    parts["scene_s"] = time.perf_counter() - t
    t = time.perf_counter()
    be = TorchBackend(spec.width, spec.height, TorchSettings(**spec.settings), device=device)
    scene.feed(spec, be)
    parts["feed_s"] = time.perf_counter() - t
    t = time.perf_counter()
    be.synchronize()
    parts["first_sync_s"] = time.perf_counter() - t
    view = scene.camera(spec)
    pixels = judge.pick_pixels(seed, spec.width, spec.height)
    py, px = pixels // spec.width, pixels % spec.width
    shape = (spec.height, spec.width, 4)

    sync_s: List[float] = []  # host clock of each frame's synchronize()

    def frame(f: int, mark=lambda name: contextlib.nullcontext()):
        """Frame f: the traffic law's Backend calls, synchronize(), render();
        `mark` names each part in a traced run."""
        with mark("bench.frame"):
            with mark("bench.traffic"):
                law_view = traffic.apply(be, spec, f)
            with mark("bench.sync"):
                a = time.perf_counter()
                be.synchronize()
                sync_s.append(time.perf_counter() - a)
            with mark("bench.render"):
                return be.render(None, view if law_view is None else law_view)

    warmup = traffic.warmup_frames
    t = time.perf_counter()
    for f in range(warmup):
        frame(f)
    torch.cuda.synchronize(device)
    parts["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    got: List[np.ndarray] = []  # the judged pixels of every frame of the window
    window: List[int] = []
    failed = 0

    def keep(f: int, img) -> None:
        nonlocal failed
        ok = isinstance(img, np.ndarray) and img.shape == shape and img.dtype == np.uint8
        failed += not ok
        got.append(img[py, px, :3] if ok else np.zeros((len(pixels), 3), np.uint8))
        window.append(f)

    metrics: Dict[str, float] = {}
    frame_ms: List[float] = []  # quartiles of the window's frame times
    before = (time.perf_counter(), time.process_time())
    if not trace:
        times: List[float] = []
        t0 = end = time.perf_counter()
        while end - t0 < seconds:
            a = time.perf_counter()
            img = frame(warmup + len(times))
            end = time.perf_counter()
            times.append(end - a)
            keep(warmup + len(times) - 1, img)
        bounces = spec.settings.get("max_bounces", 3)
        rays = spec.width * spec.height * 2 * (bounces + 1)
        metrics = {
            "mrays_per_s": stats.rate(rays, len(times), end - t0) / 1e6,
            "frame_ms_p95": 1e3 * stats.percentile(times, 95),
            "peak_mem_mib": torch.cuda.max_memory_allocated(device) / 2**20,
            "setup_s": setup_s,
        }
        frame_ms = [1e3 * x for x in statistics.quantiles(times, n=4)] if len(times) > 1 else []
        wanted = {m["name"]: m["unit"] for m in bench["end_to_end"] if applies(m, workload)}
    else:
        ctx = dict(root=root, kind=torch.cuda.get_device_name(device),
                   width=spec.width, height=spec.height,
                   bounces=spec.settings.get("max_bounces", 3), samples=1,
                   n_triangles=sum(m.indices.shape[0] for m in spec.meshes),
                   n_instances=spec.n_instances)
        n_warm = len(sync_s)
        tr = tracing.capture(lambda i: keep(warmup + i, frame(warmup + i, record_function)),
                             TRACE_FRAMES, ctx)
        tr.sync_s = sync_s[n_warm + 1:]
        for m in bench["per_layer"]:
            if applies(m, workload):
                v = load_module(root / "metrics" / f"{m['name']}.py").read(tr)
                if v is not None:
                    metrics[m["name"]] = v
        wanted = {m["name"]: m["unit"] for m in bench["per_layer"] if applies(m, workload)}

    # this process's CPU seconds a wall second over the window
    host = dict(cpu_per_wall=(time.process_time() - before[1]) / (time.perf_counter() - before[0]),
                **host_speed(device))
    peak_bytes = int(torch.cuda.max_memory_reserved(device))
    kind = torch.cuda.get_device_name(device)
    info = dict(workload=workload, seed=seed, frames=len(window), setup_parts=parts,
                setup_s=setup_s, frame_ms_quartiles=frame_ms, host=host, card=card_line())

    # the program's state goes before the reference runs, so that the
    # reference neither sets the peak nor runs short of memory
    del be
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    frames = judge.pick_frames(seed, window)
    idx = {fr: i for i, fr in enumerate(window)}
    want = judge.expected(spec, traffic, pixels, frames, device)
    numbers = judge.compare(np.stack([got[idx[fr]] for fr in frames]), want)
    info["judge_s"] = time.perf_counter() - t
    info["judged"] = dict(frames=len(frames), pixels=len(pixels), last_frame=frames[-1],
                          **numbers)
    lim = judge.limits(workload, root)
    checks = {k: {"value": numbers[k], "limit": v} for k, v in lim.items()}
    correct = bool(window) and failed == 0 and all(c["value"] <= c["limit"]
                                                   for c in checks.values())
    result = {
        "correct": correct,
        "attempted": len(window),
        "failed": failed,
        "metrics": {k: {"value": metrics[k], "unit": u} for k, u in wanted.items()
                    if k in metrics},
        "device": {"platform": "gpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": peak_bytes},
    }
    if trace:
        lo, hi = tr.window
        result["device"].update(
            busy_s=stats.busy([(a, b) for _, a, b, _ in tr.device_in_window()], lo, hi),
            window_s=hi - lo)
        result["breakdown"] = tracing.breakdown(tr)
    result["checks"] = checks
    return result, info
