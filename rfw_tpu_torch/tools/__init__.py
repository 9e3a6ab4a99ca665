"""Microbenchmarks of the port's kernels, the counterparts of the Pallas
microbenchmarks in the reference's `tools/`:

  * `ubench_leaf` (U1, `tools/ubench_leaf.py`): the cost of K1's treelet
    leaf test, stage by stage, against a chain of dependent loads;
  * `ubench_grid` (U2, `tools/ubench_grid.py`): the fixed cost of K1's
    call shape with the walk stripped out.

Each is an entry point (`python -m rfw_tpu_torch.tools.ubench_leaf`) with a
hand-written CUDA kernel in `rfw_tpu_torch/csrc/` and a plain torch version
of the same function beside it. They run on the card unless `--device cpu`
is given, and then they run the plain version and time it on the host
clock. This module holds their shared timing helpers.
"""

from __future__ import annotations

import time
from typing import Callable, List

import torch

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


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


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
