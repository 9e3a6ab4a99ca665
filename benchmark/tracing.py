"""The traced run's record: `torch.profiler` over a few frames, reduced to
plain spans that the per-layer readers (`metrics/*.py`) take apart.

The benchmark keeps its own spans around its calls into the program
(`bench.frame`, `bench.traffic`, `bench.sync`, `bench.render`, as
`record_function` annotations), and reads from the profiler only what the
card and the CUDA runtime did: every device event (kernels, copies, sets)
and every runtime call (launches, synchronizes, copies). The first traced
frame is left out of the window, so the profiler's own start-up does not
count.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

from benchmark import stats


@dataclass
class Trace:
    """Spans in seconds on the profiler's clock."""

    frames: List[Tuple[float, float]]  # each traced frame in the window
    device: List[Tuple[str, float, float, str]]  # (name, start, end, kernel|memcpy|memset)
    runtime: List[Tuple[str, float, float]]  # CUDA API calls (cuda*, cu*)
    host: List[Tuple[str, float, float]]  # every host-side event
    sync_s: List[float] = field(default_factory=list)  # host clock: each frame's synchronize()
    ctx: Dict = field(default_factory=dict)  # the cell's sizes, the card, the folder

    @property
    def window(self) -> Tuple[float, float]:
        return self.frames[0][0], self.frames[-1][1]

    def device_in_window(self, kinds=("kernel", "memcpy", "memset")):
        lo, hi = self.window
        return [d for d in self.device if d[3] in kinds and d[2] > lo and d[1] < hi]

    def runtime_in_window(self):
        lo, hi = self.window
        return [r for r in self.runtime if lo <= r[1] < hi]


def trace_kernel_words(root) -> List[str]:
    """The words of `metrics/trace_kernels.txt`: a kernel whose name holds
    one of them is a traversal kernel."""
    lines = (root / "metrics" / "trace_kernels.txt").read_text().splitlines()
    return [w.strip() for w in lines if w.strip() and not w.startswith("#")]


def kernel_seconds(t: Trace, traversal: bool) -> float:
    """Device seconds in the window of the traversal kernels (traversal=True)
    or of every other kernel."""
    words = trace_kernel_words(t.ctx["root"])
    lo, hi = t.window
    return sum(min(b, hi) - max(a, lo) for name, a, b, _ in t.device_in_window(("kernel",))
               if any(w in name for w in words) == traversal)


def device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def capture(frame: Callable[[int], None], n: int, ctx: Dict) -> Trace:
    """Profile n + 1 calls of `frame(i)` (host and device activity); the
    window is frames 1..n."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n + 1):
            frame(i)
        torch.cuda.synchronize()
    frames, device, runtime, host = [], [], [], []
    events = prof.profiler.kineto_results.events()
    base = min(e.start_ns() for e in events)  # seconds from it keep ns resolution
    for e in events:
        name = e.name()
        t0 = (e.start_ns() - base) * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        on_device = str(e.device_type()).endswith("CUDA")
        if name.startswith("bench.") or e.is_user_annotation():
            if not on_device:
                host.append((name, t0, t1))
                if name == "bench.frame":
                    frames.append((t0, t1))
            continue
        if on_device:
            device.append((name, t0, t1, device_kind(name)))
        else:
            host.append((name, t0, t1))
            if name.startswith("cuda") or name.startswith("cu"):
                runtime.append((name, t0, t1))
    frames.sort()
    return Trace(frames=frames[1:], device=device, runtime=runtime, host=host, ctx=ctx)


def breakdown(t: Trace, top: int = 10) -> Dict:
    """The device operations that took most time in the window, and the
    longest idle gaps of the device by what the host was doing then (the
    innermost host event around each gap's middle)."""
    lo, hi = t.window
    by_op: Dict[str, float] = {}
    for name, a, b, _ in t.device_in_window():
        by_op[name] = by_op.get(name, 0.0) + min(b, hi) - max(a, lo)
    idle = stats.gaps([(a, b) for _, a, b, _ in t.device_in_window()], lo, hi)
    by_host: Dict[str, float] = {}
    # sweep the gaps' middles in order, keeping the host events that have
    # begun in a heap by length: its top, once the ended ones are dropped,
    # is the innermost event around the middle
    hs = sorted((h for h in t.host if h[2] > lo and h[1] < hi and h[0] != "bench.frame"),
                key=lambda h: h[1])
    heap: List = []
    k = 0
    for a, b in idle:
        m = (a + b) / 2
        while k < len(hs) and hs[k][1] <= m:
            name, s0, s1 = hs[k]
            heapq.heappush(heap, (s1 - s0, s1, name))
            k += 1
        while heap and heap[0][1] < m:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "host: no traced event"
        by_host[name] = by_host.get(name, 0.0) + (b - a)

    def top_of(d):
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(by_op), "idle_gaps": top_of(by_host)}
