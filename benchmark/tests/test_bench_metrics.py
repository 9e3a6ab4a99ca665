"""The metric arithmetic on synthetic frames and traces: a rate over the
whole window, the 95th percentile over all frames, the idle share as the
union of spans, the per-layer readers, and the roofline's work from shapes."""

import statistics

import pytest

from benchmark import harness, roofline, stats
from benchmark.tracing import Trace, breakdown

ROOT = harness.HERE


def test_rate_is_over_the_whole_window():
    # 10 frames of 1,000 rays in 2 s: the rate counts the time between
    # frames too, not a mean of per-frame rates
    assert stats.rate(1000, 10, 2.0) == 5000.0


def test_p95_over_every_frame():
    times = list(range(1, 101))  # 1..100 ms
    assert stats.percentile(times, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10, 11, 12, 13, 14, 15]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_busy_is_the_union_of_overlapping_spans():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    assert stats.busy(spans, 0.0, 10.0) == pytest.approx(3.0 + 1.0 + 1.0)
    assert stats.gaps(spans, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]


def synthetic(frames=4, syncs=(0.002,) * 4):
    """Four 10 ms frames; per frame one traversal kernel of 1 ms, a shading
    kernel of 3 ms overlapping a copy of 1 ms, three launches and two
    blocking waits; sizes of a 100x10 frame at one bounce."""
    device, runtime, host, fr = [], [], [], []
    for i in range(frames):
        t = i * 0.010
        fr.append((t, t + 0.010))
        device += [("void traverse_kernel<false, 8>", t + 0.001, t + 0.002, "kernel"),
                   ("at::native::elementwise", t + 0.003, t + 0.006, "kernel"),
                   ("Memcpy DtoH (Device -> Pinned)", t + 0.005, t + 0.007, "memcpy")]
        runtime += [("cudaLaunchKernel", t, t + 1e-5), ("cudaLaunchKernel", t + 2e-5, t + 3e-5),
                    ("cuLaunchKernelEx", t + 4e-5, t + 5e-5),
                    ("cudaStreamSynchronize", t + 0.006, t + 0.007),
                    ("cudaMemcpyAsync", t + 0.005, t + 0.0051),
                    ("cudaDeviceSynchronize", t + 0.009, t + 0.0095)]
        host += [("aten::nonzero", t + 0.007, t + 0.0095)]
    ctx = dict(root=ROOT, kind="NVIDIA H100 80GB HBM3", width=100, height=10, bounces=1,
               samples=1, n_triangles=1000, n_instances=10)
    return Trace(frames=fr, device=device, runtime=runtime, host=host, sync_s=list(syncs),
                 ctx=ctx)


@pytest.mark.parametrize("name,want", [
    ("device_idle_pct", 100.0 * (1 - 0.005 / 0.010)),  # 1 ms + (3 ms u 2 ms) of 10 ms
    ("device_ms.trace", 1.0),
    ("device_ms.shade", 3.0),
    ("launches_per_frame", 3.0),
    ("host_syncs_per_frame", 2.0),
    ("sync_ms", 2.0),
])
def test_readers_on_a_synthetic_trace(name, want):
    read = harness.load_module(ROOT / "metrics" / f"{name}.py").read
    assert read(synthetic()) == pytest.approx(want)


def test_roofline_share_from_shapes():
    t = synthetic()
    q = 100 * 10 * 2  # closest-hit queries a frame; as many shadow queries
    bytes_frame = q * (28 + 20) + q * (28 + 4) + 1000 * 36 + 10 * 64
    assert roofline.trace_bytes(100, 10, 1, 1000, 10) == bytes_frame
    read = harness.load_module(ROOT / "metrics" / "trace_roofline_pct.py").read
    want = 100.0 * bytes_frame * 4 / 3.35e12 / 0.004
    assert read(t) == pytest.approx(want)


def test_readers_find_nothing_to_read():
    t = synthetic(syncs=())
    t.device, t.runtime = [], []
    for name in ("sync_ms", "device_idle_pct", "device_ms.trace", "device_ms.shade",
                 "trace_roofline_pct", "launches_per_frame", "host_syncs_per_frame"):
        assert harness.load_module(ROOT / "metrics" / f"{name}.py").read(t) is None, name
    t = synthetic()
    t.ctx["kind"] = "a card the peak table lacks"
    assert harness.load_module(ROOT / "metrics" / "trace_roofline_pct.py").read(t) is None


def test_breakdown_names_ops_and_the_host_in_the_gaps():
    b = breakdown(synthetic())
    assert b["device_ops"][0][0] == "at::native::elementwise"
    assert b["device_ops"][0][1] == pytest.approx(0.012)
    names = dict(b["idle_gaps"])
    # each frame's last gap (7-10 ms) joins the next frame's first (0-1 ms);
    # their middles fall inside the aten::nonzero of 7-9.5 ms
    assert names["aten::nonzero"] == pytest.approx(3 * 0.004 + 0.003)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
