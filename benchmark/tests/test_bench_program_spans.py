"""The readers of the program's own spans and counters
(`program_spans.py` and the seven `metrics/` files that use it) on
hand-built traces and frame records, and on a tiny traced run on the CPU."""

import collections
import sys

import pytest

from benchmark import harness
from benchmark.tracing import Trace

from ._tiny import run

ROOT = harness.HERE
SPAN_READERS = ("idle_ms.vertex0", "idle_ms.bounce", "idle_ms.film", "sync_wait_ms",
                "sync_host_routes_per_frame")
COUNT_READERS = ("lane_use_pct", "fallback_rays_per_frame")


def read(name, t):
    return harness.load_module(ROOT / "metrics" / f"{name}.py").read(t)


def program_trace(frames=2, rebuild_in=(0,)):
    """10 ms frames. Device: kernels at 1-2 and 5-7 ms. Host: rfw.sync 0-0.5
    (its wait 0.2-0.5, a rebuild 0.05-0.15 in the frames `rebuild_in`),
    rfw.render 0.5-9.5 with rfw.vertex0 0.5-4, rfw.bounce.1 4-6 and
    rfw.film 6-9.5."""
    device, host, fr = [], [], []
    ms = 1e-3
    for i in range(frames):
        t = i * 10 * ms
        fr.append((t, t + 10 * ms))
        device += [("void traverse_kernel<false, 8>", t + 1 * ms, t + 2 * ms, "kernel"),
                   ("at::native::elementwise", t + 5 * ms, t + 7 * ms, "kernel")]
        host += [("bench.frame", t, t + 10 * ms), ("rfw.sync", t, t + 0.5 * ms),
                 ("rfw.sync.wait", t + 0.2 * ms, t + 0.5 * ms),
                 ("rfw.render", t + 0.5 * ms, t + 9.5 * ms),
                 ("rfw.vertex0", t + 0.5 * ms, t + 4 * ms),
                 ("rfw.bounce.1", t + 4 * ms, t + 6 * ms),
                 ("rfw.film", t + 6 * ms, t + 9.5 * ms)]
        if i in rebuild_in:
            host.append(("rfw.sync.rebuild", t + 0.05 * ms, t + 0.15 * ms))
    return Trace(frames=fr, device=device, runtime=[], host=host, ctx=dict(root=ROOT))


@pytest.mark.parametrize("name,want", [
    # gaps 0-1, 2-5, 7-10 ms a frame: vertex 0 holds 0.5-1 and 2-4
    ("idle_ms.vertex0", 2.5),
    ("idle_ms.bounce", 1.0),  # 4-5
    ("idle_ms.film", 2.5),  # 7-9.5
    ("sync_wait_ms", 0.3),
    ("sync_host_routes_per_frame", 0.5),  # one rebuild in two frames
])
def test_span_readers(name, want):
    assert read(name, program_trace()) == pytest.approx(want)


def test_idle_inside_spans_that_cross_the_window():
    t = program_trace(frames=3)
    t.frames = t.frames[1:]  # the first frame is out of the window
    assert read("idle_ms.vertex0", t) == pytest.approx(2.5)
    assert read("sync_host_routes_per_frame", t) == 0.0
    t.host.append(("rfw.bounce.2", 0.0, 0.0295))  # crosses the whole window
    # 7 ms of gaps a frame, less the 0.5 ms after the span ends
    assert read("idle_ms.bounce", t) == pytest.approx((2 * 7 - 0.5) / 2)


def records(*counts):
    from rfw_tpu_torch.utils import trace

    return collections.deque(({"frame": i, "start_ns": i, "end_ns": i + 1, "counts": c}
                              for i, c in enumerate(counts)), maxlen=trace.FRAMES_KEPT)


def test_counter_readers_take_the_window_records(monkeypatch):
    from rfw_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_frames", records(
        {"lanes.shaded": 999, "lanes.live": 1, "tp.retraced": 50},  # before the window
        {"lanes.shaded": 100, "lanes.live": 50, "tp.truncated": 4, "tp.retraced": 4},
        {"lanes.shaded": 200, "lanes.live": 150}))
    t = program_trace()
    assert read("lane_use_pct", t) == pytest.approx(100.0 * 200 / 300)
    assert read("fallback_rays_per_frame", t) == pytest.approx(2.0)


def test_readers_find_nothing_to_read(monkeypatch):
    from rfw_tpu_torch.utils import trace

    t = program_trace()
    t.host = [h for h in t.host if not h[0].startswith("rfw.")]
    for name in SPAN_READERS:
        assert read(name, t) is None, name
    # fewer records than frames, records without the counter, no module
    monkeypatch.setattr(trace, "_frames", records({"lanes.shaded": 10, "lanes.live": 5}))
    for name in COUNT_READERS:
        assert read(name, t) is None, name
    monkeypatch.setattr(trace, "_frames", records({}, {}))
    for name in COUNT_READERS:
        assert read(name, t) is None, name
    import rfw_tpu_torch.utils

    monkeypatch.delattr(rfw_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "rfw_tpu_torch.utils.trace", None)
    with pytest.raises(ImportError):
        from rfw_tpu_torch.utils import trace  # noqa: F401, F811
    for name in COUNT_READERS:
        assert read(name, t) is None, name


def test_a_traced_run_reads_the_program():
    """heavy10k-bounce at its tiny size: every sync takes the device motion
    route. On the CPU no device synchronize closes the sync, so
    sync_wait_ms finds nothing; the tiny frame is below compaction's
    smallest ladder, so no lane is counted and lane_use_pct finds nothing."""
    result, info = run("heavy10k-bounce", trace=True)
    assert result["correct"], info
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for name in SPAN_READERS + ("fallback_rays_per_frame",):
        assert (name in got) == (name != "sync_wait_ms"), name
    assert got["sync_host_routes_per_frame"] == 0.0
    assert "lane_use_pct" not in got
    idle = dict(result["breakdown"]["idle_gaps"])
    assert not {"bench.render", "bench.sync"} & set(idle)
