"""The `heavy10k-skinned` cell on the CPU: its configuration at small sizes of
its own (`_tiny.PATCH` holds none for it), judged correct in a whole run,
failed by the control and by a run whose skins never pose; and its three
readers (`dynamics_ms`, `idle_ms.dynamics`, `skinned_vertices_per_frame`)
on hand-built traces and records, and in a traced run."""

import pytest

from benchmark import control

from . import _tiny
from ._skinned_small import SMALL, VERTICES
from .test_bench_program_spans import program_trace, read, records

CELL = "heavy10k-skinned"
READERS = ("dynamics_ms", "idle_ms.dynamics", "skinned_vertices_per_frame")


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setitem(_tiny.PATCH, "heavy10k_skinned", SMALL)


def test_run_is_judged_correct(small, monkeypatch):
    from rfw_tpu_torch.render import refit_device

    calls = []
    real = refit_device.apply_dynamic
    monkeypatch.setattr(refit_device, "apply_dynamic",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    result, info = _tiny.run(CELL, seconds=0.4)
    assert result["correct"], info
    assert info["judged"]["off_pct"] <= 1.0
    assert set(result["metrics"]) == {"mrays_per_s", "frame_ms_p95", "peak_mem_mib", "setup_s"}
    # every frame after the first warm-up frame (the rebuild) skins on the device
    assert len(calls) == info["frames"] + 2


def test_each_character_holds_a_share_of_the_primary_hits(small):
    from benchmark import harness

    with _tiny.tiny():
        _, _, cfg, _, gen = harness.load_cell(CELL)
    shares = gen.character_share(gen.build(_tiny.SEED, cfg), _tiny.CPU)
    assert len(shares) == 2 and min(shares) >= 0.01, shares


@pytest.mark.parametrize("form", list(control.FORMS))
def test_control_fails_the_limit(small, form):
    with _tiny.tiny():
        forms, lim = control.control(CELL, _tiny.SEED, 16, _tiny.CPU)
    assert forms[form]["off_pct"] > lim["off_pct"], forms


def test_skins_left_in_their_first_pose_make_the_run_not_correct(small, monkeypatch):
    from rfw_tpu_torch.render import refit_device

    monkeypatch.setattr(refit_device, "apply_dynamic", lambda scene, *a, **k: scene)
    result, info = _tiny.run(CELL, seconds=0.3)
    assert not result["correct"], info["judged"]


def skin_trace():
    """program_trace's frames (device gaps 0-1, 2-5 and 7-10 ms a frame)
    with a dynamics sync at 0.05-0.45 ms of each."""
    t = program_trace()
    t.host += [("rfw.sync.dynamics", a + 0.05e-3, a + 0.45e-3) for a, _ in t.frames]
    return t


def test_span_readers():
    t = skin_trace()
    assert read("dynamics_ms", t) == pytest.approx(0.4)
    assert read("idle_ms.dynamics", t) == pytest.approx(0.4)  # all of it in the 0-1 ms gap


def test_vertex_counter_takes_the_window_records(monkeypatch):
    from rfw_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_frames", records(
        {"dyn.units": 9, "dyn.vertices": 999},  # before the window
        {"dyn.units": 2, "dyn.vertices": 100}, {"dyn.units": 2, "dyn.vertices": 300}))
    assert read("skinned_vertices_per_frame", program_trace()) == pytest.approx(200.0)


def test_readers_find_nothing_to_read(monkeypatch):
    from rfw_tpu_torch.utils import trace

    t = program_trace()  # no rfw.sync.dynamics span
    for recs in (records({"lanes.shaded": 10}, {"lanes.shaded": 5}),  # no dyn.vertices
                 records({"dyn.vertices": 10})):  # fewer records than frames
        monkeypatch.setattr(trace, "_frames", recs)
        for name in READERS:
            assert read(name, t) is None, name


def test_a_traced_run_reads_the_dynamics_sync(small, monkeypatch):
    from benchmark import harness

    monkeypatch.setattr(harness, "TRACE_FRAMES", 3)  # a traced CPU frame takes seconds
    result, info = _tiny.run(CELL, trace=True)
    assert result["correct"], info
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["skinned_vertices_per_frame"] == VERTICES
    assert got["sync_host_routes_per_frame"] == 0.0
    assert 0.0 < got["idle_ms.dynamics"] <= got["dynamics_ms"] <= got["sync_ms"]
