"""The `flagship-deep` cell on the CPU: its configuration at small sizes of
its own (`_tiny.PATCH` holds none for it), judged correct in a whole run
and failed by the control; and its three readers (`lane_use_pct.deep`,
`subfloor_rungs_per_frame`, `idle_ms.deep`) on hand-built traces and
records, and in a traced run at 128x128, the least frame at which
compaction's ladder, and with it the deep ladder, engages."""

import pytest

from benchmark import control

from . import _tiny
from .test_bench_program_spans import program_trace, read, records

CELL = "flagship-deep"
#: the flagship's tiny sizes (`_tiny.PATCH`), and a frame of 16,384 lanes
SMALL = dict(_tiny.PATCH["flagship"])
LADDER = dict(SMALL, width=128, height=128)
READERS = ("lane_use_pct.deep", "subfloor_rungs_per_frame", "idle_ms.deep")


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setitem(_tiny.PATCH, "flagship_depth3", SMALL)


def test_run_is_judged_correct(small):
    result, info = _tiny.run(CELL, seconds=0.4)
    assert result["correct"], info
    assert info["judged"]["off_pct"] <= 1.0
    # W*H*2*(3+1) rays a frame: the rate counts the configuration's depth
    assert set(result["metrics"]) == {"mrays_per_s", "frame_ms_p95", "peak_mem_mib", "setup_s"}


@pytest.mark.parametrize("form", list(control.FORMS))
def test_control_fails_the_limit(small, form):
    with _tiny.tiny():
        forms, lim = control.control(CELL, _tiny.SEED, 16, _tiny.CPU)
    assert forms[form]["off_pct"] > lim["off_pct"], forms


def deep_trace():
    """program_trace's frames with the bounce split in three: rfw.bounce.1
    4-4.5 ms, rfw.bounce.2 4.5-5.5, rfw.bounce.3 5.5-6 (device gaps 0-1,
    2-5 and 7-10 ms a frame)."""
    t = program_trace()
    host = []
    for name, a, b in t.host:
        if name == "rfw.bounce.1":
            host += [(name, a, a + 0.5e-3), ("rfw.bounce.2", a + 0.5e-3, a + 1.5e-3),
                     ("rfw.bounce.3", a + 1.5e-3, b)]
        else:
            host.append((name, a, b))
    t.host = host
    return t


def test_idle_inside_the_deep_bounce_spans():
    t = deep_trace()
    assert read("idle_ms.deep", t) == pytest.approx(0.5)  # 4.5-5 ms, rfw.bounce.2
    assert read("idle_ms.bounce", t) == pytest.approx(1.0)  # every depth, as before
    assert read("idle_ms.deep", program_trace()) is None  # one bounce: no deep span


def test_counter_readers_take_the_window_records(monkeypatch):
    from rfw_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_frames", records(
        {"lanes.shaded.deep": 999, "lanes.live.deep": 1, "ladder.subfloor": 9},  # before
        {"lanes.shaded.deep": 100, "lanes.live.deep": 30, "ladder.subfloor": 1},
        {"lanes.shaded.deep": 300, "lanes.live.deep": 170, "ladder.subfloor": 2}))
    t = program_trace()
    assert read("lane_use_pct.deep", t) == pytest.approx(100.0 * 200 / 400)
    assert read("subfloor_rungs_per_frame", t) == pytest.approx(1.5)
    # the ladder kept off: a count of 0 is read as 0
    monkeypatch.setattr(trace, "_frames", records({"ladder.subfloor": 0}, {"ladder.subfloor": 0}))
    assert read("subfloor_rungs_per_frame", t) == 0.0


def test_readers_find_nothing_to_read(monkeypatch):
    from rfw_tpu_torch.utils import trace

    t = program_trace()
    t.host = [h for h in t.host if not h[0].startswith("rfw.")]
    # records of a program without these counters; fewer records than frames
    for recs in (records({"lanes.shaded": 10, "lanes.live": 5}, {}),
                 records({"lanes.shaded.deep": 10, "lanes.live.deep": 5,
                          "ladder.subfloor": 1})):
        monkeypatch.setattr(trace, "_frames", recs)
        for name in READERS:
            assert read(name, t) is None, name


def test_a_traced_run_reads_the_deep_vertices(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(_tiny.PATCH, "flagship_depth3", LADDER)
    monkeypatch.setattr(harness, "TRACE_FRAMES", 3)  # a 128x128 frame takes a CPU second
    result, info = _tiny.run(CELL, trace=True)
    assert result["correct"], info
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for name in READERS + ("lane_use_pct", "idle_ms.bounce"):
        assert name in got, name
    assert 0.0 < got["lane_use_pct.deep"] <= 100.0
    assert got["subfloor_rungs_per_frame"] > 0.0
    assert got["idle_ms.deep"] <= got["idle_ms.bounce"]
