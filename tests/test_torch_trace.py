"""The frame's spans and counters (`rfw_tpu_torch.utils.trace`) on a tiny
`TorchBackend` scene on the CPU: a still frame, then a frame whose ball
instances moved (above `motion_min_instances`, so the sync takes the device
motion route).

With no profiler the frame path enters no `record_function` and records
nothing. Under `torch.profiler.profile` the frame's spans nest as the
module's docstring lists them, each record holds the lanes that
`render_sample` read and chose, and the frames, the aten operations and the
host reads (`.item()`, `nonzero`) are the same as without it.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_scene
from rfw_tpu_torch.models import quad3d, sphere
from rfw_tpu_torch.ops import traverse_items
from rfw_tpu_torch.render import wavefront
from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
from rfw_tpu_torch.scene import Material, Scene
from rfw_tpu_torch.scene.camera import Camera3D
from rfw_tpu_torch.utils import trace

W = H = 32
N_BALLS = 6
SETTINGS = dict(samples_per_frame=1, max_bounces=1, clamp=20.0, sky_intensity=0.5,
                motion_min_instances=4)
CAM = Camera3D(fov=55).look_at(np.array([3, 2.5, 4.5], np.float32),
                               np.array([0, 0.5, 0], np.float32))
STAGES = ("rfw.render.setup", "rfw.vertex0", "rfw.bounce.1", "rfw.film")


def _scene():
    scene = Scene()
    floor = scene.add_material(Material(color=np.array([0.8, 0.8, 0.8, 1], np.float32),
                                        roughness=0.7))
    metal = scene.add_material(Material(color=np.array([0.9, 0.6, 0.3, 1], np.float32),
                                        metallic=1.0, roughness=0.3))
    emit = scene.add_material(Material(color=np.array([6, 5.5, 5, 1], np.float32)))
    scene.add_3d_instance(scene.add_3d_object(
        quad3d(normal=(0, 1, 0), position=(0, 0, 0), width=8, height=8, material_id=floor)))
    balls = scene.add_3d_object(sphere(quality=1, material_id=metal))
    handles = [scene.add_3d_instance(balls) for _ in range(N_BALLS)]
    _place(handles, 0.0)
    scene.add_3d_instance(scene.add_3d_object(
        quad3d(normal=(0, -1, 0), position=(0, 3.5, 0), width=1.5, height=1.5,
               material_id=emit)))
    scene.add_directional_light((0.4, -0.8, 0.3), (1.0, 0.95, 0.9))
    return scene, handles


def _place(handles, lift):
    for k, h in enumerate(handles):
        h.set_trs((-2.0 + 0.8 * k, 0.5 + lift * (k % 2), 0.3 * (k % 3)), (0, 0, 0, 1),
                  (0.35, 0.35, 0.35))


class _Ops(TorchDispatchMode):
    """Counts the aten operations run inside it."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "aten":
            self.n[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


def _two_frames(traced: bool):
    """A still frame, then a frame after the balls moved. Returns (frames,
    aten operation counts, the profiler or None, render_sample's prefix
    picks as (live lanes, prefix chosen))."""
    picks = []
    real = wavefront._pick_prefix

    def pick(sizes, live):
        n = real(sizes, live)
        picks.append((live, n))
        return n

    scene, handles = _scene()
    be = TorchBackend(W, H, TorchSettings(**SETTINGS), device="cpu")
    view = CAM.get_view(W, H)
    ops = _Ops()
    prof = profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext()
    with pytest.MonkeyPatch.context() as mp, _torch_scene.one_torch_thread():
        mp.setattr(wavefront, "_pick_prefix", pick)
        # compaction's ladder starts at 16,384 rays: give the tiny frame one
        mp.setattr(wavefront, "_prefix_sizes", lambda R, g, max_bounces=1: [R // 2, R])
        with prof, ops:
            scene.synchronize(be)
            f0 = be.render(None, view)
            _place(handles, 0.4)
            scene._instances_changed = True  # as tests/test_torch_backend.py flags a move
            scene.synchronize(be)
            f1 = be.render(None, view)
    return (f0, f1), ops.n, (prof if traced else None), picks


def _spans(prof):
    """The rfw.* user annotations as (name, start_ns, end_ns), by start."""
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.is_user_annotation() and e.name().startswith("rfw.")]
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in ev),
                  key=lambda s: (s[1], -s[2]))


def _parent(spans, s):
    """The innermost span strictly around s."""
    around = [p for p in spans if p is not s and p[1] <= s[1] and s[2] <= p[2]
              and (p[2] - p[1]) > (s[2] - s[1])]
    return min(around, key=lambda p: p[2] - p[1])[0] if around else None


@pytest.fixture(scope="module")
def runs():
    """The two frames untraced, the count of records they left, the two
    frames traced, and the records of those."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "_frames", collections.deque(maxlen=trace.FRAMES_KEPT))
        off = _two_frames(False)
        n_off = len(trace.frames())
        on = _two_frames(True)
        return off, n_off, on, trace.frames()


def test_off_enters_no_record_function_and_records_nothing(monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting)
    monkeypatch.setattr(trace, "_frames", collections.deque(maxlen=trace.FRAMES_KEPT))
    assert not trace.enabled()
    assert trace.span("rfw.sync") is trace.span("rfw.render")  # one shared null context
    _two_frames(False)
    assert entered == []
    assert trace.frames() == []


def test_spans_nest_as_specified(runs):
    *_, on, _ = runs
    spans = _spans(on[2])
    names = collections.Counter(s[0] for s in spans)
    for name in ("rfw.sync", "rfw.render", "rfw.render.setup", "rfw.vertex0",
                 "rfw.bounce.1"):
        assert names[name] == 2, name
    assert names["rfw.film"] == 4  # add_sample; tonemap and readback
    want = {"rfw.render.setup": ("rfw.render",), "rfw.vertex0": ("rfw.render",),
            "rfw.bounce.1": ("rfw.render",), "rfw.film": ("rfw.render",),
            "rfw.sync.motion": ("rfw.sync",), "rfw.sync.rebuild": ("rfw.sync",),
            "rfw.sync.upload": ("rfw.sync",), "rfw.wait.v0_hits": ("rfw.vertex0",),
            "rfw.wait.live_count": ("rfw.bounce.1",), "rfw.wait.readback": ("rfw.film",),
            "rfw.wait.upload": ("rfw.render.setup", "rfw.sync.motion")}
    for s in spans:
        if s[0] in want:
            assert _parent(spans, s) in want[s[0]], s[0]
    # the frame's stages do not overlap, and the renders and syncs alternate
    top = [s for s in spans if s[0] in ("rfw.sync", "rfw.render")]
    assert [s[0] for s in top] == ["rfw.sync", "rfw.render"] * 2
    stages = [s for s in spans if s[0] in STAGES]
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    # traversal spans sit inside vertex 0 or the bounce
    for s in spans:
        if s[0].startswith("rfw.trace."):
            assert any(p[0] in ("rfw.vertex0", "rfw.bounce.1") and p[1] <= s[1]
                       and s[2] <= p[2] for p in spans), s


def test_routes_and_records(runs):
    *_, on, recs = runs
    spans = _spans(on[2])
    syncs = [s for s in spans if s[0] == "rfw.sync"]
    routes = [[r[0] for r in spans if r[0] in ("rfw.sync.motion", "rfw.sync.dynamics",
                                                 "rfw.sync.repack", "rfw.sync.rebuild")
               and s[1] <= r[1] and r[2] <= s[2]] for s in syncs]
    assert routes == [["rfw.sync.rebuild"], ["rfw.sync.motion"]]
    assert len(recs) == 2
    renders = [s for s in spans if s[0] == "rfw.render"]
    for rec, r in zip(recs, renders):
        assert rec["start_ns"] <= r[1] <= rec["end_ns"] <= r[2]
    assert recs[1]["frame"] == recs[0]["frame"] + 1


def test_lane_counters_are_the_prefix_chosen(runs):
    *_, on, recs = runs
    picks = on[3]
    assert len(picks) == 4  # vertex 0 and the bounce, two frames
    for rec, frame_picks in zip(recs, (picks[:2], picks[2:])):
        assert rec["counts"]["lanes.shaded"] == sum(n for _, n in frame_picks)
        assert rec["counts"]["lanes.live"] == sum(live for live, _ in frame_picks)
        assert 0 < rec["counts"]["lanes.live"] <= rec["counts"]["lanes.shaded"] <= 2 * W * H


def test_frames_and_host_reads_equal_on_and_off(runs):
    off, n_off, on, _ = runs
    assert n_off == 0
    for a, b in zip(off[0], on[0]):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert not np.array_equal(on[0][0], on[0][1])  # the balls moved
    for op in ("_local_scalar_dense", "nonzero"):
        assert off[1][op] == on[1][op] > 0, op
    assert off[1] == on[1]  # no aten operation added or dropped


def test_fallback_counters(monkeypatch):
    """Rays the fallback could not retrace: `tp.truncated - tp.retraced`."""
    monkeypatch.setattr(trace, "_frames", collections.deque(maxlen=trace.FRAMES_KEPT))
    monkeypatch.setattr(traverse_items, "fallback_capacity", lambda R: 3)
    mask = torch.zeros(40, dtype=torch.bool)
    mask[[1, 5, 7, 20, 33]] = True
    with profile(activities=[ProfilerActivity.CPU]):
        rows = traverse_items._fallback_rows(mask)
        trace.end_frame()
    assert rows.tolist() == [1, 5, 7]
    (rec,) = trace.frames()
    assert rec["counts"] == {"tp.truncated": 5, "tp.retraced": 3}
    assert traverse_items._fallback_rows(mask).tolist() == [1, 5, 7]  # off: no count
    assert len(trace.frames()) == 1


def test_store_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "_frames", collections.deque(maxlen=trace.FRAMES_KEPT))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(trace.FRAMES_KEPT + 5):
            trace.count("lanes.live", i)
            trace.end_frame()
    got = trace.frames()
    assert len(got) == trace.FRAMES_KEPT
    assert got[-1]["counts"] == {"lanes.live": trace.FRAMES_KEPT + 4}
    assert [r["frame"] for r in got] == sorted(r["frame"] for r in got)
