"""The port's default path depth (3 bounces, clamp 10) against the
benchmark's plain reference, and the counters of the deep bounce vertices.

The scene is the benchmark's `flagship_depth3` configuration
(`benchmark/configs/flagship_depth3.json`) built at small sizes: 128x128 =
16,384 lanes, the least at which compaction's ladder engages, so the bounce
vertices shade live prefixes, and at 3 bounces the deep ladder's two
sub-floor rungs are among them. At 2 bounces vertex 1 is a middle vertex
(BSDF sampling and continuation from a non-camera hit) and the ladder has
no sub-floor rung.

Under a torch profiler each frame record holds `lanes.shaded.deep` and
`lanes.live.deep` (the prefixes the bounce vertices at depth 2 and on chose
and the lanes alive in them) and `ladder.subfloor` (how many bounce
vertices chose a rung below the 1-bounce ladder's floor).
"""

import collections
import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_scene
from benchmark import harness, scene
from benchmark.reference import Reference
from rfw_tpu_torch.render import wavefront
from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
from rfw_tpu_torch.utils import trace

SEED = 20260417123
SMALL = dict(width=128, height=128, sphere_quality=1, instances_per_sphere=4, grid=4)


def _spec(max_bounces):
    _, _, cfg, _, gen = harness.load_cell("flagship-deep")
    cfg = copy.deepcopy(cfg)
    cfg.update(SMALL)
    cfg["settings"]["max_bounces"] = max_bounces
    return gen.build(SEED, cfg)


def _render(spec, traced=False):
    """One frame of `spec` through TorchBackend on the CPU. Returns (the
    frame's radiance (W*H, 3), render_sample's prefix picks as (ladder,
    live lanes, prefix chosen), in vertex order)."""
    picks = []
    real = wavefront._pick_prefix

    def pick(sizes, live):
        n = real(sizes, live)
        picks.append((list(sizes), live, n))
        return n

    be = TorchBackend(spec.width, spec.height, TorchSettings(**spec.settings), device="cpu")
    scene.feed(spec, be)
    prof = profile(activities=[ProfilerActivity.CPU]) if traced else None
    with pytest.MonkeyPatch.context() as mp, _torch_scene.one_torch_thread():
        mp.setattr(wavefront, "_pick_prefix", pick)
        be.synchronize()
        if prof is None:
            be.render(None, scene.camera(spec))
        else:
            with prof:
                be.render(None, scene.camera(spec))
    return torch.from_numpy(be.hdr_frame().reshape(-1, 3)), picks


@pytest.fixture(scope="module")
def untraced():
    """{max_bounces: (spec, radiance, picks)} of one frame at 2 and at 3
    bounces with no profiler running, and the frame records they left."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "_frames", collections.deque(maxlen=trace.FRAMES_KEPT))
        out = {}
        for max_bounces in (2, 3):
            spec = _spec(max_bounces)
            out[max_bounces] = (spec, *_render(spec))
        return out, trace.frames()


@pytest.mark.parametrize("max_bounces", [2, 3])
def test_the_deep_path_agrees_with_the_plain_reference(untraced, max_bounces):
    spec, prog, picks = untraced[0][max_bounces]
    assert len(picks) == max_bounces + 1  # compaction shaded a prefix at every vertex
    ref = Reference(spec, "cpu")
    ref.set_instances(spec.instances)
    pid = torch.arange(spec.width * spec.height)
    with _torch_scene.one_torch_thread():
        want = ref.radiance(pid, torch.zeros_like(pid))
    close = torch.isclose(prog, want, rtol=1e-4, atol=1e-5).all(dim=1)
    # a path whose hit differs by rounding at an edge may diverge, and at
    # depth every later vertex of it with it; no more than 1% of them (the
    # tolerance of benchmark/tests/test_bench_reference.py)
    assert close.float().mean() >= 0.99, close.float().mean()
    assert (prog.sum(1) > 0).float().mean() > 0.5  # the frame is not black


@pytest.mark.parametrize("max_bounces,deep_ladder", [(3, "1"), (3, "0"), (2, "1")])
def test_deep_counters_are_the_prefixes_chosen(monkeypatch, max_bounces, deep_ladder):
    monkeypatch.setenv("RFW_DEEP_LADDER", deep_ladder)
    monkeypatch.setattr(trace, "_frames", collections.deque(maxlen=trace.FRAMES_KEPT))
    spec = _spec(max_bounces)
    _, picks = _render(spec, traced=True)
    counts = trace.frames()[-1]["counts"]
    R = spec.width * spec.height
    g = wavefront.resolve_traversal(wavefront.RenderConfig(), R).lanes  # the backend's tiles
    v0, bounces = picks[0], picks[1:]
    assert v0[0] == wavefront._prefix_sizes(R, g) and len(v0[0]) > 1
    floor = v0[0][0]  # the 1-bounce ladder's lowest rung
    for sizes, live, n in bounces:
        assert sizes == wavefront._prefix_sizes(R, g, max_bounces)
        assert n == wavefront._pick_prefix(sizes, live)
    deep = bounces[1:]  # depth 2 and on
    assert counts["lanes.shaded.deep"] == sum(n for *_, n in deep)
    assert counts["lanes.live.deep"] == sum(live for _, live, _ in deep)
    assert 0 < counts["lanes.live.deep"] <= counts["lanes.shaded.deep"]
    # every vertex still counts in the totals, as before
    assert counts["lanes.shaded"] == sum(n for *_, n in picks)
    assert counts["lanes.live"] == sum(live for _, live, _ in picks)
    subfloor = sum(n < floor for *_, n in bounces)
    assert counts["ladder.subfloor"] == subfloor
    if max_bounces == 3 and deep_ladder == "1":
        assert subfloor > 0  # the deep ladder is exercised, not only present
    else:
        assert subfloor == 0


def test_nothing_is_recorded_without_a_profiler(untraced):
    assert not trace.enabled()
    assert untraced[1] == []
