"""The benchmark's skinned configuration (`heavy10k_skinned`, traffic `skin`)
through the port on the CPU at small sizes, against the benchmark's own
plain LBS (`benchmark/skinning.py`) and its plain reference.

The scene is `benchmark/tests/test_bench_skinned.py`'s: heavy10k's tiny
field (48x32, 120 instances) and two characters of 21 x 12 vertices, each
vertex weighted over its 4 nearest joints of a 24-joint chain. The `skin`
law binds the skins at frame 0 (one full rebuild) and poses them alone at
every later frame, which the device dynamics route takes: LBS, the re-bake
of each unit's arena slices, the BLAS and TLAS refit.

Tolerances: positions, normals and tangents within 2e-5 of the plain LBS
(float32 sums of four weighted matrices in another order, coordinates up
to 6 and unit vectors: a few tens of ulps); the frame's radiance as
`benchmark/tests/test_bench_reference.py` holds it, rtol 1e-4 and atol
1e-5 on at least 99% of the paths (a path whose hit differs by rounding at
an edge may diverge).
"""

import collections
import copy

import numpy as np
import pytest
import torch

import _torch_scene
from benchmark import harness, scene, skinning
from benchmark.reference import Reference
from benchmark.tests._skinned_small import SMALL
from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings, skin_mesh_attributes
from rfw_tpu_torch.utils import trace

SEED = 20260417123
ATTR_TOL = 2e-5


def _cell():
    _, _, cfg, traffic, gen = harness.load_cell("heavy10k-skinned")
    cfg = copy.deepcopy(cfg)
    cfg.update(SMALL)
    return gen.build(SEED, cfg), traffic


@pytest.fixture(scope="module")
def driven():
    """The cell's frames 0-2 through TorchBackend on the CPU: (spec,
    traffic, backend, the sync route of each frame, each frame's radiance
    (W*H, 3)), with no profiler running, and the frame records that left."""
    spec, traffic = _cell()
    be = TorchBackend(spec.width, spec.height, TorchSettings(**spec.settings), device="cpu")
    scene.feed(spec, be)
    routes, hdr = [], []
    with pytest.MonkeyPatch.context() as mp, _torch_scene.one_torch_thread():
        mp.setattr(trace, "_frames", collections.deque(maxlen=trace.FRAMES_KEPT))
        be.synchronize()
        for name in ("_rebuild_scene", "_apply_device_dynamics"):
            real = getattr(be, name)
            mp.setattr(be, name, lambda *a, _f=real, _n=name, **k: routes[-1].append(_n)
                       or _f(*a, **k))
        for f in range(3):
            routes.append([])
            traffic.apply(be, spec, f)
            be.synchronize()
            be.render(None, scene.camera(spec))
            hdr.append(torch.from_numpy(be.hdr_frame().reshape(-1, 3)))
        recs = trace.frames()
    return spec, traffic, be, routes, hdr, recs


def test_plain_lbs_matches_the_port_host_skin():
    spec, traffic = _cell()
    assert (spec.weights > 0).all() and spec.joints.shape[1] == 4  # four slots blend
    rest = spec.meshes[spec.skin_slot]
    for k in range(2):
        jm = traffic.law.pose(spec, traffic.params, 7, k)
        want = skinning.skin(rest.positions, rest.normals, rest.tangents, spec.joints,
                             spec.weights, jm)
        got = skin_mesh_attributes(traffic.law.mesh_view(spec), jm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATTR_TOL)
        assert np.abs(want[0] - rest.positions).max() > 0.1  # the pose moves the tube


def test_syncs_take_the_device_route_after_the_first(driven):
    *_, routes, _, recs = driven
    assert routes == [["_rebuild_scene"], ["_apply_device_dynamics"],
                      ["_apply_device_dynamics"]]
    assert recs == []  # no profiler: no record


def test_device_arenas_hold_the_plain_lbs(driven):
    spec, traffic, be, *_ = driven
    rest = spec.meshes[spec.skin_slot]
    dev = be._scene_dev
    assert len(be._dyn["plans"]) == 2
    for k, plan in enumerate(be._dyn["plans"]):
        assert be._dyn["units"][k]["sid"] == k
        pos, nrm, tan = skinning.skin(rest.positions, rest.normals, rest.tangents, spec.joints,
                                      spec.weights, traffic.law.pose(spec, traffic.params, 2, k))
        rows = slice(plan.tri_lo, plan.tri_lo + plan.r0.shape[0])
        r = [x.numpy() for x in (plan.r0, plan.r1, plan.r2)]
        ok = r[0] >= 0
        shade = dev.tri_shade[rows].numpy()[ok]
        i0, i1, i2 = (x[ok] for x in r)
        checks = [(dev.tri_v0[rows].numpy()[ok], pos[i0]),
                  (dev.tri_e1[rows].numpy()[ok], pos[i1] - pos[i0]),
                  (dev.tri_e2[rows].numpy()[ok], pos[i2] - pos[i0]),
                  (shade[:, 0:3], nrm[i0]), (shade[:, 3:6], nrm[i1]), (shade[:, 6:9], nrm[i2]),
                  (shade[:, 15:19], tan[i0])]
        for got, want in checks:
            np.testing.assert_allclose(got, want, rtol=0, atol=ATTR_TOL)


@pytest.mark.parametrize("frame", [1, 2])
def test_frames_match_the_reference(driven, frame):
    spec, traffic, _, _, hdr, _ = driven
    posed = traffic.scene_at(spec, frame)
    ref = Reference(posed, "cpu")
    ref.set_instances(posed.instances)
    pid = torch.arange(spec.width * spec.height)
    with _torch_scene.one_torch_thread():
        want = ref.radiance(pid, torch.zeros_like(pid))
    close = torch.isclose(hdr[frame], want, rtol=1e-4, atol=1e-5).all(dim=1)
    assert close.float().mean() >= 0.99, close.float().mean()
    # the pose is this frame's: frame 0's pose differs on the characters
    stale = traffic.scene_at(spec, 0)
    ref = Reference(stale, "cpu")
    ref.set_instances(stale.instances)
    with _torch_scene.one_torch_thread():
        was = ref.radiance(pid, torch.zeros_like(pid))
    moved = ~torch.isclose(hdr[frame], was, rtol=1e-4, atol=1e-5).all(dim=1)
    assert moved.float().mean() > 0.01, moved.float().mean()


def test_counters_are_the_plan_counts(driven):
    """One sync with tracing on (`trace.enabled`, true while a profiler
    records, made true here: a profiler's start-up and teardown cost
    seconds on the CPU)."""
    spec, traffic, be, *_ = driven
    names = []
    span = trace.span
    with pytest.MonkeyPatch.context() as mp, _torch_scene.one_torch_thread():
        mp.setattr(trace, "_frames", collections.deque(maxlen=trace.FRAMES_KEPT))
        mp.setattr(trace, "enabled", lambda: True)
        mp.setattr(trace, "span", lambda name: names.append(name) or span(name))
        traffic.apply(be, spec, 3)
        be.synchronize()
        trace.end_frame()  # close the record, as render() does
        recs = trace.frames()
    plans = be._dyn["plans"]
    assert recs[-1]["counts"] == {"dyn.units": len(plans),
                                  "dyn.vertices": sum(p.rest_pos.shape[0] for p in plans)}
    assert recs[-1]["counts"]["dyn.vertices"] == 2 * spec.meshes[spec.skin_slot].positions.shape[0]
    assert names.count("rfw.sync.dynamics") == 1 and names.count("rfw.sync.dynamics.tlas") == 1
