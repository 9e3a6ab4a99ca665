"""The port's instance-motion routes against rfw_tpu's
(`tests/test_device_motion.py`, ported).

`TorchBackend._try_device_motion` with `refit_device.instance_motion_update`
keeps the TLAS topologies from the last host build and refits every mirror
on the device; a steady-state motion sync uploads one matrix array and does
no host TLAS work. Refit boxes always bound, so frames must equal the host
SAH-rebuild route's (`device_motion=False`) exactly, and `TpuBackend`'s
with the same settings (identical uint8 frames, as the reference test
requires of its own two routes). The device TLAS build of the host route
(`build_tlas8_device`, on the card from 64 instances) runs here with its
card gate forced open.

The scenes: unit quads (`tests/test_skinning.py::_quad_mesh`), 64x48
pixel-centre NORMAL frames, and a one-bounce shaded frame.
"""

import importlib

import numpy as np
import pytest

import _torch_scene
from rfw_tpu.backend.contract import RenderMode
from rfw_tpu.backend.structs import InstancesView3D
from rfw_tpu.render.tpu_backend import TpuBackend, TpuSettings
from rfw_tpu.scene.camera import Camera3D
from rfw_tpu_torch.render import torch_backend as tb
from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
from tests.test_skinning import _quad_mesh

W, H = 64, 48
CAM = Camera3D(fov=60).look_at(np.array([1.5, 1.5, 5.0], np.float32),
                               np.array([1.5, 0.3, 0.0], np.float32))


def _settings(cls, **kw):
    # motion_min_instances=0 pins the device route at tiny instance counts
    kw.setdefault("motion_min_instances", 0)
    kw.setdefault("max_bounces", 0)
    return cls(samples_per_frame=1, pixel_center=True, **kw)


def _backend(port, **kw):
    if port:
        return TorchBackend(W, H, _settings(TorchSettings, **kw), device="cpu")
    return TpuBackend(W, H, _settings(TpuSettings, **kw))


def _static_mesh():
    mesh = _quad_mesh()
    mesh.joints = None
    mesh.weights = None
    return mesh


def _instances(offsets):
    mats = np.stack([np.eye(4, dtype=np.float32) for _ in offsets])
    for i, (x, y) in enumerate(offsets):
        mats[i, 0, 3] = x
        mats[i, 1, 3] = y
    mesh = _static_mesh()
    return InstancesView3D(
        matrices=mats, skin_ids=np.full(len(offsets), -1, np.int32),
        changed=np.ones(len(offsets), bool),
        local_aabb_min=mesh.aabb_min, local_aabb_max=mesh.aabb_max)


def _call(be, name, *args):
    port = isinstance(be, TorchBackend)
    return getattr(be, name)(*(_torch_scene.to_port(args) if port else args))


def _feed(be, iv):
    pkg = "rfw_tpu_torch" if isinstance(be, TorchBackend) else "rfw_tpu"
    mats = importlib.import_module(f"{pkg}.scene.materials").Materials()
    be.set_materials(mats.to_device(), [0])
    _call(be, "set_3d_meshes", [(0, _static_mesh())])
    _call(be, "set_3d_instances", [(0, iv)])
    be.synchronize()


def _move(be, iv):
    _call(be, "set_3d_instances", [(0, iv)])
    be.synchronize()


def _render(be, mode=RenderMode.NORMAL):
    return _call(be, "render", None, CAM.get_view(W, H), mode)


def _count_repacks(monkeypatch):
    calls = {"n": 0}
    real = tb.repack_instances

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tb, "repack_instances", counted)
    return calls


def test_motion_device_route_matches_host_rebuild():
    """Moving instances through the device refit renders the same pixels
    as the host SAH rebuild, and as rfw_tpu's device route."""
    frames = {}
    for port, dm in ((True, True), (True, False), (False, True)):
        be = _backend(port, device_motion=dm)
        _feed(be, _instances([(0, 0), (2, 0), (1, 1)]))
        _render(be)
        for step in (0.4, 0.9):  # the second step reuses the armed inputs
            _move(be, _instances([(0, step), (2 - step, 0), (1, 1 + step)]))
            frames[port, dm] = _render(be)
        assert (be._motion is not None) == dm
    assert np.array_equal(frames[True, True], frames[True, False])
    assert np.array_equal(frames[True, True], frames[False, True])


def test_motion_steady_state_zero_host_repack(monkeypatch):
    """After the first pack, motion syncs never call the host repack."""
    calls = _count_repacks(monkeypatch)
    be = _backend(True, device_motion=True)
    _feed(be, _instances([(0, 0), (2, 0)]))
    for f in range(1, 5):
        _move(be, _instances([(0.1 * f, 0), (2, 0.1 * f)]))
    assert calls["n"] == 0
    assert be._motion_syncs == 4
    assert set(tb.refit_device.MOTION_FIELDS) <= be._dev_stale


def test_motion_rebuild_every_refreshes_topology(monkeypatch):
    """motion_rebuild_every=2 sends every 2nd motion sync through the host
    rebuild."""
    calls = _count_repacks(monkeypatch)
    be = _backend(True, device_motion=True, motion_rebuild_every=2)
    _feed(be, _instances([(0, 0), (2, 0)]))
    for f in range(1, 5):
        _move(be, _instances([(0.1 * f, 0), (2, 0.1 * f)]))
    assert calls["n"] == 2  # syncs 2 and 4 rebuilt on the host


def test_motion_min_instances_gates_the_device_route(monkeypatch):
    """Below motion_min_instances (the default 64) motion syncs take the
    host rebuild."""
    calls = _count_repacks(monkeypatch)
    be = TorchBackend(W, H, TorchSettings(samples_per_frame=1, max_bounces=0,
                                          pixel_center=True), device="cpu")
    assert be.settings.motion_min_instances == 64
    _feed(be, _instances([(0, 0), (2, 0)]))
    _move(be, _instances([(0.5, 0), (2, 0)]))
    assert calls["n"] == 1 and be._motion is None


def test_motion_instance_set_change_falls_back():
    """Adding an instance forces the full repack; the next motion-only
    sync re-arms the device route on the new layout."""
    be = _backend(True, device_motion=True)
    _feed(be, _instances([(0, 0), (2, 0)]))
    _move(be, _instances([(0.5, 0), (2, 0)]))
    assert be._motion is not None
    _move(be, _instances([(0, 0), (2, 0), (1, 1)]))  # count change: repack
    assert be._motion is None and not be._dev_stale
    _move(be, _instances([(0, 0.3), (2, 0), (1, 1)]))
    assert be._motion is not None

    ref = _backend(True, device_motion=False)
    _feed(ref, _instances([(0, 0.3), (2, 0), (1, 1)]))
    assert np.array_equal(_render(be), _render(ref))


def test_motion_with_shading_bounce():
    """A one-bounce shaded frame through the device route matches the host
    route and rfw_tpu's (occlusion and bounce rays over refit boxes)."""
    frames = {}
    for port, dm in ((True, True), (True, False), (False, True)):
        be = _backend(port, device_motion=dm, max_bounces=1, sampler="sobol")
        _feed(be, _instances([(0, 0), (2, 0)]))
        from rfw_tpu.scene.lights import PointLightsView

        _call(be, "set_point_lights", PointLightsView(
            position=np.array([[1.5, 2.0, 3.0]], np.float32),
            energy=np.array([[30.0, 28.0, 25.0]], np.float32),
            changed=np.ones(1, bool)))
        _move(be, _instances([(0.6, 0.2), (1.6, 0)]))
        frames[port, dm] = _render(be, RenderMode.DEFAULT)
    assert np.array_equal(frames[True, True], frames[True, False])
    assert np.array_equal(frames[True, True], frames[False, True])


@pytest.mark.parametrize("n", [64, 80])
def test_device_tlas_route(monkeypatch, n):
    """The host route's device TLAS (64+ instances; the card gate forced
    open here): the tlas8 mirror is `build_tlas8_device`'s over the real
    instance prefix, every other field the host repack's, and frames equal
    the host collapse's."""
    calls = {"n": 0}
    real = tb.build_tlas8_device

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tb, "build_tlas8_device", counted)
    rng = np.random.default_rng(n)
    start = [(float(x), float(y)) for x, y in rng.uniform(-3, 6, (n, 2))]
    moved = [(x + 0.3, y - 0.2) for x, y in start]
    frames = []
    for forced in (True, False):
        monkeypatch.setattr(tb, "_on_card", lambda device: forced)
        be = _backend(True, device_motion=False)
        _feed(be, _instances(start))
        _move(be, _instances(moved))
        frames.append(_render(be))
        dev, host = be._scene_dev, be._scene_host
        for f in host._fields:
            same = np.array_equal(getattr(dev, f).numpy(), getattr(host, f))
            assert same == (not forced or f not in ("tlas8_box", "tlas8_code", "tlas8_cnt")), f
    assert calls["n"] == 1
    assert np.array_equal(frames[0], frames[1])
