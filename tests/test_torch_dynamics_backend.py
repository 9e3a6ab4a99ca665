"""`TorchBackend`'s device dynamics route (`device_dynamics`, the default)
against its own host route and `TpuBackend`'s device route.

Ported from `tests/test_refit_device.py::TestBackendDeviceDynamics`,
`tests/test_per_instance_poses.py` (the pose-group cases),
`tests/test_skinning.py::test_posed_render_normal_aov_follows_joint` and
`tests/test_morphs.py` (the backend cases), with synthetic meshes: unit
quads (`tests/test_skinning.py::_quad_mesh`), a morph quad, and the
skinned, morphed and animated ribbon of `_torch_scene.gltf_doc` (CesiumMan
is not in the repository). A skin pose or morph-weight sync with the same
layout runs `refit_device.apply_dynamic` on the device: no repack, the
packed host scene stays as it was.

Tolerances: frames within 1 in every channel of every pixel (uint8) of
the host route's and of `TpuBackend`'s, as `tests/test_refit_device.py`
requires of its two routes; the oracle cases `tests/test_morphs.py`'s
(RMSE <= 1e-3) and `test_per_instance_poses.py`'s (within 1); the device
arenas within rtol 1e-4, atol 1e-4 of a full host repack of the same pose.
"""

import importlib
import json

import numpy as np
import pytest

import _torch_scene
from rfw_tpu.backend.contract import RenderMode
from rfw_tpu.backend.structs import InstancesView3D, SkinView
from rfw_tpu.render.tpu_backend import TpuBackend, TpuSettings
from rfw_tpu.scene.camera import Camera3D
from rfw_tpu_torch.render.cpu_reference import CpuReferenceBackend
from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
from tests.test_skinning import _quad_mesh, _rot_x

W, H = 64, 48
CAM = Camera3D(fov=60).look_at(np.array([1.5, 1.5, 4.0], np.float32),
                               np.array([1.5, 0.3, 0.0], np.float32))
DYN_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "tri_shade", "blas_min", "blas_max",
              "blas_wide_f", "blas8_box", "tlas_min", "tlas_max", "tlas_wide_f",
              "tlas8_box", "inst_aabb_min", "inst_aabb_max")


def _settings(cls, **kw):
    kw.setdefault("max_bounces", 0)
    return cls(samples_per_frame=1, pixel_center=True, **kw)


def _backends(w=W, h=H, **kw):
    """{name: backend}: the port's device and host routes and rfw_tpu's
    device route."""
    return {
        "device": TorchBackend(w, h, _settings(TorchSettings, **kw), device="cpu"),
        "host": TorchBackend(w, h, _settings(TorchSettings, device_dynamics=False, **kw),
                             device="cpu"),
        "tpu": TpuBackend(w, h, _settings(TpuSettings, **kw)),
    }


def _call(be, name, *args):
    port = not isinstance(be, TpuBackend)
    return getattr(be, name)(*(_torch_scene.to_port(args) if port else args))


def _materials(be):
    pkg = "rfw_tpu" if isinstance(be, TpuBackend) else "rfw_tpu_torch"
    mats = importlib.import_module(f"{pkg}.scene.materials").Materials()
    be.set_materials(mats.to_device(), [0])


def _render(be, cam=CAM, mode=RenderMode.NORMAL, w=W, h=H):
    return _call(be, "render", None, cam.get_view(w, h), mode)


def assert_within_one(frames):
    a = frames["device"].astype(int)
    for other in ("host", "tpu"):
        diff = np.abs(a - frames[other].astype(int))
        assert diff.max() <= 1, (other, diff.max())


def assert_device_route(be, host_before):
    """The last sync ran apply_dynamic: the refit rewrote the arenas, and
    the host pack is the one from before (no repack)."""
    assert be._dyn is not None
    assert set(DYN_FIELDS) <= be._dev_stale
    assert be._scene_host is host_before


def _skin_instance(mesh, n=1):
    mats = np.stack([np.eye(4, dtype=np.float32)] * n)
    mats[1:, 0, 3] = 2.0
    return InstancesView3D(
        matrices=mats, skin_ids=np.arange(n, dtype=np.int32), changed=np.ones(n, bool),
        local_aabb_min=mesh.aabb_min, local_aabb_max=mesh.aabb_max)


def test_skin_device_route_matches_host_route():
    mesh = _quad_mesh()
    cam = Camera3D(fov=60).look_at(np.array([0.5, 2.0, 0.6], np.float32),
                                   np.array([0.5, 0.0, -0.5], np.float32))
    frames = {}
    for name, be in _backends(32, 32).items():
        _call(be, "set_3d_meshes", [(0, mesh)])
        _call(be, "set_skins", [(0, SkinView(joint_matrices=np.eye(4, dtype=np.float32)[None]))])
        _call(be, "set_3d_instances", [(0, _skin_instance(mesh))])
        be.synchronize()
        host_before = be._scene_host
        # the second skin update: the device routes refit on the device,
        # the host route repacks
        _call(be, "set_skins", [(0, SkinView(joint_matrices=_rot_x(-90.0)[None]))])
        be.synchronize()
        if name != "host":
            assert_device_route(be, host_before)
        else:
            assert be._dyn is None and be._scene_host is not host_before
        frames[name] = _render(be, cam, w=32, h=32)
    assert_within_one(frames)
    # the pose rotated the normals: +Y, not the rest pose's +Z
    center = frames["device"][12:20, 12:20].astype(np.float32) / 255.0
    assert center[..., 1].mean() > 0.9 and center[..., 2].mean() < 0.6


def test_morph_device_route_matches_host_route():
    mesh = _quad_mesh()
    mesh.joints = None
    mesh.weights = None
    delta = np.zeros((1, 4, 3), np.float32)
    delta[0, :, 2] = [0.0, 0.0, 0.8, 0.8]  # fold the quad forward along +Z
    mesh.morph_targets = delta
    cam = Camera3D(fov=60).look_at(np.array([0.5, 0.5, 3.0], np.float32),
                                   np.array([0.5, 0.5, 0.0], np.float32))

    def inst(w):
        return InstancesView3D(
            matrices=np.eye(4, dtype=np.float32)[None], skin_ids=np.full(1, -1, np.int32),
            changed=np.array([True]), morph_weights=np.array([[w]], np.float32),
            local_aabb_min=mesh.aabb_min, local_aabb_max=mesh.aabb_max)

    frames = {}
    for name, be in _backends(32, 32).items():
        _call(be, "set_3d_meshes", [(0, mesh)])
        _call(be, "set_3d_instances", [(0, inst(0.0))])
        be.synchronize()
        host_before = be._scene_host
        _call(be, "set_3d_instances", [(0, inst(1.0))])
        be.synchronize()
        if name != "host":
            assert_device_route(be, host_before)
        frames[name] = _render(be, cam, w=32, h=32)
    assert_within_one(frames)


def test_device_arenas_match_a_host_repack():
    """After a device refit of two skinned pose groups, the device arenas
    equal a full host repack of the same poses (rtol 1e-4, atol 1e-4) on
    the fields `tests/test_refit_device.py` compares."""
    mesh = _quad_mesh(3)
    skins = [SkinView(joint_matrices=np.eye(4, dtype=np.float32)[None]) for _ in range(2)]
    backends = _backends()
    for be in backends.values():
        _materials(be)
        _call(be, "set_3d_meshes", [(0, mesh)])
        _call(be, "set_skins", list(enumerate(skins)))
        _call(be, "set_3d_instances", [(0, _skin_instance(mesh, 2))])
        be.synchronize()
        _call(be, "set_skins", [(1, SkinView(joint_matrices=_rot_x(-60.0)[None]))])
        be.synchronize()
    dev, host = backends["device"]._scene_dev, backends["host"]._scene_host
    assert backends["device"]._dev_stale
    # the BLAS side and the instance boxes; the host repack rebuilds the
    # TLAS from the posed boxes (another topology), which the refit keeps
    for f in DYN_FIELDS[:8] + ("tri_lodf", "inst_aabb_min", "inst_aabb_max"):
        a, b = getattr(dev, f).numpy(), getattr(host, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), f
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4, atol=1e-4, err_msg=f)


def test_device_dynamics_matches_host_path_for_groups():
    """A pose update on ONE of two per-instance pose groups: the device
    refit and the host repack render the same image."""
    mesh = _quad_mesh()
    rest = np.eye(4, dtype=np.float32)[None]
    frames = {}
    for name, be in _backends().items():
        _materials(be)
        _call(be, "set_3d_meshes", [(0, mesh)])
        _call(be, "set_skins", [(0, SkinView(joint_matrices=rest)),
                                (1, SkinView(joint_matrices=rest))])
        _call(be, "set_3d_instances", [(0, _skin_instance(mesh, 2))])
        be.synchronize()
        host_before = be._scene_host
        _call(be, "set_skins", [(1, SkinView(joint_matrices=_rot_x(-60.0)[None]))])
        be.synchronize()
        if name != "host":
            assert_device_route(be, host_before)
            assert len(be._dyn["plans"]) == 2  # one plan per pose group
        frames[name] = _render(be)
    assert_within_one(frames)


def test_group_split_forces_repack():
    """Morph weights diverging across instances change the grouping: a
    full repack with a second arena copy, not the device route."""
    from rfw_tpu_torch.backend.structs import InstancesView3D as PortInstances
    from rfw_tpu_torch.backend.structs import MeshView3D as PortMesh
    from rfw_tpu_torch.scene.materials import Materials

    mesh = _torch_scene.to_port(_quad_mesh())
    assert isinstance(mesh, PortMesh)
    mesh.joints = None
    mesh.weights = None
    delta = np.zeros((1, 4, 3), np.float32)
    delta[0, :, 2] = [0.0, 0.0, 1.0, 1.0]
    mesh.morph_targets = delta
    mats = np.stack([np.eye(4, dtype=np.float32)] * 2)
    mats[1, 0, 3] = 2.0

    def iv(w0, w1):
        return PortInstances(
            matrices=mats, skin_ids=np.full(2, -1, np.int32), changed=np.array([True, True]),
            morph_weights=np.array([[w0], [w1]], np.float32),
            local_aabb_min=mesh.aabb_min, local_aabb_max=mesh.aabb_max)

    def feed(be, inst):
        be.set_materials(Materials().to_device(), [0])
        be.set_3d_meshes([(0, mesh)])
        be.set_3d_instances([(0, inst)])
        be.synchronize()

    be = TorchBackend(W, H, _settings(TorchSettings), device="cpu")
    feed(be, iv(0.0, 0.0))
    assert len(be._dyn["plans"]) == 1  # identical weights -> one unit
    # the same pattern (both weights move together): the device route
    host_before = be._scene_host
    be.set_3d_instances([(0, iv(0.5, 0.5))])
    assert not be._geo_dirty and 0 in be._morph_dirty
    be.synchronize()
    assert_device_route(be, host_before)
    assert len(be._dyn["plans"]) == 1
    # diverge: the grouping splits -> repack with a second arena copy
    be.set_3d_instances([(0, iv(0.5, 1.0))])
    assert be._geo_dirty
    be.synchronize()
    assert len(be._dyn["plans"]) == 2 and not be._dev_stale
    # oracle parity after the split
    oracle = CpuReferenceBackend(W, H, _settings(TorchSettings))
    feed(oracle, iv(0.5, 1.0))
    a = _render(be).astype(int)
    b = _render(oracle).astype(int)
    assert np.abs(a - b).max() <= 1


# ---- the synthetic glTF: skins and morph weights animated together


@pytest.fixture(scope="module")
def ribbon(tmp_path_factory):
    path = tmp_path_factory.mktemp("dyn") / "ribbon.gltf"
    path.write_text(json.dumps(_torch_scene.gltf_doc(images=False)))
    return str(path)


@pytest.mark.parametrize("mode", [RenderMode.NORMAL, RenderMode.DEFAULT],
                         ids=lambda m: m.name)
def test_animated_gltf_device_route(ribbon, mode):
    """rfw_tpu's Scene loads the glTF twice (two skinned and morphed
    ribbons, each under its own skin); its sync stream at three animation
    times is replayed into every backend. After the first pack every sync
    takes the device route, and frames stay within 1 of the host route's
    and TpuBackend's."""
    from rfw_tpu.scene import Scene

    scene = Scene()
    scene.add_3d(scene.load(ribbon))
    scene.add_3d(scene.load(ribbon))
    scene.add_point_light((1.0, 3.0, 2.0), (15, 15, 14))
    scene.add_directional_light((0.3, -1, -0.4), (2.0, 1.9, 1.8))
    cam = Camera3D(fov=50).look_at(np.array([0.4, 1.2, 4.2], np.float32),
                                   np.array([0.0, 1.0, 0.0], np.float32))
    backends = _backends(48, 36, max_bounces=0 if mode == RenderMode.NORMAL else 1,
                         sky_intensity=0.3, sampler="sobol")
    rec = _torch_scene.Recorder()
    host_before, first = None, None
    for k, t in enumerate((0.1, 0.5, 0.9)):
        scene.set_animations_time(t)
        scene.synchronize(rec)
        stream = rec.take()
        frames = {}
        for name, be in backends.items():
            _torch_scene.replay(stream, be, port=name != "tpu")
            frames[name] = _render(be, cam, mode, 48, 36)
        if k == 0:
            host_before = {n: be._scene_host for n, be in backends.items()}
            first = frames["device"]
        else:
            for name in ("device", "tpu"):
                assert_device_route(backends[name], host_before[name])
        assert_within_one(frames)
    assert not np.array_equal(first, frames["device"])  # the animation moved it


# ---- tests/test_morphs.py's backend cases through the port's own Scene


def _morph_scene(pkg, target_kind="position"):
    prim = importlib.import_module(f"{pkg}.models.primitives")
    mesh3d = importlib.import_module(f"{pkg}.models.mesh3d")
    scene_mod = importlib.import_module(f"{pkg}.scene")
    q = prim.quad3d(normal=(0, 0, 1), position=(0, 0, 0), width=2, height=2)
    target = np.zeros((1, q.num_vertices, 3), np.float32)
    nrm = None
    if target_kind == "position":
        target[0, :, 2] = 1.0  # lifts every vertex +1 z
    else:  # tilts the normals only
        nrm = np.zeros_like(target)
        nrm[0, :, 0] = 1.5
    mesh = mesh3d.build_mesh3d(q.positions, q.indices, normals=q.normals, uvs=q.uvs,
                               morph_targets=target, morph_normals=nrm, name="mq")
    scene = scene_mod.Scene()
    handle = scene.add_3d_instance(scene.add_3d_object(mesh))
    return scene, handle


MORPH_CAM = Camera3D(fov=45).look_at(np.array([0, 0, 4.0], np.float32),
                                     np.zeros(3, np.float32))


@pytest.mark.parametrize("kind", ["position", "normal"])
def test_morph_weights_through_the_port_scene(kind):
    """A weight edit through the port's own Scene takes the device route;
    the frame matches rfw_tpu's device route, the port's host route
    (`sync_full`, a full repack) and the port's oracle (RMSE <= 1e-3)."""
    from tests.test_reference_backend import rmse

    frames = {}
    for name, be in _backends(32, 32).items():
        pkg = "rfw_tpu" if name == "tpu" else "rfw_tpu_torch"
        scene, handle = _morph_scene(pkg, kind)
        _torch_scene.sync_full(scene, be)
        base = _render(be, MORPH_CAM, w=32, h=32).copy()
        host_before = be._scene_host
        handle.set_morph_weights(np.array([1.0], np.float32))
        scene._instances_changed = True  # handle edits flag the list only
        scene.synchronize(be)
        if name != "host":
            assert_device_route(be, host_before)
        frames[name] = _render(be, MORPH_CAM, w=32, h=32)
        assert np.abs(frames[name].astype(float) - base).max() > 10.0  # it moved
        if name == "device":
            oracle = CpuReferenceBackend(32, 32, _settings(TorchSettings))
            _torch_scene.sync_full(scene, oracle)
            for mode in (RenderMode.NORMAL, RenderMode.GBUFFER):
                e = rmse(_render(be, MORPH_CAM, mode, 32, 32),
                         _call(oracle, "render", None, MORPH_CAM.get_view(32, 32), mode))
                assert e <= 1e-3, (mode, e)
    assert_within_one(frames)


def test_graph_morph_animation_takes_the_device_route():
    """A weights animation channel (tests/test_morphs.py::TestGraphMorphs)
    drives the instance's weights; halfway through, the device arenas sit
    halfway (+0.5 z)."""
    from rfw_tpu_torch.models import quad3d
    from rfw_tpu_torch.models.mesh3d import build_mesh3d
    from rfw_tpu_torch.scene import Scene
    from rfw_tpu_torch.scene.descriptor import (
        AnimChannelDescriptor, AnimationDescriptor, NodeDescriptor, SceneDescriptor,
    )

    q = quad3d(normal=(0, 0, 1), position=(0, 0, 0), width=2, height=2)
    target = np.zeros((1, q.num_vertices, 3), np.float32)
    target[0, :, 2] = 1.0
    mesh = build_mesh3d(q.positions, q.indices, normals=q.normals, uvs=q.uvs,
                        morph_targets=target, name="mq")
    desc = SceneDescriptor(
        name="morphanim", meshes=[mesh], nodes=[NodeDescriptor(name="n0", mesh_ids=[0])],
        roots=[0], animations=[AnimationDescriptor(name="a", channels=[
            AnimChannelDescriptor(node=0, path="weights",
                                  times=np.array([0.0, 1.0], np.float32),
                                  values=np.array([[0.0], [1.0]], np.float32))])])
    scene = Scene()
    scene.add_3d(desc)
    be = TorchBackend(32, 32, _settings(TorchSettings), device="cpu")
    scene.set_animations_time(0.0)
    _torch_scene.sync_full(scene, be)
    d0 = be._scene_host.tri_v0.copy()
    real = np.abs(d0).sum(-1) > 0
    host_before = be._scene_host
    scene.set_animations_time(0.5)
    scene.synchronize(be)
    assert_device_route(be, host_before)
    d_half = be._scene_dev.tri_v0.numpy()
    np.testing.assert_allclose((d_half[:, 2] - d0[:, 2])[real], 0.5, atol=1e-4)
