"""TorchBackend against rfw_tpu's TpuBackend on deformed meshes, and the
backend's construction paths.

A synthetic skinned strip (two joints, weights blended along x, as
tests/test_skinning.py builds its quads) and a synthetic morphed quad (one
position + normal target, as tests/test_morphs.py builds its quad), two
instances each with their own skin or weights (so each mesh packs as two
deform groups), built through rfw_tpu's Scene; its sync stream recorded and
replayed into both backends as tests/test_torch_backend.py does. Both take
the host route (the reference with device_dynamics=False,
device_motion=False): LBS and morphs on the host, then a full repack with
a BLAS refit. Tolerances: the packed arenas (the deformed positions and the
baked shading attributes among them) and the host skinning bit-identical;
frames within 1 in every channel on at least 99% of pixels.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu.backend.contract import RenderMode
from rfw_tpu.backend.structs import SkinView
from rfw_tpu.models import quad3d
from rfw_tpu.models.mesh3d import build_mesh3d
from rfw_tpu.render.tpu_backend import TpuBackend, TpuSettings
from rfw_tpu.scene import Material, Scene
from rfw_tpu.scene.camera import Camera3D
from rfw_tpu_torch.render import torch_backend as tb
from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings

W = H = 32
SETTINGS = dict(samples_per_frame=1, max_bounces=1, sky_intensity=0.4, sampler="sobol",
                device_dynamics=False, device_motion=False)
CAM = Camera3D(fov=50).look_at(np.array([1.5, 2.5, 5.0], np.float32),
                               np.array([1.5, 0.5, 0.0], np.float32))


def _rot_z(deg):
    a = np.radians(deg)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = np.cos(a), -np.sin(a), np.sin(a), np.cos(a)
    return m


def _pose(bend):
    """Joint 0 at rest, joint 1 bent about z at x = 1.5."""
    pivot, back = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    pivot[0, 3], back[0, 3] = 1.5, -1.5
    return np.stack([np.eye(4, dtype=np.float32), pivot @ _rot_z(bend) @ back])


def _skinned_strip(n=3, material=0):
    """n unit quads along x in the XY plane, joints 0/1 blended by x."""
    pos, idx = [], []
    for q in range(n):
        pos += [(q, 0, 0), (q + 1, 0, 0), (q + 1, 1, 0), (q, 1, 0)]
        b = 4 * q
        idx += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    pos = np.asarray(pos, np.float32)
    w1 = np.clip(pos[:, 0] / n, 0, 1)
    weights = np.stack([1 - w1, w1, np.zeros_like(w1), np.zeros_like(w1)], 1)
    joints = np.tile(np.array([0, 1, 0, 0], np.int32), (len(pos), 1))
    return build_mesh3d(pos, np.asarray(idx, np.int32), material_ids=material, joints=joints,
                        weights=weights.astype(np.float32), name="strip")


def _morph_quad():
    q = quad3d(normal=(0, 0, 1), position=(0, 0, 0), width=1.2, height=1.2)
    target = np.zeros((1, q.num_vertices, 3), np.float32)
    target[0, :, 2] = 0.8
    target[0, 0, 1] = 0.5
    tn = np.zeros((1, q.num_vertices, 3), np.float32)
    tn[0, :, 0] = 0.6
    return build_mesh3d(q.positions, q.indices, normals=q.normals, uvs=q.uvs,
                        morph_targets=target, morph_normals=tn, name="mq")


def _scene():
    scene = Scene()
    red = scene.add_material(Material(color=np.array([0.8, 0.3, 0.2, 1], np.float32),
                                      roughness=0.6))
    grey = scene.add_material(Material(color=np.array([0.7, 0.7, 0.7, 1], np.float32)))
    scene.add_3d_instance(scene.add_3d_object(
        quad3d(normal=(0, 1, 0), position=(1.5, -0.5, 0), width=8, height=8, material_id=grey)))
    strip = _skinned_strip(material=red)
    sid = [scene.skins.push(SkinView(joint_matrices=_pose(b))) for b in (35.0, -20.0)]
    skinned = scene.add_3d_object(strip)
    for k, s in enumerate(sid):
        m = np.eye(4, dtype=np.float32)
        m[2, 3] = -1.2 * k
        scene.add_3d_instance(skinned, m).set_skin(s)
    morphed = scene.add_3d_object(_morph_quad())
    handles = []
    for k, w in enumerate((0.5, 1.0)):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = (0.5 + 1.6 * k, 1.6, 0.5)
        handles.append(scene.add_3d_instance(morphed, m).set_morph_weights(
            np.array([w], np.float32)))
    scene.add_point_light((1.5, 3, 3), (25, 25, 25))
    scene.add_directional_light((0.3, -0.8, -0.4), (0.8, 0.8, 0.75))
    return scene, sid, handles


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    scene, sid, handles = _scene()
    rec = _torch_scene.recorder()
    scene.synchronize(rec)
    stream = rec.take()
    ref = TpuBackend(W, H, TpuSettings(**SETTINGS))
    port = TorchBackend(W, H, TorchSettings(**SETTINGS), device="cpu")
    _torch_scene.replay(stream, ref)
    _torch_scene.replay(stream, port, port=True)
    yield scene, sid, handles, rec, ref, port
    mp.undo()


def _sync(pair):
    scene, _, _, rec, ref, port = pair
    scene.synchronize(rec)
    stream = rec.take()
    _torch_scene.replay(stream, ref)
    _torch_scene.replay(stream, port, port=True)


def assert_scene_equal(ref, port):
    for f in ref._scene_host._fields:
        x, y = np.asarray(getattr(ref._scene_host, f)), getattr(port._scene_host, f)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), f


def assert_frames_match(a, b):
    assert b.shape == a.shape == (H, W, 4) and b.dtype == np.uint8
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(axis=-1)
    assert (diff <= 1).mean() >= 0.99, (diff > 1).mean()


def _groups(port):
    """pack slots of the deformed meshes in the port's layout"""
    return sorted(ps for ps, _ in port._instance_layout()[0] if ps >= tb._PSEUDO_BASE)


def test_deformed_pack_bit_identical(pair):
    _, _, _, _, ref, port = pair
    assert len(_groups(port)) == 4  # two skins, two morph weights
    assert_scene_equal(ref, port)
    # the strip is posed: its packed corners are not the rest pose's
    rest = _skinned_strip()
    assert not np.isin(port._scene_host.tri_v0[:, 0], rest.positions[:, 0]).all()


@pytest.mark.parametrize("mode", [RenderMode.DEFAULT, RenderMode.NORMAL],
                         ids=lambda m: m.name)
def test_frames_match(pair, mode):
    ref, port = pair[4], pair[5]
    view = CAM.get_view(W, H)
    a = ref.render(None, view, mode)
    b = port.render(*_torch_scene.to_port((None, view, mode)))
    assert_frames_match(a, b)


def test_pose_update_repacks(pair):
    scene, sid, _, _, ref, port = pair
    blas = dict(port._blas_cache)
    scene.skins.overwrite(sid[0], SkinView(joint_matrices=_pose(70.0)))
    host, dev = port._scene_host, port._scene_dev
    _sync(pair)
    assert not np.array_equal(host.tri_v0, port._scene_host.tri_v0)
    assert all(port._blas_cache[k] is v for k, v in blas.items())  # refit, not rebuilt
    assert_scene_equal(ref, port)
    # the equality-gated upload: a field keeps its tensor iff its host
    # array is unchanged
    kept = {f for f in host._fields if getattr(port._scene_dev, f) is getattr(dev, f)}
    same = {f for f in host._fields
            if np.array_equal(getattr(host, f), getattr(port._scene_host, f))}
    assert kept == same and "tri_v0" not in kept and "tri_mat" in kept
    view = CAM.get_view(W, H)
    assert_frames_match(ref.render(None, view),
                        port.render(*_torch_scene.to_port((None, view))))


def test_morph_weight_update_repacks(pair):
    scene, _, handles, _, ref, port = pair
    handles[0].set_morph_weights(np.array([0.25], np.float32))
    scene._instances_changed = True  # as tests/test_backend.py flags a change
    before = port._scene_host.tri_v0.copy()
    _sync(pair)
    assert not np.array_equal(before, port._scene_host.tri_v0)
    assert_scene_equal(ref, port)
    view = CAM.get_view(W, H)
    assert_frames_match(ref.render(None, view, RenderMode.NORMAL),
                        port.render(*_torch_scene.to_port((None, view, RenderMode.NORMAL))))


def test_host_skinning_bit_identical(monkeypatch):
    """apply_skin and skin_mesh_attributes (with morphed rest attributes)
    against rfw_tpu's numpy path on random poses."""
    from rfw_tpu.render import tpu_backend as ref_tb

    monkeypatch.setenv("RFW_NO_NATIVE", "1")
    rng = np.random.default_rng(5)
    V, J = 97, 5

    class Mesh:
        positions = rng.normal(size=(V, 3)).astype(np.float32)
        normals = rng.normal(size=(V, 3)).astype(np.float32)
        tangents = np.concatenate([rng.normal(size=(V, 3)), np.ones((V, 1))], 1).astype(np.float32)
        joints = rng.integers(0, J, (V, 4)).astype(np.int32)
        weights = rng.random((V, 4)).astype(np.float32)
        weights[:5] = 0.0  # unweighted vertices keep the rest pose

    jm = np.zeros((J, 4, 4), np.float32)
    jm[:, :3, :3] = rng.normal(size=(J, 3, 3)) + np.eye(3) * 2.0
    jm[:, :3, 3] = rng.normal(size=(J, 3))
    jm[:, 3, 3] = 1.0
    over = dict(positions=Mesh.positions + 0.1, normals=Mesh.normals[::-1].copy(),
                tangents=Mesh.tangents[::-1].copy())
    for kw in ({}, over):
        for a, b in zip(ref_tb.skin_mesh_attributes(Mesh, jm, **kw),
                        tb.skin_mesh_attributes(Mesh, jm, **kw)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(ref_tb.apply_skin(Mesh, jm), tb.apply_skin(Mesh, jm))


# ---- construction: window handle, resize, settings, device


class _Window:
    """Stub window handle (`inner_size`, `scale_factor`)."""

    def inner_size(self):
        return (40, 24)

    def scale_factor(self):
        return 1.5


def test_from_window_handle_and_resize():
    ref = TpuBackend.from_window_handle(_Window(), settings=TpuSettings(**SETTINGS))
    port = TorchBackend.from_window_handle(_Window(), settings=TorchSettings(**SETTINGS),
                                           device="cpu")
    assert isinstance(port, TorchBackend) and port.device == torch.device("cpu")
    assert (port.width, port.height, port.scale) == (ref.width, ref.height, ref.scale) \
        == (60, 36, 1.5)
    port2 = TorchBackend.from_window_handle(_Window(), width=20, height=10, scale=1.0,
                                            device="cpu")
    assert (port2.width, port2.height) == (20, 10)
    assert port2.settings == TorchSettings()
    port._film, port._spp = torch.ones(1), 3
    port.resize(16, 8, 2.0)
    ref.resize(16, 8, 2.0)
    assert (port.width, port.height, port.scale) == (ref.width, ref.height, ref.scale) \
        == (32, 16, 2.0)
    assert port._film is None and port._spp == 0


def test_empty_scene_returns_zeros():
    from rfw_tpu_torch.backend.contract import RenderMode as PortMode
    from rfw_tpu_torch.scene.camera import Camera3D as PortCamera

    view = PortCamera(fov=50).look_at(np.array([0, 1, 4], np.float32),
                                      np.zeros(3, np.float32)).get_view(16, 8)
    port = TorchBackend(16, 8, TorchSettings(max_bounces=1), device="cpu")
    ref = TpuBackend(16, 8, TpuSettings(max_bounces=1, device_dynamics=False,
                                        device_motion=False))
    frame = port.render(None, view, PortMode.DEFAULT)
    assert frame.shape == (8, 16, 4) and frame.dtype == np.uint8 and not frame.any()
    assert np.array_equal(frame, ref.render(None, view))
    assert port.hdr_frame() is None
    port.synchronize()  # nothing staged: an empty pack, black frames
    frame = port.render(None, view, PortMode.DEFAULT)
    assert not frame[..., :3].any() and (frame[..., 3] == 255).all()
    assert not port.hdr_frame().any()


@pytest.mark.parametrize("name", ["device_dynamics", "device_motion"])
def test_device_dynamics_not_ported(name):
    with pytest.raises(NotImplementedError, match="queue A, item 4"):
        TorchSettings(**{name: True})


@pytest.mark.parametrize("name", ["motion_rebuild_every", "motion_min_instances"])
def test_device_motion_knobs_refused(name):
    """TpuSettings' knobs that only the device motion path reads are not
    fields until that path is ported: setting one fails loudly."""
    assert name in {f.name for f in dataclasses.fields(TpuSettings)}
    with pytest.raises(TypeError, match=name):
        TorchSettings(**{name: 1})


def test_default_device_is_the_card(monkeypatch):
    """No device named: the card, and an error where there is none (never
    a silent move to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend(8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend.from_window_handle(_Window())
