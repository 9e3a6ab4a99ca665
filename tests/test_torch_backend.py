"""The port's TorchBackend against rfw_tpu's TpuBackend, fed the same sync
stream: a small scene built through rfw_tpu's Scene on the CPU (textured
floor, two icosphere meshes, an emissive quad, point and directional
lights, a skybox and a textured 2D quad), its synchronize recorded with
`_torch_scene.Recorder` and replayed into both backends (each view
rebuilt as the port's class from its fields, `tests/_torch_scene.py`).

Both run sampler="sobol" with host dynamics (the reference with
device_dynamics=False, device_motion=False) at 32x32, 1 bounce; the port
on the CPU (its kernels' plain versions), the reference's traversal "auto"
(its packet tier on the CPU). Tolerances: frames (every render mode, FXAA,
the 2D overlay) within 1 in every channel on at least 99% of pixels; the
HDR frame within 1e-3 abs + 1e-3 rel on at least 99% of pixels and its
mean within 1e-3 relative (those of tests/test_torch_wavefront.py); the
packed host arenas, the atlas and the instance-motion repack bit-identical.
"""

import numpy as np
import pytest

import _torch_scene
from rfw_tpu.backend.contract import RenderMode
from rfw_tpu.models import quad2d, quad3d, sphere
from rfw_tpu.render.tpu_backend import TpuBackend, TpuSettings
from rfw_tpu.scene import Material, Scene
from rfw_tpu.scene.camera import Camera2D, Camera3D
from rfw_tpu.scene.materials import Texture
from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings

W = H = 32
SETTINGS = dict(samples_per_frame=1, max_bounces=1, clamp=20.0, sky_intensity=0.5,
                sampler="sobol", device_dynamics=False, device_motion=False)


def _scene():
    scene = Scene()
    checker = ((np.indices((64, 64)).sum(0) // 8) % 2 * 180 + 50).astype(np.uint8)
    floor_m = scene.add_material(Material(
        color=np.array([0.8, 0.8, 0.8, 1], np.float32), roughness=0.7,
        diffuse_tex=scene.add_texture(Texture.from_array(checker))))
    metal = scene.add_material(Material(color=np.array([0.9, 0.6, 0.3, 1], np.float32),
                                        metallic=1.0, roughness=0.3))
    plastic = scene.add_material(Material(color=np.array([0.2, 0.3, 0.8, 1], np.float32),
                                          roughness=0.5, clearcoat=1.0))
    emit = scene.add_material(Material(color=np.array([6, 5.5, 5, 1], np.float32)))
    scene.add_3d_instance(scene.add_3d_object(
        quad3d(normal=(0, 1, 0), position=(0, 0, 0), width=8, height=8, material_id=floor_m)))
    balls = scene.add_3d_object(sphere(quality=1, material_id=metal))
    handles = [scene.add_3d_instance(balls) for _ in range(3)]
    for k, h in enumerate(handles):
        h.set_trs((-1.5 + 1.5 * k, 0.6, 0.0), (0, 0, 0, 1), (0.6, 0.6, 0.6))
    scene.add_3d_instance(scene.add_3d_object(sphere(quality=2, material_id=plastic))) \
        .set_trs((0.5, 0.5, 1.5), (0, 0, 0, 1), (0.5, 0.5, 0.5))
    scene.add_3d_instance(scene.add_3d_object(
        quad3d(normal=(0, -1, 0), position=(0, 3.5, 0), width=1.5, height=1.5,
               material_id=emit)))
    scene.add_point_light((2, 3, 2), (20, 20, 20))
    scene.add_directional_light((0.4, -0.8, 0.3), (1.0, 0.95, 0.9))
    sky = np.zeros((32, 64, 4), np.uint8)
    sky[..., 0] = np.linspace(40, 220, 64)[None, :]
    sky[..., 1] = np.linspace(80, 160, 32)[:, None]
    sky[..., 2], sky[..., 3] = 230, 255
    scene.set_skybox(Texture.from_array(sky))
    # the 2D overlay: a textured quad and a translucent vertex-coloured one
    c = np.indices((16, 16)).sum(axis=0) % 2
    tex = np.stack([c * 255, 255 - c * 200, np.full_like(c, 90), np.full_like(c, 255)],
                   axis=-1).astype(np.uint8)
    scene.add_2d_instance(scene.add_2d_object(
        quad2d(center=(10, 10), size=(12, 9), texture_id=scene.add_texture(
            Texture.from_array(tex)))))
    scene.add_2d_instance(scene.add_2d_object(
        quad2d(center=(22, 20), size=(10, 7), color=(1.0, 0.4, 0.2, 0.7))))
    return scene, handles


CAM = Camera3D(fov=55).look_at(np.array([3, 2.5, 4.5], np.float32),
                               np.array([0, 0.5, 0], np.float32))
CAM2 = Camera3D(fov=55).look_at(np.array([-3, 2.5, 4.5], np.float32),
                                np.array([0, 0.5, 0], np.float32))


@pytest.fixture(scope="module")
def pair():
    """(scene, instance handles, recorder, rfw_tpu backend, port backend),
    both fed the scene's first sync stream (rfw_tpu with RFW_NO_NATIVE=1,
    its numpy builders, which the port copies)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    scene, handles = _scene()
    rec = _torch_scene.Recorder()
    scene.synchronize(rec)
    stream = rec.take()
    ref = TpuBackend(W, H, TpuSettings(**SETTINGS))
    port = TorchBackend(W, H, TorchSettings(**SETTINGS), device="cpu")
    _torch_scene.replay(stream, ref)
    _torch_scene.replay(stream, port, port=True)
    yield scene, handles, rec, ref, port
    mp.undo()


def assert_frames_match(a, b):
    assert b.shape == a.shape == (H, W, 4) and b.dtype == a.dtype == np.uint8
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(axis=-1)
    assert (diff <= 1).mean() >= 0.99, (diff > 1).mean()


def assert_hdr_matches(a, b):
    assert b.shape == a.shape == (H, W, 3) and np.isfinite(b).all()
    ok = (np.abs(b - a) <= 1e-3 + 1e-3 * np.abs(a)).all(axis=-1)
    assert ok.mean() >= 0.99
    assert a.mean() > 0 and abs(b.mean() - a.mean()) <= 1e-3 * a.mean()


def _bits(x):
    """Host array of a field; uint32 (the texel pool) as its int32 bits, as
    the port's atlas holds it."""
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def assert_tuple_equal(a, b, names=None):
    for f in names or a._fields:
        x, y = _bits(getattr(a, f)), _bits(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), f


def both(pair, view, mode=RenderMode.DEFAULT, view_2d=None):
    """The same frame from both backends (the port given its own views and
    RenderMode member)."""
    _, _, _, ref, port = pair
    return (ref.render(view_2d, view, mode),
            port.render(*_torch_scene.to_port((view_2d, view, mode))))


def test_sync_packs_the_same_arenas(pair):
    _, _, _, ref, port = pair
    assert port.device.type == "cpu"
    assert_tuple_equal(ref._scene_host, port._scene_host)
    assert_tuple_equal(ref._atlas_dev, port._atlas_dev,
                       [f for f in ref._atlas_dev._fields if getattr(ref._atlas_dev, f) is not None])
    assert port._sky_tex_id == ref._sky_tex_id >= 0


@pytest.mark.parametrize("mode", list(RenderMode), ids=lambda m: m.name)
def test_frame_matches(pair, mode):
    a, b = both(pair, CAM.get_view(W, H), mode)
    assert_frames_match(a, b)
    assert b[..., :3].astype(np.float32).std() > 2  # not a flat frame
    assert pair[4]._spp == pair[3]._spp


def test_hdr_frame_matches(pair):
    _, _, _, ref, port = pair
    both(pair, CAM.get_view(W, H), RenderMode.RESET)
    assert_hdr_matches(ref.hdr_frame(), port.hdr_frame())


def test_skybox_shows_on_miss(pair):
    """The sky gradient (atlas texture, `set_skybox`) fills the top rows."""
    a, b = both(pair, CAM.get_view(W, H), RenderMode.ALBEDO)
    assert_frames_match(a, b)
    a, b = both(pair, CAM.get_view(W, H), RenderMode.RESET)
    top = b[:3, :, :3].astype(np.float32)
    assert top[..., 2].mean() > top[..., 0].mean()  # the blue sky, not grey


def test_fxaa_frame_matches(pair):
    _, _, _, ref, port = pair
    plain = port.render(*_torch_scene.to_port((None, CAM.get_view(W, H), RenderMode.RESET)))
    ref.settings.fxaa = port.settings.fxaa = True
    try:
        a, b = both(pair, CAM.get_view(W, H), RenderMode.RESET)
    finally:
        ref.settings.fxaa = port.settings.fxaa = False
    assert_frames_match(a, b)
    assert not np.array_equal(plain, b)


def test_progressive_accumulation_and_reset(pair):
    _, _, _, ref, port = pair
    view = CAM.get_view(W, H)
    both(pair, view, RenderMode.RESET)
    spp = []
    for v, mode in ((view, RenderMode.DEFAULT), (view, RenderMode.DEFAULT),
                    (CAM2.get_view(W, H), RenderMode.DEFAULT),
                    (CAM2.get_view(W, H), RenderMode.DEFAULT),
                    (CAM2.get_view(W, H), RenderMode.RESET)):
        a, b = both(pair, v, mode)
        assert_frames_match(a, b)
        assert port._spp == ref._spp and port.stats["spp_total"] == port._spp
        spp.append(port._spp)
    assert spp == [2, 3, 1, 2, 1]
    assert_hdr_matches(ref.hdr_frame(), port.hdr_frame())
    for k in ("sync_ms", "render_ms", "mrays_per_s"):
        assert port.stats[k].last() > 0


def test_instance_motion(pair):
    """Moving instances takes the instance-only sync (repack_instances and
    the host TLAS collapse): the geometry arenas keep their device tensors,
    the repacked fields equal rfw_tpu's bit for bit, and the frames match."""
    scene, handles, rec, ref, port = pair
    geo_before = port._scene_dev.tri_v0
    inst_before = port._scene_host.inst_matrix.copy()
    handles[0].set_trs((-1.2, 1.4, 0.4), (0, 0.3826834, 0, 0.9238795), (0.7, 0.7, 0.7))
    handles[2].set_trs((1.8, 0.5, -0.6), (0, 0, 0, 1), (0.5, 0.5, 0.5))
    scene._instances_changed = True  # as tests/test_backend.py flags a move
    scene.synchronize(rec)
    stream = rec.take()
    names = [n for n, _ in stream]
    assert "set_3d_instances" in names and "set_3d_meshes" not in names
    _torch_scene.replay(stream, ref)
    _torch_scene.replay(stream, port, port=True)
    assert port._scene_dev.tri_v0 is geo_before
    assert not np.array_equal(port._scene_host.inst_matrix, inst_before)
    assert_tuple_equal(ref._scene_host, port._scene_host)
    a, b = both(pair, CAM.get_view(W, H))
    assert port._spp == 1
    assert_frames_match(a, b)


def test_overlay_frame_matches(pair):
    v2 = Camera2D.from_width_height(W, H).get_view()
    base = pair[4].render(*_torch_scene.to_port((None, CAM.get_view(W, H), RenderMode.RESET)))
    a, b = both(pair, CAM.get_view(W, H), RenderMode.RESET, view_2d=v2)
    assert_frames_match(a, b)
    assert np.abs(b.astype(int) - base.astype(int)).max() > 30  # the overlay shows
