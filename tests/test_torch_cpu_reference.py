"""The port's `CpuReferenceBackend` and the slice as a whole.

1. The oracle against rfw_tpu's: the `prim_scene` of
   `tests/test_reference_backend.py` built through each package's `Scene`
   and synchronized into each package's `CpuReferenceBackend` renders the
   same NORMAL, ALBEDO and GBUFFER frames, the same flattened world and the
   same DEFAULT frame and linear radiance (the oracle's own seeded RNG),
   bit for bit; its private `brute_force_closest` gives rfw_tpu's hits.
2. The slice: a scene authored through the port's `Instance` (an OBJ and
   the skinned, morphed and animated glTF of `_torch_scene.gltf_doc`
   without images, both through `Scene.load`, and two lights), rendered by
   `TorchBackend(device="cpu")` through the instance's frames, is within
   1e-3 RMSE of the port's `CpuReferenceBackend` in NORMAL, ALBEDO and
   GBUFFER (pixel centres, no bounce: `tests/test_reference_backend.py`'s
   bar), at two animation times that give different frames.
3. The same scene authored through rfw_tpu's `Instance` and rendered by
   `TpuBackend` (with RFW_NO_NATIVE=1, its numpy BVH builder, which the
   port copies) gives, with sampler="sobol", the port's DEFAULT frame per
   pixel within `tests/test_torch_backend.py`'s tolerance: every channel
   within 1 on at least 99% of pixels. This is the file's one JAX render
   configuration, at 48x36.
"""

import importlib
import json

import numpy as np
import pytest

import _torch_scene
from _torch_scene import gltf_doc, sync_full

PKGS = ("rfw_tpu", "rfw_tpu_torch")
OBJ_SRC = (  # tests/test_golden_configs.py's OBJ
    "mtllib gold.mtl\n"
    "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
    "v -0.4 0 -0.4\nv 0.4 0 -0.4\nv 0 1.0 0\n"
    "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
    "vn 0 1 0\n"
    "usemtl floor\n"
    "f 1/1/1 3/3/1 2/2/1\nf 1/1/1 4/4/1 3/3/1\n"
    "usemtl pyramid\n"
    "f 5/1 6/2 7/3\n"
)
MTL_SRC = (
    "newmtl floor\nKd 0.6 0.62 0.65\nNs 40\n"
    "\nnewmtl pyramid\nKd 0.8 0.25 0.2\nNs 160\n"
)


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    fa = a[..., :3].astype(np.float32) / 255.0
    fb = b[..., :3].astype(np.float32) / 255.0
    return float(np.sqrt(np.mean((fa - fb) ** 2)))


def settings(pkg, **kw):
    if pkg == "rfw_tpu":
        return mod(pkg, "render.tpu_backend").TpuSettings(**kw)
    return mod(pkg, "render.torch_backend").TorchSettings(**kw)


# ---------------------------------------------------------- 1. the oracle
def prim_scene(pkg):
    """tests/test_reference_backend.py's prim_scene."""
    sc, prim = mod(pkg, "scene"), mod(pkg, "models.primitives")
    scene = sc.Scene()
    red = scene.add_material(sc.Material(color=np.array([0.7, 0.2, 0.2, 1], np.float32),
                                         roughness=0.8, specular_f=0.3))
    gray = scene.add_material(sc.Material(color=np.array([0.6, 0.6, 0.6, 1], np.float32),
                                          roughness=1.0, specular_f=0.0))
    scene.add_3d_instance(scene.add_3d_object(prim.sphere(quality=2, material_id=red)))
    scene.add_3d_instance(scene.add_3d_object(
        prim.cube(position=(1.2, -0.4, 0.2), size=(0.8, 0.8, 0.8), material_id=gray)))
    scene.add_3d_instance(scene.add_3d_object(
        prim.quad3d(normal=(0, 1, 0), position=(0, -0.9, 0), width=8, height=8,
                    material_id=gray)))
    return scene


def test_oracle_matches_rfw_tpu():
    W, H = 96, 72
    frames = {}
    for pkg in PKGS:
        scene = prim_scene(pkg)
        view = mod(pkg, "scene.camera").Camera3D(fov=45).look_at(
            np.array([0.6, 1.2, 3.6], np.float32),
            np.array([0.3, 0.0, 0.0], np.float32)).get_view(W, H)
        Mode = mod(pkg, "backend.contract").RenderMode
        CpuRef = mod(pkg, "render.cpu_reference").CpuReferenceBackend
        be = CpuRef(W, H, settings(pkg, samples_per_frame=1, max_bounces=0, pixel_center=True))
        sync_full(scene, be)
        out = [be.render(None, view, m) for m in (Mode.NORMAL, Mode.ALBEDO, Mode.GBUFFER)]
        scene.add_directional_light((0.3, -1, -0.2), (2.5, 2.4, 2.2))
        be = CpuRef(W, H, settings(pkg, samples_per_frame=2, max_bounces=1,
                                   sky_intensity=0.6))
        sync_full(scene, be)
        out.append(be._world)  # the flattened world-space triangles
        out.append(be.render(None, view, Mode.DEFAULT))
        out.append(be._trace_once(view))  # one more sample's linear radiance
        frames[pkg] = out
    _torch_scene.same(frames["rfw_tpu"], frames["rfw_tpu_torch"], "frames")
    default = frames["rfw_tpu_torch"][4]
    assert default[..., :3].std() > 5.0  # a lit frame, not a blank one


def test_private_brute_force_closest_matches():
    """The oracle's private numpy copy of `brute_force_closest` against
    `rfw_tpu/render/intersect.py`'s, on seeded rays and triangles (hits,
    misses, grazing rays), in more than one triangle chunk."""
    from rfw_tpu.render.intersect import brute_force_closest as ref_bf
    from rfw_tpu_torch.render.cpu_reference import brute_force_closest as port_bf

    rng = np.random.default_rng(5)
    v0 = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    e1 = rng.normal(size=(300, 3)).astype(np.float32)
    e2 = rng.normal(size=(300, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (40_000, 3)).astype(np.float32)
    d = rng.normal(size=(40_000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref, got = ref_bf(o, d, v0, e1, e2), port_bf(o, d, v0, e1, e2)
    _torch_scene.same(list(ref), list(got), "brute_force_closest")
    assert 0.05 < (got[1] >= 0).mean() < 0.95


# ------------------------------------------------------------ 2. the slice
@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("app")
    (d / "gold.mtl").write_text(MTL_SRC)
    (d / "gold.obj").write_text(OBJ_SRC)
    (d / "ribbon.gltf").write_text(json.dumps(gltf_doc(images=False)))
    return str(d / "gold.obj"), str(d / "ribbon.gltf")


def author(pkg, inst, obj_path, gltf_path):
    """The slice's scene through `inst.scene` and `inst.camera`."""
    mx = mod(pkg, "mathx")
    scene = inst.scene
    obj = scene.add_3d(scene.load(obj_path))
    scene.add_3d_instance(obj, mx.compose_trs(np.array([3.2, 0, 0.3], np.float32),
                                              mx.quat_identity(), np.ones(3, np.float32)))
    handle = scene.add_3d(scene.load(gltf_path))
    scene.add_directional_light((0.3, -1, -0.4), (2.0, 1.9, 1.8))
    scene.add_point_light((1.0, 3.0, 2.0), (15, 15, 14))
    inst.camera.fov = 50
    inst.camera.look_at(np.array([1.4, 2.0, 5.2], np.float32),
                        np.array([1.2, 0.6, 0.0], np.float32))
    return handle


AOV = dict(samples_per_frame=1, max_bounces=0, pixel_center=True)


@pytest.fixture(scope="module")
def aov_frames(assets):
    """Per animation time: the port's TorchBackend frames through the
    instance and the port's oracle's, NORMAL, ALBEDO and GBUFFER."""
    from rfw_tpu_torch.app import Instance
    from rfw_tpu_torch.backend.contract import RenderMode
    from rfw_tpu_torch.render.cpu_reference import CpuReferenceBackend
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings

    W, H = 64, 48
    inst = Instance(TorchBackend(W, H, TorchSettings(**AOV), device="cpu"), W, H)
    author("rfw_tpu_torch", inst, *assets)
    modes = (RenderMode.NORMAL, RenderMode.ALBEDO, RenderMode.GBUFFER)
    out = []
    for t in (0.2, 0.9):
        inst.scene.set_animations_time(t)
        port = [inst.render_frame(m).copy() for m in modes]
        oracle = CpuReferenceBackend(W, H, TorchSettings(**AOV))
        sync_full(inst.scene, oracle)
        view = inst.camera.get_view(W, H)
        out.append((port, [oracle.render(None, view, m) for m in modes]))
    return modes, out


@pytest.mark.parametrize("k", range(3), ids=["NORMAL", "ALBEDO", "GBUFFER"])
def test_torch_backend_through_instance_matches_oracle(aov_frames, k):
    modes, out = aov_frames
    for t, (port, oracle) in zip((0.2, 0.9), out):
        assert port[k].shape == oracle[k].shape == (48, 64, 4)
        e = rmse(port[k], oracle[k])
        assert e <= 1e-3, f"{modes[k].name} at t={t}: RMSE {e:.5f}"
    # the animation moved the ribbon: the two times give different frames
    assert not np.array_equal(out[0][0][k], out[1][0][k])


# ---------------------------------------------- 3. TorchBackend vs TpuBackend
def test_default_frame_matches_tpu_backend(assets, monkeypatch):
    W, H = 48, 36
    kw = dict(samples_per_frame=1, max_bounces=1, clamp=20.0, sky_intensity=0.5,
              sampler="sobol")
    monkeypatch.setenv("RFW_NO_NATIVE", "1")
    frames = []
    for pkg in PKGS:
        if pkg == "rfw_tpu":
            backend = mod(pkg, "render.tpu_backend").TpuBackend(
                W, H, settings(pkg, device_dynamics=False, device_motion=False, **kw))
        else:
            backend = mod(pkg, "render.torch_backend").TorchBackend(
                W, H, settings(pkg, **kw), device="cpu")
        inst = mod(pkg, "app").Instance(backend, W, H)
        author(pkg, inst, *assets)
        inst.scene.set_animations_time(0.6)
        frames.append(inst.render_frame())
    a, b = frames
    assert a.shape == b.shape == (H, W, 4) and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(axis=-1)
    assert (diff <= 1).mean() >= 0.99, (diff > 1).mean()
    assert b[..., :3].std() > 5.0
