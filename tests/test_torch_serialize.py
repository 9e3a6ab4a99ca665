"""The port's scene snapshot against rfw_tpu's (`scene/serialize.py`): the
same scene saved by both packages gives snapshot files of the same arrays
and manifest, loading either gives the same scene, camera and film, and
the port's resume reproduces the scene it saved: a full synchronize of
the loaded scene makes the calls, with the arguments, of a full
synchronize of the original, and its animation goes on alike. Tolerance:
none. The scene covers `tests/test_serialize.py`'s cases: a sphere
instance with a transform, point, spot and sun lights, a camera and a
film; a morphed quad with instance weights and a skybox; and, for the
graph, the skinned and animated glTF of `_torch_scene.gltf_doc`.
"""

import importlib
import json

import numpy as np
import pytest

import _torch_scene
from _torch_scene import Recorder, gltf_doc, same, same_stream

PKGS = ("rfw_tpu", "rfw_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def author(pkg, gltf_path):
    sc, prim, mesh3d = mod(pkg, "scene"), mod(pkg, "models.primitives"), mod(pkg, "models.mesh3d")
    scene = sc.Scene()
    red = scene.add_material(sc.Material(name="red", color=np.array([0.8, 0.1, 0.1, 1], np.float32),
                                         roughness=0.3))
    mid = scene.add_3d_object(prim.sphere(quality=1, material_id=red))
    scene.add_3d_instance(mid).set_trs((1, 2, 3), (0, 0, 0, 1), (2, 2, 2))
    scene.add_point_light((0, 5, 0), (10, 9, 8))
    scene.add_spot_light((1, 4, 0), (0, -1, 0), (5, 5, 5), 20, 30)
    scene.add_directional_light((0.3, -1, 0.2), (2, 2, 2))

    q = prim.quad3d(normal=(0, 0, 1), position=(0, 0, 0), width=2, height=2)
    target = np.zeros((1, q.num_vertices, 3), np.float32)
    target[0, :, 2] = 1.0
    nrm_t = np.zeros((1, q.num_vertices, 3), np.float32)
    nrm_t[0, :, 0] = 0.7
    qid = scene.add_3d_object(mesh3d.build_mesh3d(
        q.positions, q.indices, normals=q.normals, uvs=q.uvs,
        morph_targets=target, morph_normals=nrm_t))
    scene.add_3d_instance(qid).set_morph_weights(np.array([0.4], np.float32))
    sky = np.zeros((8, 8, 4), np.uint8)
    sky[..., 2] = 200
    sky[..., 3] = 255
    scene.set_skybox(mod(pkg, "scene.materials").Texture.from_array(sky, srgb=False))

    handle = scene.add_3d(scene.load(gltf_path))
    scene.set_animations_time(0.3)
    scene.synchronize_graph()
    cam = mod(pkg, "scene.camera").Camera3D(fov=42.0).look_at(
        np.array([0, 1, 5], np.float32), np.zeros(3, np.float32))
    return scene, handle, cam


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("snap")
    gltf_path = d / "ribbon.gltf"
    gltf_path.write_text(json.dumps(gltf_doc()))
    film = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    out = {}
    for pkg in PKGS:
        scene, handle, cam = author(pkg, str(gltf_path))
        path = str(d / pkg)
        ser = mod(pkg, "scene.serialize")
        ser.save_scene(scene, path, camera=cam, film=film, spp=7)
        out[pkg] = (scene, handle, path + ser.EXTENSION, ser.load_scene(path))
    return out


def test_snapshot_files_match(saved):
    files = [np.load(saved[pkg][2]) for pkg in PKGS]
    assert files[0].files == files[1].files
    for k in files[0].files:
        same(files[0][k], files[1][k], k)
    manifest = json.loads(bytes(files[1]["__manifest__"]).decode())
    assert len(manifest["meshes"]) == 4 and manifest["film_spp"] == 7


def test_loaded_scenes_match(saved):
    same(saved["rfw_tpu"][3], saved["rfw_tpu_torch"][3], "load_scene")
    scene, cam, film, spp = saved["rfw_tpu_torch"][3]
    assert spp == 7 and film.shape == (64, 3) and abs(cam.fov - 42.0) < 1e-6
    assert scene.skybox.value is not None and scene.skybox.value.srgb is False


def test_resume_reproduces_the_scene(saved):
    """The port's loaded scene syncs like the scene it saved, and keeps
    animating like it."""
    scene, handle, _, (loaded, _, _, _) = saved["rfw_tpu_torch"]
    streams = []
    for s in (scene, loaded):
        rec = Recorder()
        _torch_scene.sync_full(s, rec)
        streams.append(rec.take())
    same_stream(*streams)
    assert len(loaded.graph.storage) == 1
    g2 = next(g for _, g in loaded.graph.storage)
    for t in (0.0, 0.8):
        for s in (scene, loaded):
            s.set_animations_time(t)
            s.synchronize_graph()
        same(handle.graph.skins, g2.skins, f"skins at t={t}")
        same(handle.graph.combined, g2.combined, f"combined at t={t}")
