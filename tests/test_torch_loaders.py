"""The port's OBJ and glTF loaders against rfw_tpu's: the same files give
bit-identical meshes, descriptors, materials and textures
(`_torch_scene.same`), and a loaded skinned, morphed and animated glTF
gives bit-identical joint matrices, instance matrices and morph weights at
several animation times. Tolerance: none.

The OBJ is `tests/test_loaders.py`'s fixture. The glTF is
`_torch_scene.gltf_doc`'s: a ribbon skinned to two joints, with a morph
target and default weights, positions and normals interleaved in one
strided buffer view, an animation of a rotation, a translation and the
morph weight, and a floor textured by two embedded PNGs (the loaders
decode them on a `TaskPool`).
"""

import importlib
import json
import threading
import time

import numpy as np
import pytest

from _torch_scene import Recorder, gltf_doc, same, same_stream

PKGS = ("rfw_tpu", "rfw_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module")
def obj_path(tmp_path_factory):
    """tests/test_loaders.py's two-material OBJ with its MTL."""
    d = tmp_path_factory.mktemp("obj")
    (d / "fix.mtl").write_text(
        "newmtl red\nNs 96.0\nKd 0.8 0.1 0.1\nKs 0.5 0.5 0.5\nNi 1.45\nd 1.0\n"
        "\nnewmtl glow\nKd 1 1 1\nKe 5.0 4.0 3.0\n"
    )
    (d / "fix.obj").write_text(
        "mtllib fix.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "v 0 0 1\nv 1 0 1\nv 1 1 1\nv 0 1 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 -1\nvn 0 0 1\n"
        "usemtl red\n"
        "f 1/1/1 3/3/1 2/2/1\nf 1/1/1 4/4/1 3/3/1\n"
        "usemtl glow\n"
        "f 5/1/2 6/2/2 7/3/2\nf 5/1/2 7/3/2 8/4/2\n"
        "usemtl red\n"
        "f -8 -7 -6 -5\n"
    )
    return str(d / "fix.obj")


@pytest.fixture(scope="module")
def gltf_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("gltf") / "ribbon.gltf"
    p.write_text(json.dumps(gltf_doc()))
    return str(p)


def test_obj_loads_identically(obj_path):
    out = []
    for pkg in PKGS:
        mats = mod(pkg, "scene.materials").Materials()
        desc = mod(pkg, "loaders.obj").ObjLoader().load(obj_path, mats)
        out.append((desc, mats, mats.to_device(), mats.light_flags()))
    same(*out)
    desc, mats = out[1][0], out[1][1]
    assert desc.mesh.num_triangles == 6 and len(mats.materials) == 3  # default, red, glow
    assert out[1][3].tolist() == [False, False, True]  # `glow` emits


def test_scene_load_dispatches_by_extension(obj_path, gltf_path):
    out = []
    for pkg in PKGS:
        scene = mod(pkg, "scene").Scene()
        descs = [scene.load(obj_path), scene.load(gltf_path)]
        with pytest.raises(mod(pkg, "scene").SceneError):
            scene.load("model.fbx")
        out.append((descs, scene.materials))
    same(*out)
    assert sorted(mod("rfw_tpu_torch", "loaders").LOADERS) == [".glb", ".gltf", ".obj"]


def test_gltf_loads_identically(gltf_path):
    out = []
    for pkg in PKGS:
        mats = mod(pkg, "scene.materials").Materials()
        desc = mod(pkg, "loaders.gltf").GltfLoader().load(gltf_path, mats)
        out.append((desc, mats, [t.view() for _, t in mats.textures], mats.to_device()))
    same(*out)
    desc, mats = out[1][0], out[1][1]
    ribbon = desc.meshes[0]
    assert ribbon.has_skin and ribbon.has_morphs and ribbon.morph_normals is not None
    assert len(desc.skins) == 1 and len(desc.animations[0].channels) == 3
    # the strided NORMAL accessor resolved to the interleaved normals
    assert np.allclose(ribbon.normals[:, 2], 1.0)
    # the store's own default texture, then baseColor (sRGB) and
    # metallic-roughness (linear)
    assert [t.srgb for _, t in mats.textures] == [True, True, False]


def test_texture_decode_order_does_not_matter(gltf_path, monkeypatch):
    """The first image's decode finishes last: the texture ids and their
    contents stay those of an ordinary load."""
    gltf = mod("rfw_tpu_torch", "loaders.gltf")
    plain = mod("rfw_tpu_torch", "scene.materials").Materials()
    gltf.GltfLoader().load(gltf_path, plain)

    decoded = []
    first_done = threading.Event()
    image_array = gltf._Gltf.image_array

    def slow_first(self, i):
        if i == 0:
            assert first_done.wait(10), "the second decode never finished"
            time.sleep(0.05)
        out = image_array(self, i)
        decoded.append(i)
        if i == 1:
            first_done.set()
        return out

    monkeypatch.setattr(gltf._Gltf, "image_array", slow_first)
    mats = mod("rfw_tpu_torch", "scene.materials").Materials()
    gltf.GltfLoader().load(gltf_path, mats)
    assert decoded == [1, 0]  # the threads finished out of order
    same_textures = [(i, t.mips) for i, t in plain.textures]
    got = [(i, t.mips) for i, t in mats.textures]
    assert [i for i, _ in got] == [i for i, _ in same_textures]
    for (_, a), (_, b) in zip(same_textures, got):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def animated(gltf_path):
    """Per package: the glTF instanced into a Scene, and per animation
    time the recorded synchronize and the skins."""
    times = (0.0, 0.25, 0.6, 1.0, 1.7)
    out = {}
    for pkg in PKGS:
        scene = mod(pkg, "scene").Scene()
        handle = scene.add_3d(scene.load(gltf_path))
        rec = Recorder()
        runs = []
        for t in times:
            scene.set_animations_time(t)
            scene.synchronize(rec)
            g = handle.graph
            runs.append((rec.take(), [s.joint_matrices.copy() for s in g.skins],
                         g.combined.copy(), dict(g.morph_weights)))
        out[pkg] = (scene, runs)
    return times, out


def test_joint_matrices_identical_over_time(animated):
    times, out = animated
    for k, t in enumerate(times):
        ref, got = out["rfw_tpu"][1][k], out["rfw_tpu_torch"][1][k]
        same_stream(ref[0], got[0])
        same(ref[1:], got[1:], f"t={t}")
    runs = out["rfw_tpu_torch"][1]
    assert not np.allclose(runs[0][1][0], runs[2][1][0], atol=1e-4)  # the joint turned
    assert "set_skins" in [c[0] for c in runs[2][0]]
    same(out["rfw_tpu"][0], out["rfw_tpu_torch"][0], "scene")


def test_strided_accessor_at_buffer_end():
    """tests/test_loaders.py::test_gltf_strided_accessor_at_buffer_end,
    through both packages' `_Gltf.accessor`."""
    count, stride = 4, 20
    buf = bytearray(stride * (count - 1) + 12)
    expect = np.arange(count * 3, dtype=np.float32).reshape(count, 3)
    for i in range(count):
        buf[i * stride: i * stride + 12] = expect[i].tobytes()
    out = []
    for pkg in PKGS:
        G = mod(pkg, "loaders.gltf")._Gltf
        g = G.__new__(G)
        g.json = {"accessors": [{"componentType": 5126, "type": "VEC3", "count": count,
                                 "bufferView": 0}],
                  "bufferViews": [{"buffer": 0, "byteStride": stride}], "buffers": [{}]}
        g.bin, g._buffers, g.base = bytes(buf), {}, "."
        out.append(g.accessor(0))
    same(*out)
    np.testing.assert_array_equal(out[1], expect)
