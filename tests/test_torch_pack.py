"""The port's host packers give bit-identical arrays to rfw_tpu's.

Both packages build BVHs with their native C++ builders by default
(`tests/test_torch_native.py` holds those against each other); here both
run their numpy paths (RFW_NO_NATIVE=1, which each package reads).
Tolerance: none — np.array_equal on every field.
"""

import dataclasses

import numpy as np
import pytest

import _torch_scene

CASES = [
    dict(seed=0, n_inst=3, quality=1, with_tex=True),
    dict(seed=5, n_inst=5, quality=2, with_tex=False),
]


@pytest.fixture(scope="module", params=range(len(CASES)), ids=lambda i: f"case{i}")
def both(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        ref = _torch_scene.build("rfw_tpu", **CASES[request.param])
        port = _torch_scene.build("rfw_tpu_torch", **CASES[request.param])
    finally:
        mp.undo()
    return ref, port


def _assert_tuple_equal(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


def test_pack_trace_scene(both):
    (ref, port) = both
    _assert_tuple_equal(ref[0], port[0])


def test_pack_lights(both):
    ref, port = both
    _assert_tuple_equal(ref[2], port[2])


def test_materials_to_device(both):
    ref, port = both
    for f in dataclasses.fields(ref[1]):
        x, y = getattr(ref[1], f.name), getattr(port[1], f.name)
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name


def test_pack_atlas(both):
    ref, port = both
    _assert_tuple_equal(ref[3], port[3])


@pytest.mark.parametrize("size", [(32, 32), (256, 144), (1920, 1080)])
def test_camera_view(both, size):
    ref, port = both
    a = ref[4].get_view(*size).as_array()
    b = port[4].get_view(*size).as_array()
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bvh_build_matches_reference_numpy_path():
    from rfw_tpu.accel.bvh_cpu import build_bvh_sah as ref_build
    from rfw_tpu_torch.accel.bvh_cpu import build_bvh_sah

    rng = np.random.default_rng(3)
    c = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    mn, mx = c - 0.2, c + rng.uniform(0.1, 1.0, (500, 3)).astype(np.float32)
    a = ref_build(mn, mx, max_leaf=8, use_native=False)
    b = build_bvh_sah(mn, mx, max_leaf=8, use_native=False)
    for f in dataclasses.fields(a):
        assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), f.name


# ---- the backend's host copies: deformed packs, instance repack, views,
# the 2D overlay


def _deform_inputs(pkg):
    """Two meshes of `pkg` (a skinnable sphere, a cube) with seeded
    deformed positions and shading attributes for the sphere, three
    instances."""
    import importlib

    prim = importlib.import_module(f"{pkg}.models.primitives")
    rng = np.random.default_rng(9)
    s, c = prim.sphere(quality=1), prim.cube()
    pos = (s.positions * rng.uniform(0.8, 1.2, (s.num_vertices, 1))).astype(np.float32)
    nrm = (s.normals + rng.normal(0, 0.1, s.normals.shape)).astype(np.float32)
    tan = np.concatenate([s.tangents[:, :3][::-1], s.tangents[:, 3:]], 1).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)
    m = np.stack([eye, eye])
    m[1, :3, 3] = (2.0, 0.5, -1.0)
    return [(0, s, None), (1, c, None)], [(0, m), (1, eye[None])], {0: pos}, {0: (nrm, tan)}


@pytest.mark.parametrize("refit", [False, True], ids=["build", "refit"])
def test_pack_deformed_and_outputs(monkeypatch, refit):
    """pack_trace_scene with deformed positions and attributes (a BLAS
    build, or a refit of a cached BLAS), and the BLAS it builds."""
    from rfw_tpu.render.pack import pack_trace_scene as ref_pack
    from rfw_tpu_torch.render.pack import pack_trace_scene

    monkeypatch.setenv("RFW_NO_NATIVE", "1")
    out = []
    for pkg, pack in (("rfw_tpu", ref_pack), ("rfw_tpu_torch", pack_trace_scene)):
        meshes, inst, pos, attrs = _deform_inputs(pkg)
        if refit:  # the rest pose's BLAS, refitted to the deformed one
            blas = {}
            pack(meshes, inst, built_blas_out=blas)
            meshes = [(k, m, blas[k]) for k, m, _ in meshes]
        blas_out = {}
        scene = pack(meshes, inst, deformed_positions=pos, deformed_attrs=attrs,
                     built_blas_out=blas_out)
        out.append((scene, blas_out))
    (ref, ref_blas), (got, blas) = out
    _assert_tuple_equal(ref, got)
    assert sorted(blas) == sorted(ref_blas) == ([] if refit else [0, 1])
    for k in blas:
        for f in dataclasses.fields(blas[k]):
            assert np.array_equal(getattr(blas[k], f.name), getattr(ref_blas[k], f.name))


def test_repack_instances(monkeypatch):
    from rfw_tpu.render.pack import pack_trace_scene as ref_pack, repack_instances as ref_repack
    from rfw_tpu_torch.render.pack import pack_trace_scene, repack_instances

    monkeypatch.setenv("RFW_NO_NATIVE", "1")
    out = []
    for pkg, pack, repack in (("rfw_tpu", ref_pack, ref_repack),
                              ("rfw_tpu_torch", pack_trace_scene, repack_instances)):
        meshes, inst, _, _ = _deform_inputs(pkg)
        base = pack(meshes, inst)
        moved = [(k, m.copy()) for k, m in inst]
        moved[0][1][:, :3, 3] += np.random.default_rng(4).normal(0, 1, (2, 3)).astype(np.float32)
        info = [(k, m.aabb_min, m.aabb_max) for k, m, _ in meshes]
        out.append(repack(base, info, moved))
    _assert_tuple_equal(*out)


def test_views():
    """Mesh3D.view(), Mesh2D, quad2d and every view class: same fields, the
    same arrays, the same validation."""
    import rfw_tpu.backend.lights as ref_lights
    import rfw_tpu.backend.structs as ref_structs
    from rfw_tpu.models import primitives as ref_prim
    import rfw_tpu_torch.backend.lights as lights
    import rfw_tpu_torch.backend.structs as structs
    from rfw_tpu_torch.models import primitives as prim

    names = ["MeshView3D", "MeshView2D", "InstancesView3D", "InstancesView2D", "SkinView",
             "TextureView", "DeviceMaterials", "CameraView3D", "CameraView2D"]
    for ref_mod, mod, classes in ((ref_structs, structs, names),
                                  (ref_lights, lights, ["PointLightsView", "SpotLightsView",
                                                        "DirectionalLightsView",
                                                        "AreaLightsView"])):
        for n in classes:
            a, b = getattr(ref_mod, n), getattr(mod, n)
            assert [(f.name, f.type) for f in dataclasses.fields(a)] == \
                [(f.name, f.type) for f in dataclasses.fields(b)], n
    assert structs.INVALID_ID == ref_structs.INVALID_ID
    for a, b in ((ref_prim.sphere(quality=1).view(), prim.sphere(quality=1).view()),
                 (ref_prim.cube().view(), prim.cube().view()),
                 (ref_prim.quad2d((3, 4), (5, 6), 0.5, (1, 0.5, 0.2, 0.8), 2).view(),
                  prim.quad2d((3, 4), (5, 6), 0.5, (1, 0.5, 0.2, 0.8), 2).view())):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name
    from rfw_tpu.models.mesh2d import Mesh2D as RefMesh2D
    from rfw_tpu_torch.models.mesh2d import Mesh2D

    pts = np.random.default_rng(2).random((6, 2))
    a, b = RefMesh2D.new(pts).view(), Mesh2D.new(pts).view()
    assert all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("positions", "uvs", "colors"))
    bad = dict(positions=np.zeros((3, 3), np.float64), uvs=np.zeros((3, 2), np.float32),
               colors=np.zeros((3, 4), np.float32))
    for cls in (ref_structs.MeshView2D, structs.MeshView2D):
        with pytest.raises(TypeError):
            cls(**bad).validate()


def test_overlay_rasterize_and_composite():
    """rasterize_2d (textured and vertex-coloured quads, one rotated) and
    composite_overlay bit-identical."""
    from rfw_tpu.backend.structs import InstancesView2D as RefInst, TextureView as RefTex
    from rfw_tpu.models.primitives import quad2d as ref_quad2d
    from rfw_tpu.render.overlay import composite_overlay as ref_comp, rasterize_2d as ref_rast
    from rfw_tpu.scene.camera import Camera2D
    from rfw_tpu_torch.backend.structs import InstancesView2D, TextureView
    from rfw_tpu_torch.models.primitives import quad2d
    from rfw_tpu_torch.render.overlay import composite_overlay, rasterize_2d

    w, h = 48, 40
    c = np.indices((16, 16)).sum(axis=0) % 2
    img = np.stack([c * 255, 255 - c * 200, np.full_like(c, 90), np.full_like(c, 255)],
                   axis=-1).astype(np.uint8)
    rot = np.eye(4, dtype=np.float32)
    rot[:2, :2] = [[np.cos(0.6), -np.sin(0.6)], [np.sin(0.6), np.cos(0.6)]]
    rot[:2, 3] = (30, 22)
    mats = [np.eye(4, dtype=np.float32)[None], rot[None]]
    cam = Camera2D.from_width_height(w, h).get_view().matrix
    frame = np.random.default_rng(6).integers(0, 256, (h, w, 4)).astype(np.uint8)
    out = []
    for quad, inst, tex, rast, comp in ((ref_quad2d, RefInst, RefTex, ref_rast, ref_comp),
                                        (quad2d, InstancesView2D, TextureView, rasterize_2d,
                                         composite_overlay)):
        pairs = [(quad((14, 12), (16, 12), texture_id=0).view(),
                  inst(mats[0], np.ones(1, bool))),
                 (quad((0, 0), (20, 10), color=(1.0, 0.4, 0.2, 0.7)).view(),
                  inst(mats[1], np.ones(1, bool)))]
        ov = rast(pairs, {0: tex([img])}, cam, w, h)
        out.append((ov, comp(frame, ov)))
    (ov_a, fr_a), (ov_b, fr_b) = out
    assert ov_a.dtype == ov_b.dtype and np.array_equal(ov_a, ov_b)
    assert (ov_b[..., 3] > 0).mean() > 0.1
    assert fr_a.dtype == fr_b.dtype == np.uint8 and np.array_equal(fr_a, fr_b)


def test_mesh_ranges_out(monkeypatch):
    """pack_trace_scene's `mesh_ranges_out` (the arena ranges the device
    refit plans read) equals rfw_tpu's on a scene with a skinned unit, a
    morphed unit packed as two pose groups under pseudo slots, and a
    static mesh."""
    from rfw_tpu.render.pack import pack_trace_scene as ref_pack
    from rfw_tpu_torch.render.pack import pack_trace_scene

    import importlib

    monkeypatch.setenv("RFW_NO_NATIVE", "1")
    out = []
    for pkg, pack in (("rfw_tpu", ref_pack), ("rfw_tpu_torch", pack_trace_scene)):
        prim = importlib.import_module(f"{pkg}.models.primitives")
        skinned, morphed, static = prim.sphere(quality=1), prim.quad3d(), prim.cube()
        v = skinned.num_vertices
        skinned.joints = np.tile(np.array([0, 1, 0, 0], np.int32), (v, 1))
        skinned.weights = np.tile(np.array([0.5, 0.5, 0, 0], np.float32), (v, 1))
        morphed.morph_targets = np.ones((1, morphed.num_vertices, 3), np.float32)
        eye = np.eye(4, dtype=np.float32)
        pseudo = [(1 << 20) + (1 << 12) + g for g in range(2)]
        meshes = [(0, skinned, None), (pseudo[0], morphed, None),
                  (pseudo[1], morphed, None), (2, static, None)]
        inst = [(0, np.stack([eye, eye])), (pseudo[0], eye[None]), (pseudo[1], eye[None]),
                (2, eye[None]), (7, eye[None])]  # slot 7 has no mesh: skipped
        ranges = {}
        pack(meshes, inst, deformed_positions={0: skinned.positions + 0.1},
             mesh_ranges_out=ranges)
        out.append(ranges)
    _torch_scene.same(out[0], out[1])
    assert out[1][pseudo[1]]["inst"] == (3, 4) and "__tlas__" in out[1]
