"""The port's scene layer against rfw_tpu's: the same seeded calls through
both packages' `Scene`, each synchronized into a `Recorder`, give the same
contract calls, in the same order, with bit-identical arguments, and the
two scenes stay equal field for field (`_torch_scene.same`). Tolerance:
none. The steps: an initial sync, instance edits, material and texture
edits (`touch_texture` among them), light edits, a skybox set and cleared,
2D edits, and a mesh removal. Then the counterparts of
`tests/test_scene_sync.py`'s tests that need no asset: the incremental
area-light cache, the shadow projections and `LightInfo` packing, the
level-order graph propagation; and the cameras.
"""

import importlib

import numpy as np
import pytest

import _torch_scene
from _torch_scene import Recorder, same, same_stream

PKGS = ("rfw_tpu", "rfw_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def author(pkg):
    """A scene with a textured sphere (5 instances), an emissive slab, a
    floor, point, spot and sun lights and a 2D quad; returns (scene, ids)."""
    sc, mat, prim, mx = (mod(pkg, n) for n in ("scene", "scene.materials",
                                                "models.primitives", "mathx"))
    rng = np.random.default_rng(11)
    scene = sc.Scene()
    checker = ((np.indices((32, 32)).sum(0) // 4) % 2 * 200 + 30).astype(np.uint8)
    tex = scene.add_texture(mat.Texture.from_array(checker))
    red = scene.add_material(sc.Material(name="red", color=np.array([0.8, 0.2, 0.1, 1], np.float32),
                                         roughness=0.4, diffuse_tex=tex))
    glow = scene.add_material(sc.Material(name="glow",
                                          color=np.array([4, 3.5, 3, 1], np.float32)))
    gray = scene.add_material(sc.Material(name="gray", roughness=0.9))
    s = scene.add_3d_object(prim.sphere(quality=1, material_id=red))
    c = scene.add_3d_object(prim.cube(size=(1, 0.1, 1), material_id=glow))
    f = scene.add_3d_object(prim.quad3d(normal=(0, 1, 0), position=(0, 0, 0), width=8,
                                        height=8, material_id=gray))
    handles = []
    for _ in range(5):
        t = rng.uniform(-2, 2, 3).astype(np.float32)
        handles.append(scene.add_3d_instance(
            s, mx.compose_trs(t, mx.quat_identity(), np.full(3, 0.5, np.float32))))
    scene.add_3d_instance(c, mx.compose_trs(np.array([0, 3, 0], np.float32),
                                            mx.quat_identity(), np.ones(3, np.float32)))
    scene.add_3d_instance(f)
    scene.add_point_light((0, 2, 0), (10, 9, 8))
    scene.add_spot_light((1, 4, 1), (-0.2, -1, -0.1), (30, 30, 28), 20.0, 35.0)
    scene.add_directional_light((0.4, -1, 0.3), (2, 2, 1.8))
    q = scene.add_2d_object(prim.quad2d(center=(20, 10), size=(16, 8), texture_id=tex))
    h2 = scene.add_2d_instance(q)
    return scene, dict(tex=tex, red=red, glow=glow, gray=gray, s=s, c=c, f=f,
                       handles=handles, q=q, h2=h2)


def edit_instances(pkg, scene, ids):
    h = ids["handles"]
    h[0].set_trs((1, 0.5, -1), (0, 0.38268343, 0, 0.9238795), (0.7, 0.7, 0.7))
    h[1].remove()
    with h[2].transform() as t:
        t.translate((0.5, 0, 0)).rotate_y(0.3).scale(1.5)
    ids["handles"].append(scene.add_3d_instance(ids["s"]))
    ids["h2"].set_matrix(np.diag([1.5, 1, 1, 1]).astype(np.float32))
    scene._instances_changed = True  # handle edits do not raise the scene's flag


def edit_materials(pkg, scene, ids):
    scene.materials.get_mut(ids["red"]).roughness = 0.9
    scene.materials.touch_texture(ids["tex"])  # re-flags `red`, which samples it
    noise = np.random.default_rng(2).integers(0, 255, (16, 16, 4)).astype(np.uint8)
    t2 = scene.add_texture(mod(pkg, "scene.materials").Texture.from_array(noise, srgb=False))
    scene.add_material(mod(pkg, "scene").Material(name="noisy", normal_tex=t2))


def edit_lights(pkg, scene, ids):
    scene.lights.point.get_mut(0).energy = np.array([3, 3, 3], np.float32)
    scene.add_spot_light((-2, 3, 0), (0.3, -1, 0), (12, 12, 12), 15.0, 25.0)
    scene.lights.directional.erase(0)
    # a dimmer emitter: the area lights are extracted again
    scene.materials.get_mut(ids["glow"]).color = np.array([2, 2, 2, 1], np.float32)


def edit_skybox(pkg, scene, ids):
    sky = np.zeros((8, 16, 4), np.uint8)
    sky[..., 2] = 180
    sky[..., 3] = 255
    scene.set_skybox(mod(pkg, "scene.materials").Texture.from_array(sky, srgb=True))


def clear_skybox(pkg, scene, ids):
    scene.set_skybox(None)


def edit_2d(pkg, scene, ids):
    prim = mod(pkg, "models.primitives")
    scene.set_2d_object(ids["q"], prim.quad2d(center=(8, 8), size=(4, 4),
                                              color=(1, 0, 0, 1)))


def remove_mesh(pkg, scene, ids):
    scene.remove_3d_object(ids["c"])


def nothing(pkg, scene, ids):
    pass


STEPS = [nothing, edit_instances, nothing, edit_materials, edit_lights, edit_skybox,
         clear_skybox, edit_2d, remove_mesh]


@pytest.fixture(scope="module")
def synced():
    """Both packages through STEPS: per step, each package's stream."""
    runs = {}
    for pkg in PKGS:
        scene, ids = author(pkg)
        rec = Recorder()
        streams = []
        for step in STEPS:
            step(pkg, scene, ids)
            scene.synchronize(rec)
            streams.append(rec.take())
        runs[pkg] = (scene, streams)
    return runs


@pytest.mark.parametrize("k", range(len(STEPS)),
                         ids=[f"{i}-{s.__name__}" for i, s in enumerate(STEPS)])
def test_synchronize_streams_match(synced, k):
    ref, got = synced["rfw_tpu"][1][k], synced["rfw_tpu_torch"][1][k]
    same_stream(ref, got)
    names = [c[0] for c in got]
    assert names[-1] == "synchronize"
    if STEPS[k] is nothing and k > 0:
        assert names == ["synchronize"]  # nothing changed: only the barrier


def test_scenes_match_after_all_steps(synced):
    same(synced["rfw_tpu"][0], synced["rfw_tpu_torch"][0], "scene")


def test_streams_cover_the_contract(synced):
    """The steps exercise every call a synchronize can make."""
    seen = {c[0] for s in synced["rfw_tpu_torch"][1] for c in s}
    assert seen == set(_torch_scene.STREAM) - {"set_skins"}, seen


def test_recording_backend_streams_match():
    """The port's RecordingBackend, the contract's test fake: through the
    same edit steps, a render and a resize it records the calls rfw_tpu's
    records (names, ids, counts, modes), in the same order."""
    calls = {}
    for pkg in PKGS:
        scene, ids = author(pkg)
        be = mod(pkg, "backend.contract").RecordingBackend()
        be.resize(64, 48)
        for step in STEPS:
            step(pkg, scene, ids)
            scene.synchronize(be)
        frame = be.render(None, None)
        assert frame.shape == (48, 64, 4) and frame.dtype == np.uint8
        be.resize(32, 16)
        calls[pkg] = be.calls
    same(calls["rfw_tpu"], calls["rfw_tpu_torch"])
    assert {c[0] for c in calls["rfw_tpu_torch"]} >= set(_torch_scene.STREAM) - {"set_skins"}


def test_sync_full_replays_everything():
    """A second backend needs a full re-trigger (`sync_full`); both
    packages give it the same stream."""
    streams = []
    for pkg in PKGS:
        scene, ids = author(pkg)
        scene.synchronize(Recorder())
        edit_instances(pkg, scene, ids)
        rec = Recorder()
        _torch_scene.sync_full(scene, rec)
        streams.append(rec.take())
    same_stream(*streams)
    assert "set_3d_meshes" in [c[0] for c in streams[1]]


def test_update_lights_incremental_cache():
    """tests/test_scene_sync.py::test_update_lights_incremental_cache in
    both packages: the same chunks, the untouched mesh's reused."""
    out = []
    for pkg in PKGS:
        sc, prim = mod(pkg, "scene"), mod(pkg, "models.primitives")
        scene = sc.Scene()
        glow = scene.add_material(sc.Material(color=np.array([5, 5, 5, 1], np.float32)))
        a = scene.add_3d_object(prim.cube(size=(1, 0.1, 1), material_id=glow))
        b = scene.add_3d_object(prim.cube(size=(2, 0.1, 2), material_id=glow))
        ha = scene.add_3d_instance(a)
        scene.add_3d_instance(b)
        scene.update_lights()
        first = scene.lights.area
        chunk_b = scene._area_cache[b]
        scene.instances_3d[a].reset_changed()
        scene.instances_3d[b].reset_changed()
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = 3.0
        ha.set_matrix(m)
        moved = {s for s, il in scene.instances_3d.items() if il.any_changed}
        assert moved == {a}
        scene.update_lights(moved)
        assert scene._area_cache[b] is chunk_b
        out.append((first, scene.lights.area, scene._area_cache,
                    [scene.meshes_3d[s].tri_light for s in (a, b)]))
    same(*out)
    assert out[1][1].count == 24


def test_light_shadow_projections():
    """tests/test_scene_sync.py::test_light_shadow_projections' matrices
    and LightInfo blocks, the same in both packages."""
    out = []
    for pkg in PKGS:
        L = mod(pkg, "scene.lights")
        pl = L.PointLight(np.array([1.0, 2.0, 3.0], np.float32), np.ones(3, np.float32))
        sl = L.SpotLight(np.zeros(3, np.float32), np.array([0, 0, -1], np.float32),
                         np.ones(3, np.float32), inner_angle=20.0, outer_angle=30.0)
        sl2 = L.SpotLight(np.ones(3, np.float32), np.array([0, -1, 0], np.float32),
                          np.ones(3, np.float32), inner_angle=10.0, outer_angle=45.0)
        dl = L.DirectionalLight(np.array([0.3, -1.0, 0.2], np.float32), np.ones(3, np.float32))
        lo, hi = np.array([-2, 0, -3], np.float32), np.array([4, 5, 1], np.float32)
        am = L.area_light_shadow_matrix(np.zeros(3, np.float32), np.array([0, 1, 0], np.float32))
        out.append(dict(
            cube=pl.cube_matrices(near=0.1, far=50.0), spot=sl.shadow_matrix(),
            spot_down=sl2.shadow_matrix(near=0.5, far=20.0), cos=(sl.cos_inner, sl.cos_outer),
            sun=dl.shadow_matrix(lo, hi), area=am,
            info=L.pack_light_info(am, np.array([1, 2, 3], np.float32), 42.0)))
    same(*out)
    pm = out[1]["spot"]
    h = pm @ np.array([0, 0, -10, 1], np.float32)
    assert np.linalg.norm(h[:2] / h[3]) < 1e-4  # the axis lands at the centre
    assert out[1]["info"].nbytes == 256


def test_level_order_propagation_matches():
    """tests/test_scene_sync.py::TestLevelOrderPropagation in both
    packages: the same combined matrices, and both equal the recursion."""
    rng = np.random.default_rng(1234)
    n = 30
    parents = [-1] + [int(rng.integers(0, i)) for i in range(1, n)]
    t = rng.normal(size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    s = (0.5 + rng.uniform(size=(n, 3))).astype(np.float32)
    graphs = []
    for pkg in PKGS:
        D, G, mx = mod(pkg, "scene.descriptor"), mod(pkg, "scene.graph"), mod(pkg, "mathx")
        nodes = [D.NodeDescriptor(translation=t[i], rotation=mx.quat_normalize(q[i]),
                                  scale=s[i]) for i in range(n)]
        for i, p in enumerate(parents):
            if p >= 0:
                nodes[p].children.append(i)
        g = G.NodeGraph(D.SceneDescriptor(nodes=nodes, roots=[0]), {})
        g.update()
        graphs.append(g)
    same(graphs[0].combined, graphs[1].combined, "combined")
    same(graphs[0].levels, graphs[1].levels, "levels")
    mx = mod("rfw_tpu_torch", "mathx")
    local = mx.compose_trs(t, mx.quat_normalize(q), s)
    expected = np.zeros_like(local)

    def rec(i, pm):
        expected[i] = pm @ local[i]
        for c in [c for c, p in enumerate(parents) if p == i]:
            rec(c, expected[i])

    rec(0, np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(graphs[1].combined, expected, atol=1e-4)


def test_cameras_match():
    out = []
    for pkg in PKGS:
        C = mod(pkg, "scene.camera")
        cam = C.Camera3D(fov=50).look_at(np.array([1, 2, 5], np.float32),
                                         np.array([0, 0.5, 0], np.float32))
        cam.translate_relative(np.array([0.2, 0.1, -0.3], np.float32))
        cam.translate_target(np.array([0.05, -0.02, 0], np.float32))
        vp = cam.view_projection(64, 48)
        fr = C.Frustum(vp)
        mn = np.array([[-1, -1, -1], [30, 30, 30], [-0.2, 0, -0.2]], np.float32)
        out.append(dict(view=cam.get_view(64, 48), vp=vp, planes=fr.planes,
                        boxes=fr.aabb_batch(mn, mn + 0.5),
                        tests=[fr.point(np.zeros(3, np.float32)).name,
                               fr.sphere(np.zeros(3, np.float32), 0.5).name,
                               fr.aabb(mn[1], mn[1] + 1).name],
                        cam2d=C.Camera2D.from_width_height(64, 48, 2.0).get_view()))
    same(*out)
    assert out[1]["tests"][2] == "OUTSIDE"
