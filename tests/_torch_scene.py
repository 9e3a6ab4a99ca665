"""Small seeded test scene, built with either package's host API, and the
sync stream of a scene replayed into either package's backend.

`build("rfw_tpu", ...)` and `build("rfw_tpu_torch", ...)` run the same
calls through the JAX package and through the port, so the tests can hold
the port's packers against the reference's, and feed one packed scene to
both renderers. The scene: three icosphere meshes (metal, clearcoat
plastic, glass) with a few seeded instances each, a checker-textured floor
quad, an emissive quad registered as two area lights, a spot light and a
sun.

`Recorder` is a backend of neither package that records every contract
call with a copy of its arguments; `replay` feeds the recorded calls to a
backend, with each view rebuilt as the port's class of the same name
(`to_port`) for the port's. `sync_full` re-triggers every change feed of a
`Scene` and drains it into a backend, and `same` holds a value made by the
port against the one rfw_tpu made, bit for bit, down through dataclasses,
containers and arrays.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import dataclasses
import enum
import importlib
import io

import numpy as np

#: the Backend methods a scene's synchronize calls
STREAM = ("set_3d_meshes", "unload_3d_meshes", "set_3d_instances", "set_2d_meshes",
          "set_2d_instances", "set_materials", "set_textures", "set_skybox",
          "set_point_lights", "set_spot_lights", "set_area_lights",
          "set_directional_lights", "set_skins", "synchronize")


class Recorder:
    """A backend of neither package: each contract call is kept in
    `.stream` as (name, deep copy of its arguments); `render` returns a
    black frame of the current size."""

    def __init__(self, width: int = 0, height: int = 0):
        self.stream = []
        self.width, self.height = width, height

    def __getattr__(self, name):
        if name not in STREAM:
            raise AttributeError(name)

        def call(*args):
            self.stream.append((name, copy.deepcopy(args)))
        return call

    def take(self):
        out, self.stream = self.stream, []
        return out

    def render(self, view_2d, view_3d, mode):
        self.stream.append(("render", copy.deepcopy((view_2d, view_3d, mode))))
        return np.zeros((self.height, self.width, 4), np.uint8)

    def resize(self, width, height, scale=1.0):
        self.width, self.height = int(width * scale), int(height * scale)
        self.stream.append(("resize", (width, height, scale)))

    @classmethod
    def from_window_handle(cls, window, width=None, height=None, scale=None, settings=None):
        backend = cls()
        w, h = window.inner_size()
        backend.resize(int(width if width is not None else w),
                       int(height if height is not None else h),
                       float(scale if scale is not None else window.scale_factor()))
        return backend


def sync_full(scene, backend) -> None:
    """Re-trigger every change feed of `scene`, then drain it into
    `backend` (the pump is consuming, so a second backend needs a full
    re-trigger): `tests/test_reference_backend.py::sync_full`."""
    scene.meshes_3d.trigger_changed_all()
    scene.meshes_2d.trigger_changed_all()
    for il in scene.instances_2d.values():
        il.changed[il.active] = True
        il.any_changed = bool(il.active.any())
    scene.materials.materials.trigger_changed_all()
    scene.materials.textures.trigger_changed_all()
    scene._instances_changed = True
    scene.lights.point.trigger_changed_all()
    scene.lights.spot.trigger_changed_all()
    scene.lights.directional.trigger_changed_all()
    scene.lights.area_changed = True
    scene.skybox.trigger_changed()
    scene.skins.trigger_changed_all()
    scene.synchronize(backend)


def _pkg_of(x) -> str:
    return type(x).__module__.split(".")[0]


def same(ref, got, path: str = "value", _seen=None) -> None:
    """Assert that `got` (made by the port) equals `ref` (made by rfw_tpu,
    or by the port again) bit for bit: arrays by dtype, shape and `np.array_equal` (NaNs equal),
    objects of either package by class name and then field by field (their
    `__dict__`, or `__slots__`), containers element by element, enum members
    by name, anything else by `==`."""
    seen = set() if _seen is None else _seen
    key = (id(ref), id(got))
    if key in seen:
        return
    seen.add(key)
    if isinstance(ref, np.ndarray) or isinstance(got, np.ndarray):
        assert isinstance(ref, np.ndarray) and isinstance(got, np.ndarray), \
            f"{path}: {type(ref)} vs {type(got)}"
        assert ref.dtype == got.dtype and ref.shape == got.shape, \
            f"{path}: {ref.dtype}{ref.shape} vs {got.dtype}{got.shape}"
        assert np.array_equal(ref, got, equal_nan=ref.dtype.kind in "fc"), f"{path} differs"
        return
    if isinstance(ref, enum.Enum):
        assert isinstance(got, enum.Enum) and type(ref).__name__ == type(got).__name__ \
            and ref.name == got.name, f"{path}: {ref} vs {got}"
        return
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(ref) == list(got), \
            f"{path}: keys {list(ref)} vs {list(got)}"
        for k in ref:
            same(ref[k], got[k], f"{path}[{k!r}]", seen)
        return
    if isinstance(ref, (list, tuple, set, frozenset)) and type(ref).__module__ == "builtins":
        assert type(ref) is type(got) and len(ref) == len(got), f"{path}: {ref!r} vs {got!r}"
        a, b = (sorted(ref), sorted(got)) if isinstance(ref, (set, frozenset)) else (ref, got)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]", seen)
        return
    if _pkg_of(ref) in ("rfw_tpu", "rfw_tpu_torch"):
        assert _pkg_of(got) in ("rfw_tpu", "rfw_tpu_torch"), f"{path}: {type(ref)} vs {type(got)}"
        assert type(ref).__name__ == type(got).__name__, f"{path}: {type(ref)} vs {type(got)}"
        if isinstance(ref, tuple):  # NamedTuple
            for f in ref._fields:
                same(getattr(ref, f), getattr(got, f), f"{path}.{f}", seen)
            return
        names = list(getattr(ref, "__dict__", {}))
        for cls in type(ref).__mro__:
            names += [n for n in getattr(cls, "__slots__", ()) if n not in names]
        for n in names:
            same(getattr(ref, n), getattr(got, n), f"{path}.{n}", seen)
        return
    assert type(ref) is type(got) and ref == got, f"{path}: {ref!r} vs {got!r}"


def same_stream(ref, got) -> None:
    """Two recorded streams: the same calls, in the same order, with the
    same arguments (`same`)."""
    assert [c[0] for c in ref] == [c[0] for c in got], \
        ([c[0] for c in ref], [c[0] for c in got])
    for i, (a, b) in enumerate(zip(ref, got)):
        same(a[1:], b[1:], f"call {i} {a[0]}")


def _png(rgba: np.ndarray) -> str:
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(rgba).save(out, format="PNG")
    return "data:image/png;base64," + base64.b64encode(out.getvalue()).decode()


def gltf_doc(images: bool = True) -> dict:
    """A small glTF document: a ribbon (10 vertices, 8 triangles) skinned
    to two joints, with a morph target (position and normal deltas) and
    default weights, its positions and normals interleaved in one strided
    buffer view; an animation of the tip joint's rotation (LINEAR), the
    root's translation (STEP) and the morph weight; a floor quad textured
    by two embedded PNGs (baseColor and metallic-roughness; PIL encodes
    them), or with `images=False` by none."""
    f32 = np.float32
    ys = np.linspace(0, 2, 5, dtype=f32)
    pos = np.array([[x, y, 0] for y in ys for x in (-0.5, 0.5)], f32)
    nrm = np.tile(np.array([0, 0, 1], f32), (10, 1))
    uv = np.stack([pos[:, 0] + 0.5, pos[:, 1] / 2], -1).astype(f32)
    idx = np.array([[2 * i, 2 * i + 1, 2 * i + 3, 2 * i, 2 * i + 3, 2 * i + 2]
                    for i in range(4)], np.uint16).reshape(-1)
    joints = np.tile(np.array([0, 1, 0, 0], np.uint8), (10, 1))
    w1 = np.clip(pos[:, 1] - 0.5, 0, 1)
    weights = np.stack([1 - w1, w1, np.zeros(10, f32), np.zeros(10, f32)], -1).astype(f32)
    d_pos = np.stack([np.zeros(10), np.zeros(10), 0.3 * pos[:, 1]], -1).astype(f32)
    d_nrm = np.tile(np.array([0.2, 0, 0], f32), (10, 1))
    ibm = np.stack([np.eye(4, dtype=f32), np.eye(4, dtype=f32)])
    ibm[1, 1, 3] = -1.0  # the tip joint sits at y = 1
    times = np.array([0.0, 1.0], f32)
    s = np.sin(np.pi / 6)
    rot = np.array([[0, 0, 0, 1], [0, 0, s, np.cos(np.pi / 6)]], f32)
    step = np.array([[0, 0, 0], [0.2, 0, 0]], f32)
    mw = np.array([[0.0], [1.0]], f32)
    qpos = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], f32)
    quv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], f32)
    qidx = np.array([0, 2, 1, 0, 3, 2], np.uint16)

    chunks, views, accessors = [], [], []
    off = 0

    def view(raw: bytes, stride=None):
        nonlocal off
        v = {"buffer": 0, "byteOffset": off, "byteLength": len(raw)}
        if stride:
            v["byteStride"] = stride
        views.append(v)
        pad = (-len(raw)) % 4
        chunks.append(raw + b"\0" * pad)
        off += len(raw) + pad
        return len(views) - 1

    def acc(arr, type_, ctype, bv=None, byte_offset=0, count=None):
        if bv is None:
            bv = view(np.ascontiguousarray(arr).tobytes())
        a = {"bufferView": bv, "componentType": ctype, "count": count or len(arr),
             "type": type_}
        if byte_offset:
            a["byteOffset"] = byte_offset
        accessors.append(a)
        return len(accessors) - 1

    inter = view(np.concatenate([pos, nrm], 1).tobytes(), stride=24)  # strided
    a_pos = acc(None, "VEC3", 5126, bv=inter, count=10)
    a_nrm = acc(None, "VEC3", 5126, bv=inter, byte_offset=12, count=10)
    prim_ribbon = {
        "attributes": {"POSITION": a_pos, "NORMAL": a_nrm,
                       "TEXCOORD_0": acc(uv, "VEC2", 5126),
                       "JOINTS_0": acc(joints, "VEC4", 5121),
                       "WEIGHTS_0": acc(weights, "VEC4", 5126)},
        "indices": acc(idx, "SCALAR", 5123),
        "material": 1,
        "targets": [{"POSITION": acc(d_pos, "VEC3", 5126),
                     "NORMAL": acc(d_nrm, "VEC3", 5126)}],
    }
    prim_quad = {
        "attributes": {"POSITION": acc(qpos, "VEC3", 5126),
                       "TEXCOORD_0": acc(quv, "VEC2", 5126)},
        "indices": acc(qidx, "SCALAR", 5123),
        "material": 0,
    }
    a_ibm = acc(ibm.transpose(0, 2, 1).reshape(2, 16), "MAT4", 5126)  # column-major
    a_t = acc(times, "SCALAR", 5126)
    samplers = [
        {"input": a_t, "output": acc(rot, "VEC4", 5126), "interpolation": "LINEAR"},
        {"input": a_t, "output": acc(step, "VEC3", 5126), "interpolation": "STEP"},
        {"input": a_t, "output": acc(mw, "SCALAR", 5126)},
    ]
    buf = b"".join(chunks)
    floor = {"name": "floor", "pbrMetallicRoughness": {
        "baseColorFactor": [0.7, 0.75, 0.8, 1], "metallicFactor": 0.1, "roughnessFactor": 0.8}}
    textured = {}
    if images:
        checker = ((np.indices((16, 16)).sum(0) // 4) % 2 * 200 + 30).astype(np.uint8)
        tex_a = np.stack([checker, checker // 2, 255 - checker, np.full_like(checker, 255)], -1)
        tex_b = np.zeros((8, 8, 4), np.uint8)
        tex_b[..., 1] = np.arange(8, dtype=np.uint8)[:, None] * 30
        tex_b[..., 3] = 255
        textured = {"images": [{"uri": _png(tex_a)}, {"uri": _png(tex_b)}],
                    "textures": [{"source": 0}, {"source": 1}]}
        floor["pbrMetallicRoughness"].update(baseColorTexture={"index": 0},
                                             metallicRoughnessTexture={"index": 1})
    return {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode(), "byteLength": len(buf)}],
        "bufferViews": views,
        "accessors": accessors,
        **textured,
        "materials": [
            floor,
            {"name": "ribbon", "pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.5, 0.2, 1], "metallicFactor": 0.0},
             "doubleSided": True},
        ],
        "meshes": [{"name": "ribbon", "weights": [0.5], "primitives": [prim_ribbon]},
                   {"name": "floor", "primitives": [prim_quad]}],
        "skins": [{"name": "bones", "joints": [0, 1], "inverseBindMatrices": a_ibm}],
        "nodes": [
            {"name": "root", "children": [1]},
            {"name": "tip", "translation": [0, 1, 0]},
            {"name": "ribbon", "mesh": 0, "skin": 0},
            {"name": "floor", "mesh": 1, "translation": [0, -0.01, 0]},
        ],
        "animations": [{"name": "bend", "samplers": samplers, "channels": [
            {"sampler": 0, "target": {"node": 1, "path": "rotation"}},
            {"sampler": 1, "target": {"node": 0, "path": "translation"}},
            {"sampler": 2, "target": {"node": 2, "path": "weights"}},
        ]}],
        "scenes": [{"nodes": [0, 2, 3]}],
        "scene": 0,
    }


def bench_gltf_doc() -> dict:
    """`gltf_doc()` (textured) with a parent node that is not the identity
    (rotated, scaled, moved) over a second instance of the floor mesh, so
    the floor mesh is instanced twice: the scene the benchmark's glTF path
    packs in the tests."""
    doc = gltf_doc(images=True)
    s, c = np.sin(np.pi / 8), np.cos(np.pi / 8)
    doc["nodes"] += [
        {"name": "group", "translation": [0.5, 0.25, -0.3], "rotation": [0, s, 0, c],
         "scale": [0.6, 0.6, 0.6], "children": [5]},
        {"name": "floor again", "mesh": 1, "translation": [0, 1.5, 0]},
    ]
    doc["scenes"][0]["nodes"].append(4)
    return doc


@contextlib.contextmanager
def reference_bench(gltf_path: str):
    """The repository's bench.py as a module, its PICA at `gltf_path` and
    RFW_NO_NATIVE=1 (both packages' numpy BVH builders) inside the block.
    Importing bench.py sets JAX_COMPILATION_CACHE_DIR; the environment is
    restored at once, and PICA and RFW_NO_NATIVE on leaving."""
    import os
    import sys

    import pytest

    mp = pytest.MonkeyPatch()
    env = dict(os.environ)
    mp.syspath_prepend(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        bench = importlib.import_module("bench")
    finally:
        os.environ.clear()
        os.environ.update(env)
    assert bench.__file__ == os.path.join(sys.path[0], "bench.py"), bench.__file__
    mp.setattr(bench, "PICA", gltf_path)
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        yield bench
    finally:
        mp.undo()


def _port_class(x):
    mod = importlib.import_module(type(x).__module__.replace("rfw_tpu.", "rfw_tpu_torch.", 1))
    return getattr(mod, type(x).__name__)


def to_port(x):
    """rfw_tpu views (dataclasses of rfw_tpu.backend.*) and RenderMode
    members, alone or inside lists and tuples, rebuilt as the port's class
    of the same name (views from their fields, members by name); anything
    else as it is."""
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(e) for e in x)
    if isinstance(x, enum.Enum):
        return _port_class(x)[x.name]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _port_class(x)(**{f.name: getattr(x, f.name) for f in dataclasses.fields(x)})
    return x


def replay(stream, backend, port: bool = False):
    """Call `backend` with the recorded calls, in order."""
    for name, args in stream:
        getattr(backend, name)(*(to_port(args) if port else args))


def build(pkg: str, seed: int = 0, n_inst: int = 3, quality: int = 1,
          with_tex: bool = True):
    """Returns (TraceScene, DeviceMaterials, DeviceLights, TextureAtlas,
    Camera3D), all host numpy, from package `pkg`."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    prim = mod("models.primitives")
    materials = mod("scene.materials")
    mathx = mod("mathx")
    lights_view = mod("backend.lights")

    rng = np.random.default_rng(seed)
    mats = materials.Materials()
    checker = ((np.indices((64, 64)).sum(0) // 8) % 2 * 180 + 50).astype(np.uint8)
    tex = mats.push_texture(materials.Texture.from_array(checker))
    floor_m = mats.push(materials.Material(
        name="floor", color=np.array([0.8, 0.8, 0.8, 1], np.float32),
        diffuse_tex=tex if with_tex else -1))
    sphere_mats = [
        mats.push(materials.Material(
            name="metal", color=np.array([0.9, 0.6, 0.3, 1], np.float32),
            metallic=1.0, roughness=0.3)),
        mats.push(materials.Material(
            name="clearcoat", color=np.array([0.2, 0.3, 0.8, 1], np.float32),
            clearcoat=1.0, clearcoat_gloss=0.8, roughness=0.4)),
        mats.push(materials.Material(
            name="glass", color=np.array([0.95, 0.95, 1, 1], np.float32),
            transmission=1.0, roughness=0.05, eta=1.5)),
    ]
    emit = mats.push(materials.Material(
        name="emit", color=np.array([6, 5.5, 5, 1], np.float32)))

    meshes, instances = [], []
    for k, mid in enumerate(sphere_mats):
        meshes.append((k, prim.sphere(quality=quality, material_id=mid), None))
        ms = []
        for _ in range(n_inst):
            t = rng.uniform([-3, 0.5, -3], [3, 1.5, 3]).astype(np.float32)
            s = np.full(3, rng.uniform(0.4, 0.8), np.float32)
            ms.append(mathx.compose_trs(t, mathx.quat_identity(), s))
        instances.append((k, np.stack(ms)))
    floor = prim.quad3d(normal=(0, 1, 0), position=(0, 0, 0), width=10,
                        height=10, material_id=floor_m)
    meshes.append((3, floor, None))
    instances.append((3, np.eye(4, dtype=np.float32)[None]))
    lamp = prim.quad3d(normal=(0, -1, 0), position=(0, 4, 0), width=1.5,
                       height=1.5, material_id=emit)
    flags, emission = mats.light_flags(), mats.emission_table()
    area, light_id = mod("scene.lights").extract_area_lights(
        flags[lamp.tri_material], emission[lamp.tri_material],
        lamp.tri_vertices(), np.eye(4, dtype=np.float32)[None], 4,
        np.array([len(instances)]))
    lamp.tri_light[:] = light_id
    meshes.append((4, lamp, None))
    instances.append((4, np.eye(4, dtype=np.float32)[None]))

    scene = mod("render.pack").pack_trace_scene(meshes, instances)
    d = np.array([-0.3, -1, -0.3], np.float32)
    spot = lights_view.SpotLightsView(
        position=np.array([[2, 5, 2]], np.float32),
        direction=(d / np.linalg.norm(d))[None],
        energy=np.array([[30, 28, 25]], np.float32),
        cos_inner=np.array([np.cos(np.deg2rad(25))], np.float32),
        cos_outer=np.array([np.cos(np.deg2rad(40))], np.float32),
        changed=np.ones(1, bool))
    sun = lights_view.DirectionalLightsView(
        direction=np.array([[0.4, -0.8, 0.3]], np.float32),
        energy=np.array([[1.0, 0.95, 0.9]], np.float32),
        changed=np.ones(1, bool))
    lights = mod("render.lights_pack").pack_lights(
        lights_view.PointLightsView.empty(), spot, sun, area)
    atlas = mod("render.atlas").pack_atlas([t for _, t in mats.textures])
    camera = mod("scene.camera").Camera3D(fov=55).look_at(
        np.array([5, 4, 7], np.float32), np.array([0, 0.8, 0], np.float32))
    return scene, mats.to_device(), lights, atlas, camera


def world_triangles(scene):
    """World-space (v0, e1, e2) of every instanced triangle slot, with the
    arena index of each, for the brute-force oracle."""
    v0s, e1s, e2s, ids = [], [], [], []
    for i in range(scene.inst_matrix.shape[0]):
        if scene.inst_mesh[i] < 0:
            continue
        m = scene.inst_matrix[i]
        sel = np.nonzero(scene.tri_mesh == scene.inst_mesh[i])[0]
        v0s.append(scene.tri_v0[sel] @ m[:3, :3].T + m[:3, 3])
        e1s.append(scene.tri_e1[sel] @ m[:3, :3].T)
        e2s.append(scene.tri_e2[sel] @ m[:3, :3].T)
        ids.append(sel)
    cat = lambda xs: np.concatenate(xs).astype(np.float32)  # noqa: E731
    return cat(v0s), cat(e1s), cat(e2s), np.concatenate(ids).astype(np.int32)


def probe_rays(n: int, seed: int):
    """Seeded rays from above the floor towards the sphere band."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    target = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    target[:, 1] = rng.uniform(0, 2, n)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def unique_closest(scene, o, d):
    """Per ray, whether its closest hit's t is unique in `scene`: the
    brute-force second hit lies more than 1e-6 relative beyond the first
    (False for a miss). Exact-t ties may resolve either way in two walks."""
    v0, e1, e2, _ = world_triangles(scene)
    pv = np.cross(d[:, None], e2[None])
    det = np.sum(e1[None] * pv, -1)
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tv = o[:, None] - v0[None]
    u = np.sum(tv * pv, -1) * inv
    q = np.cross(tv, e1[None])
    v = np.sum(d[:, None] * q, -1) * inv
    t = np.sum(e2[None] * q, -1) * inv
    t = np.where((np.abs(det) > 1e-12) & (u >= -1e-7) & (v >= -1e-7) & (u + v <= 1 + 1e-7)
                 & (t > 1e-5), t, np.inf)
    ts = np.sort(t, axis=1)
    with np.errstate(invalid="ignore"):
        return ts[:, 1] - ts[:, 0] > 1e-6 * ts[:, 0]


@contextlib.contextmanager
def one_torch_thread():
    """Run torch single-threaded inside the block. The plain walks issue
    hundreds of small ops a step; when the suite's parallel workers share
    the cores, torch's per-op thread pools oversubscribe them and each op
    waits on its pool (a 1 s render took minutes)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
