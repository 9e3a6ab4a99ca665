"""The benchmark's scene description and the geometry its generators use.

A configuration's generator (`configs/<name>.py`) returns a `SceneSpec`:
plain numpy arrays of meshes, instances, materials, textures, lights and
the camera, made from the seed. Both sides read the same spec: the harness
hands it to the program through the Backend contract's input types
(`feed`), and the plain reference (`reference.py`) works from the arrays
themselves. Nothing here imports the program at module level; `feed`
imports the contract's dataclasses when it is called.

The primitives are this folder's own copies of the icosphere, box and quad
of `rfw_tpu_torch/models/primitives.py` and the tangent and mip rules of
`models/mesh3d.py` and `scene/materials.py`, so that a later edit there
does not move the yardstick.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

#: column order of `SceneSpec.params` (the contract's MATERIAL_PARAM_NAMES)
PARAM_NAMES = (
    "metallic", "subsurface", "specular_f", "roughness",
    "specular_tint", "anisotropic", "sheen", "sheen_tint",
    "clearcoat", "clearcoat_gloss", "transmission", "eta",
    "custom0", "custom1", "custom2", "custom3",
)
#: a material's parameters where the configuration names none
PARAM_DEFAULTS = dict(specular_f=0.5, roughness=0.5, clearcoat_gloss=1.0, eta=1.45)


@dataclass
class Mesh:
    positions: np.ndarray  # (V,3) f32
    normals: np.ndarray  # (V,3) f32
    uvs: np.ndarray  # (V,2) f32
    tangents: np.ndarray  # (V,4) f32, w = handedness
    indices: np.ndarray  # (T,3) i32
    tri_material: np.ndarray  # (T,) i32
    tri_light: np.ndarray  # (T,) i32, area-light id or -1
    name: str = ""

    @property
    def aabb_min(self) -> np.ndarray:
        return self.positions.min(axis=0).astype(np.float32)

    @property
    def aabb_max(self) -> np.ndarray:
        return self.positions.max(axis=0).astype(np.float32)


@dataclass
class SceneSpec:
    width: int
    height: int
    settings: Dict  # TorchSettings fields the configuration sets
    meshes: List[Mesh]  # mesh slot = list index
    instances: List[np.ndarray]  # per slot, (I,4,4) f32 world matrices
    color: np.ndarray  # (M,4) f32 material color (rgb > 1 marks an emitter)
    params: np.ndarray  # (M,16) f32, PARAM_NAMES
    tex: np.ndarray  # (M,6) i32 texture ids (diffuse, normal, mr, emissive, ...)
    textures: List[List[np.ndarray]]  # per texture id, its mips (h,w,4) u8
    texture_srgb: List[bool]
    spot: Dict[str, np.ndarray]  # position, direction, energy, cos_inner, cos_outer
    sun: Dict[str, np.ndarray]  # direction, energy
    area: Dict[str, np.ndarray]  # v0, v1, v2, normal, radiance, area
    view: np.ndarray  # (24,) f32 camera vector (CameraView3D.as_array's layout)
    moving: List[int] = field(default_factory=list)  # slots a traffic may move

    @property
    def n_instances(self) -> int:
        return sum(m.shape[0] for m in self.instances)


# ------------------------------------------------------------------ helpers
def normalize(v: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), eps)


def translate_scale(t: np.ndarray, s: np.ndarray) -> np.ndarray:
    """(n,4,4) f32 matrices T·S of translations (n,3) and uniform scales (n,)."""
    m = np.zeros((t.shape[0], 4, 4), np.float32)
    m[:, 0, 0] = m[:, 1, 1] = m[:, 2, 2] = s
    m[:, :3, 3] = t
    m[:, 3, 3] = 1.0
    return m


def shuffled(instances: List[np.ndarray], seed: int) -> List[np.ndarray]:
    """Each slot's instance matrices in an order drawn from the seed: the
    same set of instances, so the same picture and the same work."""
    rng = np.random.default_rng(seed)
    return [m[rng.permutation(len(m))] for m in instances]


def material_table(mats: List[Dict]):
    """(color, params, tex) of a configuration's material list: each entry
    names `color` and any of PARAM_NAMES, and `diffuse_tex` for a texture."""
    n = len(mats)
    color = np.zeros((n, 4), np.float32)
    params = np.zeros((n, 16), np.float32)
    tex = np.full((n, 6), -1, np.int32)
    for i, m in enumerate(mats):
        color[i] = m["color"]
        for j, k in enumerate(PARAM_NAMES):
            params[i, j] = m.get(k, PARAM_DEFAULTS.get(k, 0.0))
        tex[i, 0] = m.get("diffuse_tex", -1)
    return color, params, tex


def generate_mips(base: np.ndarray) -> List[np.ndarray]:
    """Box-filter mip chain of an RGBA8 image down to 1x1."""
    mips = [base]
    cur = base.astype(np.float32)
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w = cur.shape[:2]
        if h > 1:
            cur = 0.5 * (cur[0:2 * (h // 2):2] + cur[1:2 * (h // 2):2])
        if w > 1:
            cur = 0.5 * (cur[:, 0:2 * (w // 2):2] + cur[:, 1:2 * (w // 2):2])
        mips.append(np.clip(cur + 0.5, 0, 255).astype(np.uint8))
    return mips


def checker(size: int, cell: int) -> np.ndarray:
    """A grey RGBA8 checkerboard."""
    g = ((np.indices((size, size)).sum(0) // cell) % 2 * 170 + 60).astype(np.uint8)
    return np.stack([g, g, g, np.full_like(g, 255)], axis=-1)


def _tangents(positions, normals, uvs, indices) -> np.ndarray:
    """Per-vertex tangents from UV gradients, Gram-Schmidt against the
    normal, handedness in w."""
    v = positions[indices]
    t = uvs[indices]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    du1 = t[:, 1, 0] - t[:, 0, 0]
    dv1 = t[:, 1, 1] - t[:, 0, 1]
    du2 = t[:, 2, 0] - t[:, 0, 0]
    dv2 = t[:, 2, 1] - t[:, 0, 1]
    det = du1 * dv2 - du2 * dv1
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1.0, det), 0.0)[:, None]
    tan = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r
    bitan = (e2 * du1[:, None] - e1 * du2[:, None]) * r
    acc_t = np.zeros_like(positions)
    acc_b = np.zeros_like(positions)
    for k in range(3):
        np.add.at(acc_t, indices[:, k], tan)
        np.add.at(acc_b, indices[:, k], bitan)
    t_ortho = acc_t - normals * np.sum(normals * acc_t, axis=-1, keepdims=True)
    tlen = np.linalg.norm(t_ortho, axis=-1, keepdims=True)
    fallback = np.cross(normals, np.where(np.abs(normals[:, 2:3]) < 0.9,
                                          np.array([0, 0, 1], np.float32),
                                          np.array([1, 0, 0], np.float32)))
    t_ortho = np.where(tlen > 1e-8, t_ortho / np.maximum(tlen, 1e-12), fallback)
    handed = np.where(np.sum(np.cross(normals, t_ortho) * acc_b, axis=-1) < 0.0, -1.0, 1.0)
    return np.concatenate([t_ortho, handed[:, None]], axis=-1).astype(np.float32)


def make_mesh(positions, indices, normals, uvs, material: int, name: str) -> Mesh:
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    normals = np.ascontiguousarray(normals, np.float32)
    uvs = np.ascontiguousarray(uvs, np.float32)
    nt = indices.shape[0]
    return Mesh(positions, normals, uvs, _tangents(positions, normals, uvs, indices),
                indices, np.full(nt, material, np.int32), np.full(nt, -1, np.int32), name)


_T = (1.0 + np.sqrt(5.0)) / 2.0
_ICOSA_VERTS = np.array(
    [[-1, _T, 0], [1, _T, 0], [-1, -_T, 0], [1, -_T, 0], [0, -1, _T], [0, 1, _T],
     [0, -1, -_T], [0, 1, -_T], [_T, 0, -1], [_T, 0, 1], [-_T, 0, -1], [-_T, 0, 1]],
    np.float32)
_ICOSA_FACES = np.array(
    [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
     [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
     [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)


def icosphere(quality: int, material: int) -> Mesh:
    """Unit icosphere of 20*4^quality triangles, spherical UVs."""
    verts = normalize(_ICOSA_VERTS)
    faces = _ICOSA_FACES
    for _ in range(quality):
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        uniq, inv = np.unique(np.sort(e, axis=1), axis=0, return_inverse=True)
        mids = normalize(0.5 * (verts[uniq[:, 0]] + verts[uniq[:, 1]]))
        mid = (verts.shape[0] + inv.reshape(-1)).reshape(3, -1).T.astype(np.int32)
        verts = np.concatenate([verts, mids])
        f0, f1, f2 = faces[:, 0], faces[:, 1], faces[:, 2]
        m01, m12, m20 = mid[:, 0], mid[:, 1], mid[:, 2]
        faces = np.concatenate([np.stack([f0, m01, m20], -1), np.stack([f1, m12, m01], -1),
                                np.stack([f2, m20, m12], -1), np.stack([m01, m12, m20], -1)])
    n = verts.astype(np.float32)
    uv = np.stack([0.5 + np.arctan2(n[:, 2], n[:, 0]) / (2 * np.pi),
                   0.5 - np.arcsin(np.clip(n[:, 1], -1, 1)) / np.pi], axis=-1)
    return make_mesh(n, faces, n, uv, material, "sphere")


def box(center, size, material: int) -> Mesh:
    """Axis-aligned box with face normals."""
    c = np.asarray(center, np.float32)
    h = 0.5 * np.asarray(size, np.float32)
    faces = [((1, 0, 0), (0, 1, 0), (0, 0, 1)), ((-1, 0, 0), (0, 1, 0), (0, 0, -1)),
             ((0, 1, 0), (0, 0, 1), (1, 0, 0)), ((0, -1, 0), (0, 0, -1), (1, 0, 0)),
             ((0, 0, 1), (0, 1, 0), (-1, 0, 0)), ((0, 0, -1), (0, 1, 0), (1, 0, 0))]
    pos, nrm, idx = [], [], []
    for f, (n, u, v) in enumerate(faces):
        n, u, v = (np.asarray(x, np.float32) for x in (n, u, v))
        o, uu, vv = c + n * h, u * h, v * h
        pos += [o - uu - vv, o + uu - vv, o + uu + vv, o - uu + vv]
        nrm += [n] * 4
        idx += [[4 * f, 4 * f + 1, 4 * f + 2], [4 * f, 4 * f + 2, 4 * f + 3]]
    uv = [[0, 1], [1, 1], [1, 0], [0, 0]] * 6
    return make_mesh(np.array(pos), np.array(idx), np.array(nrm), np.array(uv, np.float32),
                     material, "box")


def quad(normal, center, width: float, height: float, material: int) -> Mesh:
    """Two-triangle quad facing `normal`."""
    n = normalize(np.asarray(normal, np.float32))
    ref = np.array([0, 1, 0], np.float32) if abs(n[1]) < 0.9 else np.array([1, 0, 0], np.float32)
    t = normalize(np.cross(ref, n))
    b = np.cross(n, t)
    c = np.asarray(center, np.float32)
    hw, hh = width * 0.5, height * 0.5
    pos = np.stack([c - t * hw - b * hh, c + t * hw - b * hh, c + t * hw + b * hh,
                    c - t * hw + b * hh])
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    return make_mesh(pos, np.array([[0, 1, 2], [0, 2, 3]]), np.tile(n, (4, 1)), uv,
                     material, "quad")


def area_lights(mesh: Mesh, radiance: np.ndarray) -> Dict[str, np.ndarray]:
    """One area light per triangle of an emitter placed with the identity
    matrix; numbers the mesh's `tri_light` from 0."""
    v = mesh.positions[mesh.indices]
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    cr = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cr, axis=-1)
    mesh.tri_light[:] = np.arange(mesh.indices.shape[0], dtype=np.int32)
    return dict(v0=v[:, 0].astype(np.float32), v1=v[:, 1].astype(np.float32),
                v2=v[:, 2].astype(np.float32),
                normal=(cr / np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True),
                                        1e-20)).astype(np.float32),
                radiance=np.tile(np.asarray(radiance, np.float32), (len(area), 1)),
                area=area.astype(np.float32))


def camera_view(origin, target, fov_deg: float, width: int, height: int,
                aperture: float = 1e-4) -> np.ndarray:
    """The (24,) camera vector of a pinhole-like camera at `origin` looking
    at `target`: pos, right, up, p1 (top-left screen corner), direction,
    lens size, spread angle, 1/width, 1/height, near, far, aspect, fov, 0."""
    pos = np.asarray(origin, np.float32)
    z = normalize(np.asarray(target, np.float32) - pos).astype(np.float32)
    world_up = np.array([0, 1, 0], np.float32)
    x = normalize(np.cross(z, world_up))
    y = np.cross(x, z)
    aspect = width / height
    fov = np.deg2rad(fov_deg)
    half_h = float(np.tan(0.5 * fov))
    half_w = half_h * aspect
    p1 = pos + z - x * half_w + y * half_h
    right = 2.0 * half_w * x
    up = -2.0 * half_h * y
    tail = [aperture, fov / height, 1.0 / width, 1.0 / height, 0.01, 1e5, aspect, fov, 0.0]
    return np.concatenate([pos, right, up, p1, z, np.array(tail, np.float32)]).astype(np.float32)


def scene_bounds(spec: SceneSpec):
    """World AABB of every instance's mesh box: (min (3,), max (3,))."""
    mn, mx = [], []
    for mesh, mats in zip(spec.meshes, spec.instances):
        lo, hi = mesh.aabb_min, mesh.aabb_max
        corners = np.stack(np.meshgrid(*zip(lo, hi), indexing="ij"), -1).reshape(8, 3)
        w = np.einsum("iab,kb->ika", mats[:, :3, :3], corners) + mats[:, None, :3, 3]
        mn.append(w.min(axis=(0, 1)))
        mx.append(w.max(axis=(0, 1)))
    return np.min(mn, axis=0).astype(np.float32), np.max(mx, axis=0).astype(np.float32)


# ---------------------------------------------------- the Backend contract
def instances_view(spec: SceneSpec, slot: int, matrices: np.ndarray):
    from rfw_tpu_torch.backend.structs import InstancesView3D

    n = matrices.shape[0]
    mesh = spec.meshes[slot]
    return InstancesView3D(matrices=matrices, skin_ids=np.full(n, -1, np.int32),
                           changed=np.ones(n, bool), local_aabb_min=mesh.aabb_min,
                           local_aabb_max=mesh.aabb_max)


def camera(spec: SceneSpec):
    """The spec's camera vector as the contract's CameraView3D."""
    from rfw_tpu_torch.backend.structs import CameraView3D

    v = spec.view
    return CameraView3D(pos=v[0:3], right=v[3:6], up=v[6:9], p1=v[9:12], direction=v[12:15],
                        lens_size=float(v[15]), spread_angle=float(v[16]),
                        inv_width=float(v[17]), inv_height=float(v[18]),
                        near_plane=float(v[19]), far_plane=float(v[20]),
                        aspect_ratio=float(v[21]), fov=float(v[22]))


def feed(spec: SceneSpec, backend) -> None:
    """Hand the spec to a Backend through the contract's set_* calls."""
    from rfw_tpu_torch.backend.lights import (
        AreaLightsView, DirectionalLightsView, PointLightsView, SpotLightsView,
    )
    from rfw_tpu_torch.backend.structs import DeviceMaterials, MeshView3D, TextureView

    backend.set_3d_meshes([
        (i, MeshView3D(positions=m.positions, normals=m.normals, uvs=m.uvs,
                       tangents=m.tangents, indices=m.indices, tri_material=m.tri_material,
                       tri_light=m.tri_light,
                       ranges=np.array([[0, m.indices.shape[0], int(m.tri_material[0])]],
                                       np.int32),
                       aabb_min=m.aabb_min, aabb_max=m.aabb_max, name=m.name).validate())
        for i, m in enumerate(spec.meshes)])
    backend.set_3d_instances([(i, instances_view(spec, i, mats))
                              for i, mats in enumerate(spec.instances)])
    n = spec.color.shape[0]
    flags = np.where(spec.color[:, :3].max(axis=1) > 1.0, 1 << 6, 0).astype(np.int32)
    flags |= np.where(spec.tex[:, 0] >= 0, 1, 0).astype(np.int32)
    backend.set_materials(DeviceMaterials(
        color=spec.color, specular=np.full((n, 4), 0.5, np.float32),
        absorption=np.zeros((n, 4), np.float32), params=spec.params, flags=flags,
        tex=spec.tex).validate(), list(range(n)))
    backend.set_textures([(i, TextureView(mips=mips, srgb=srgb))
                          for i, (mips, srgb) in enumerate(zip(spec.textures,
                                                               spec.texture_srgb))])
    backend.set_point_lights(PointLightsView.empty())
    s = spec.spot
    backend.set_spot_lights(SpotLightsView(
        position=s["position"], direction=s["direction"], energy=s["energy"],
        cos_inner=s["cos_inner"], cos_outer=s["cos_outer"],
        changed=np.ones(len(s["position"]), bool)) if len(s["position"])
        else SpotLightsView.empty())
    backend.set_directional_lights(DirectionalLightsView(
        direction=spec.sun["direction"], energy=spec.sun["energy"],
        changed=np.ones(len(spec.sun["direction"]), bool)))
    a = spec.area
    na = len(a["area"])
    backend.set_area_lights(AreaLightsView(
        position=((a["v0"] + a["v1"] + a["v2"]) / 3.0).astype(np.float32),
        normal=a["normal"], energy=(a["radiance"] * a["area"][:, None] * np.pi).astype(np.float32),
        radiance=a["radiance"], area=a["area"], v0=a["v0"], v1=a["v1"], v2=a["v2"],
        inst_id=np.zeros(na, np.int32), mesh_id=np.zeros(na, np.int32),
        tri_id=np.arange(na, dtype=np.int32), changed=np.ones(na, bool)))
