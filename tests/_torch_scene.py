"""Small seeded test scene, built with either package's host API.

`build("rfw_tpu", ...)` and `build("rfw_tpu_torch", ...)` run the same
calls through the JAX package and through the port, so the tests can hold
the port's packers against the reference's, and feed one packed scene to
both renderers. The scene: three icosphere meshes (metal, clearcoat
plastic, glass) with a few seeded instances each, a checker-textured floor
quad, an emissive quad registered as two area lights, a spot light and a
sun.
"""

from __future__ import annotations

import importlib

import numpy as np


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
