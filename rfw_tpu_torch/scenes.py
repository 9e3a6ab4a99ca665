"""Procedural scenes at the scale of the reference's benchmark scenes.

The reference benchmarks on pica (`bench.py:6-7`: 76k triangles, 170
instances), a glTF asset that is not in the repository, so the port's
flagship-scale scene is built here from a seed instead: `build_scene`
gives 4 icosphere meshes of 20,480 triangles with 64 instances each, a
textured floor slab, an emissive quad (2 area lights), two spots and a sun
(122,880 triangle rows, 512 instance-arena rows); `build_heavy_scene`
gives the instance-heavy scene of any instance count. Both pack with the
port's own packers (the native BVH builder unless `RFW_NO_NATIVE=1`) and
return host arrays; `convert.from_numpy_scene`
carries them to the card. `chip_smoke.py` and the microbenchmarks in
`rfw_tpu_torch.tools` drive them.
"""

from __future__ import annotations

import time

import numpy as np


def build_scene(seed: int, views: bool = False):
    """Procedural scene at the flagship scale, packed by the port's own
    packers. Returns (TraceScene, DeviceMaterials, DeviceLights,
    TextureAtlas, Camera3D, pack seconds), host arrays; with views=True
    also what a backend is fed to pack the same arenas: a dict of the
    meshes and instances as `pack_trace_scene` took them, the `Materials`,
    and the spot, sun and area-light views."""
    from rfw_tpu_torch.backend.lights import (
        DirectionalLightsView, PointLightsView, SpotLightsView,
    )
    from rfw_tpu_torch.mathx import compose_trs, quat_identity
    from rfw_tpu_torch.models import cube, quad3d, sphere
    from rfw_tpu_torch.render.atlas import pack_atlas
    from rfw_tpu_torch.render.lights_pack import pack_lights
    from rfw_tpu_torch.render.pack import pack_trace_scene
    from rfw_tpu_torch.scene import Camera3D, Material, Materials, Texture
    from rfw_tpu_torch.scene.lights import extract_area_lights

    rng = np.random.default_rng(seed)
    mats = Materials()
    checker = ((np.indices((256, 256)).sum(0) // 32) % 2 * 170 + 60).astype(np.uint8)
    floor_tex = mats.push_texture(Texture.from_array(checker))
    m_floor = mats.push(Material(name="floor", color=np.array([0.8, 0.8, 0.8, 1], np.float32),
                                 roughness=0.7, diffuse_tex=floor_tex))
    sphere_mats = [
        mats.push(Material(name="diffuse", color=np.array([0.7, 0.25, 0.2, 1], np.float32),
                           roughness=0.8)),
        mats.push(Material(name="rough metal", color=np.array([0.9, 0.7, 0.4, 1], np.float32),
                           metallic=1.0, roughness=0.35)),
        mats.push(Material(name="clearcoat plastic", color=np.array([0.15, 0.3, 0.8, 1], np.float32),
                           roughness=0.5, clearcoat=1.0, clearcoat_gloss=0.9)),
        mats.push(Material(name="glass", color=np.array([0.95, 0.97, 1.0, 1], np.float32),
                           roughness=0.05, transmission=1.0, eta=1.5)),
    ]
    m_emit = mats.push(Material(name="emitter", color=np.array([9.0, 8.5, 7.5, 1], np.float32)))

    meshes, instances = [], []
    spacing = 3.0
    cells = [(i, j) for i in range(16) for j in range(16)]
    order = rng.permutation(len(cells))
    for k, mid in enumerate(sphere_mats):
        meshes.append((k, sphere(quality=5, material_id=mid), None))
        mk = []
        for c in order[64 * k:64 * (k + 1)]:
            i, j = cells[c]
            r = float(rng.uniform(0.5, 1.1))
            t = np.array([(i - 7.5) * spacing + rng.uniform(-0.6, 0.6), r,
                          (j - 7.5) * spacing + rng.uniform(-0.6, 0.6)], np.float32)
            mk.append(compose_trs(t, quat_identity(), np.full(3, r, np.float32)))
        instances.append((k, np.stack(mk)))
    half = 8 * spacing + 2.0
    floor = cube(position=(0.0, -0.1, 0.0), size=(2 * half, 0.2, 2 * half), material_id=m_floor)
    meshes.append((4, floor, None))
    instances.append((4, np.eye(4, dtype=np.float32)[None]))
    lamp = quad3d(normal=(0.0, -1.0, 0.0), position=(0.0, 9.0, 0.0), width=6.0, height=6.0,
                  material_id=m_emit)
    flags, emission = mats.light_flags(), mats.emission_table()
    area, light_id = extract_area_lights(
        flags[lamp.tri_material], emission[lamp.tri_material], lamp.tri_vertices(),
        np.eye(4, dtype=np.float32)[None], 5, np.array([257]))
    lamp.tri_light[:] = light_id
    meshes.append((5, lamp, None))
    instances.append((5, np.eye(4, dtype=np.float32)[None]))

    t0 = time.perf_counter()
    scene = pack_trace_scene(meshes, instances)
    pack_s = time.perf_counter() - t0

    mn, mx = scene.tlas_min[0], scene.tlas_max[0]
    center = 0.5 * (mn + mx)
    ext = float(np.linalg.norm(mx - mn))
    spot = SpotLightsView(
        position=np.array([center + [0, ext * 0.4, 0],
                           center + [ext * 0.2, ext * 0.3, ext * 0.2]], np.float32),
        direction=np.array([[0, -1, 0], [-0.4, -0.8, -0.4]], np.float32),
        energy=np.array([[80, 78, 70], [40, 40, 48]], np.float32) * ext,
        cos_inner=np.array([np.cos(np.deg2rad(25))] * 2, np.float32),
        cos_outer=np.array([np.cos(np.deg2rad(40))] * 2, np.float32),
        changed=np.ones(2, bool),
    )
    sun = DirectionalLightsView(
        direction=np.array([[0.4, -0.8, 0.3]], np.float32),
        energy=np.array([[3.0, 2.9, 2.6]], np.float32),
        changed=np.ones(1, bool),
    )
    lights = pack_lights(PointLightsView.empty(), spot, sun, area)
    camera = Camera3D(fov=55).look_at(
        center + np.array([0.55, 0.35, 0.75], np.float32) * ext * 0.62, center)
    atlas = pack_atlas([t for _, t in mats.textures])
    out = (scene, mats.to_device(), lights, atlas, camera, pack_s)
    if views:
        return out + (dict(meshes=meshes, instances=instances, materials=mats, spot=spot,
                           sun=sun, area=area),)
    return out


def build_heavy_scene(seed: int, n_inst: int, views: bool = False):
    """An instance-heavy scene: n_inst instances on a square field, a mix
    of 20,480-triangle spheres (their BLAS walk) and small meshes whose
    treelet span is at most 64 (icospheres of quality 1 and 2, cubes: the
    dense items tier), a floor, an area lamp and a sun; packed by the
    port's own packers. Returns build_scene's first five parts; with
    views=True also a dict of the meshes and instances as
    `pack_trace_scene` took them, the `Materials`, and the sun and
    area-light views."""
    from rfw_tpu_torch.backend.lights import (
        DirectionalLightsView, PointLightsView, SpotLightsView,
    )
    from rfw_tpu_torch.mathx import compose_trs, quat_identity
    from rfw_tpu_torch.models import cube, quad3d, sphere
    from rfw_tpu_torch.render.atlas import pack_atlas
    from rfw_tpu_torch.render.lights_pack import pack_lights
    from rfw_tpu_torch.render.pack import pack_trace_scene
    from rfw_tpu_torch.scene import Camera3D, Material, Materials
    from rfw_tpu_torch.scene.lights import extract_area_lights

    rng = np.random.default_rng(seed)
    mats = Materials()
    m_floor = mats.push(Material(name="floor", color=np.array([0.6, 0.6, 0.6, 1], np.float32),
                                 roughness=0.8))
    kinds = [(sphere(quality=5, material_id=mats.push(Material(
                 name="metal", color=np.array([0.9, 0.7, 0.4, 1], np.float32),
                 metallic=1.0, roughness=0.3))), 0.15),
             (sphere(quality=2, material_id=mats.push(Material(
                 name="red", color=np.array([0.7, 0.2, 0.15, 1], np.float32),
                 roughness=0.7))), 0.35),
             (sphere(quality=1, material_id=mats.push(Material(
                 name="blue", color=np.array([0.15, 0.3, 0.8, 1], np.float32),
                 roughness=0.5, clearcoat=1.0))), 0.25),
             (cube(material_id=mats.push(Material(
                 name="white", color=np.array([0.8, 0.8, 0.75, 1], np.float32),
                 roughness=0.6))), 0.25)]
    m_emit = mats.push(Material(name="emitter", color=np.array([9.0, 8.5, 7.5, 1], np.float32)))

    side = int(np.ceil(np.sqrt(n_inst)))
    spacing = 2.0
    cells = rng.permutation(side * side)[:n_inst]
    kind_of = rng.choice(len(kinds), n_inst, p=[p for _, p in kinds])
    meshes, instances = [], []
    for k, (mesh, _) in enumerate(kinds):
        sel = cells[kind_of == k]
        r = rng.uniform(0.3, 0.8, sel.shape[0]).astype(np.float32)
        t = np.stack([(sel % side - side / 2) * spacing + rng.uniform(-0.4, 0.4, sel.shape[0]),
                      r, (sel // side - side / 2) * spacing
                      + rng.uniform(-0.4, 0.4, sel.shape[0])], 1).astype(np.float32)
        meshes.append((k, mesh, None))
        instances.append((k, np.stack([compose_trs(t[i], quat_identity(), np.full(3, r[i], np.float32))
                                       for i in range(sel.shape[0])])))
    half = side * spacing / 2 + 2.0
    meshes.append((4, cube(position=(0.0, -0.1, 0.0), size=(2 * half, 0.2, 2 * half),
                           material_id=m_floor), None))
    instances.append((4, np.eye(4, dtype=np.float32)[None]))
    lamp = quad3d(normal=(0.0, -1.0, 0.0), position=(0.0, 30.0, 0.0), width=30.0, height=30.0,
                  material_id=m_emit)
    flags, emission = mats.light_flags(), mats.emission_table()
    area, light_id = extract_area_lights(
        flags[lamp.tri_material], emission[lamp.tri_material], lamp.tri_vertices(),
        np.eye(4, dtype=np.float32)[None], 5, np.array([n_inst + 1]))
    lamp.tri_light[:] = light_id
    meshes.append((5, lamp, None))
    instances.append((5, np.eye(4, dtype=np.float32)[None]))
    scene = pack_trace_scene(meshes, instances)
    sun = DirectionalLightsView(
        direction=np.array([[0.3, -0.8, 0.4]], np.float32),
        energy=np.array([[3.0, 2.9, 2.6]], np.float32), changed=np.ones(1, bool))
    lights = pack_lights(PointLightsView.empty(), SpotLightsView.empty(), sun, area)
    camera = Camera3D(fov=60).look_at(np.array([half * 0.9, half * 0.55, half * 0.9], np.float32),
                                      np.array([0.0, 0.0, 0.0], np.float32))
    atlas = pack_atlas([t for _, t in mats.textures])
    out = (scene, mats.to_device(), lights, atlas, camera)
    if views:
        return out + (dict(meshes=meshes, instances=instances, materials=mats, sun=sun,
                           area=area),)
    return out
