"""The flagship scene from a seed: `rfw_tpu_torch/scenes.py::build_scene`'s
procedural stand-in for pica, at its scale, as this folder's own arrays."""

from __future__ import annotations

import numpy as np

from benchmark import scene as S


def build(seed: int, cfg: dict) -> S.SceneSpec:
    """The layout comes from the configuration's `layout_seed`, so that every
    seed renders the same picture and does the same work; `seed` orders
    each mesh's instances."""
    rng = np.random.default_rng(cfg["layout_seed"])
    color, params, tex = S.material_table(cfg["materials"])
    names = [m["name"] for m in cfg["materials"]]
    sphere_mats = [names.index(n) for n in ("diffuse", "rough metal", "clearcoat plastic", "glass")]
    n_per, grid, spacing = cfg["instances_per_sphere"], cfg["grid"], cfg["spacing"]
    cells = [(i, j) for i in range(grid) for j in range(grid)]
    order = rng.permutation(len(cells))
    meshes, instances = [], []
    for k, mid in enumerate(sphere_mats):
        meshes.append(S.icosphere(cfg["sphere_quality"], mid))
        ts, rs = [], []
        for c in order[n_per * k:n_per * (k + 1)]:
            i, j = cells[c]
            r = float(rng.uniform(0.5, 1.1))
            ts.append([(i - (grid - 1) / 2) * spacing + rng.uniform(-0.6, 0.6), r,
                       (j - (grid - 1) / 2) * spacing + rng.uniform(-0.6, 0.6)])
            rs.append(r)
        instances.append(S.translate_scale(np.array(ts, np.float32), np.array(rs, np.float32)))
    instances = S.shuffled(instances, seed)
    half = grid / 2 * spacing + 2.0
    meshes.append(S.box((0.0, -0.1, 0.0), (2 * half, 0.2, 2 * half), names.index("floor")))
    instances.append(np.eye(4, dtype=np.float32)[None])
    lamp = cfg["lamp"]
    emitter = names.index("emitter")
    meshes.append(S.quad((0.0, -1.0, 0.0), (0.0, lamp["height"], 0.0), lamp["size"],
                         lamp["size"], emitter))
    instances.append(np.eye(4, dtype=np.float32)[None])
    area = S.area_lights(meshes[-1], color[emitter, :3])

    W, H = cfg["width"], cfg["height"]
    spec = S.SceneSpec(
        width=W, height=H, settings=dict(cfg["settings"]), meshes=meshes, instances=instances,
        color=color, params=params, tex=tex,
        textures=[S.generate_mips(S.checker(cfg["texture"]["size"], cfg["texture"]["cell"]))],
        texture_srgb=[True], spot={}, sun={}, area=area, view=np.zeros(24, np.float32),
        moving=list(range(len(sphere_mats))))
    # lights and camera placed from the scene's bounds, as build_scene does
    mn, mx = S.scene_bounds(spec)
    center = 0.5 * (mn + mx)
    ext = float(np.linalg.norm(mx - mn))
    spec.spot = dict(
        position=np.array([center + [0, ext * 0.4, 0],
                           center + [ext * 0.2, ext * 0.3, ext * 0.2]], np.float32),
        direction=S.normalize(np.array([[0, -1, 0], [-0.4, -0.8, -0.4]], np.float32)),
        energy=np.array([[80, 78, 70], [40, 40, 48]], np.float32) * ext,
        cos_inner=np.array([np.cos(np.deg2rad(25))] * 2, np.float32),
        cos_outer=np.array([np.cos(np.deg2rad(40))] * 2, np.float32))
    spec.sun = dict(direction=S.normalize(np.array([[0.4, -0.8, 0.3]], np.float32)),
                    energy=np.array([[3.0, 2.9, 2.6]], np.float32))
    spec.view = S.camera_view(center + np.array([0.55, 0.35, 0.75], np.float32) * ext * 0.62,
                              center, 55.0, W, H)
    return spec
