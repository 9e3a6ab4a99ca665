"""The instance-heavy scene from a seed: `rfw_tpu_torch/scenes.py::
build_heavy_scene`'s field of mesh instances, as this folder's own arrays."""

from __future__ import annotations

import numpy as np

from benchmark import scene as S


def build(seed: int, cfg: dict) -> S.SceneSpec:
    """The layout comes from the configuration's `layout_seed`, so that every
    seed renders the same picture and does the same work; `seed` orders
    each kind's instances."""
    rng = np.random.default_rng(cfg["layout_seed"])
    color, params, tex = S.material_table(cfg["materials"])
    names = [m["name"] for m in cfg["materials"]]
    n_inst, spacing, kinds = cfg["n_instances"], cfg["spacing"], cfg["kinds"]
    side = int(np.ceil(np.sqrt(n_inst)))
    cells = rng.permutation(side * side)[:n_inst]
    kind_of = rng.choice(len(kinds), n_inst, p=[k["share"] for k in kinds])
    meshes, instances = [], []
    for k, kind in enumerate(kinds):
        meshes.append(S.icosphere(kind["quality"], kind["material"]) if kind["mesh"] == "sphere"
                      else S.box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), kind["material"]))
        sel = cells[kind_of == k]
        r = rng.uniform(0.3, 0.8, sel.shape[0]).astype(np.float32)
        t = np.stack([(sel % side - side / 2) * spacing + rng.uniform(-0.4, 0.4, sel.shape[0]), r,
                      (sel // side - side / 2) * spacing + rng.uniform(-0.4, 0.4, sel.shape[0])],
                     1).astype(np.float32)
        instances.append(S.translate_scale(t, r))
    instances = S.shuffled(instances, seed)
    half = side * spacing / 2 + 2.0
    meshes.append(S.box((0.0, -0.1, 0.0), (2 * half, 0.2, 2 * half), names.index("floor")))
    instances.append(np.eye(4, dtype=np.float32)[None])
    lamp = cfg["lamp"]
    emitter = names.index("emitter")
    meshes.append(S.quad((0.0, -1.0, 0.0), (0.0, lamp["height"], 0.0), lamp["size"],
                         lamp["size"], emitter))
    instances.append(np.eye(4, dtype=np.float32)[None])
    W, H = cfg["width"], cfg["height"]
    return S.SceneSpec(
        width=W, height=H, settings=dict(cfg["settings"]), meshes=meshes, instances=instances,
        color=color, params=params, tex=tex, textures=[], texture_srgb=[],
        spot=dict(position=np.zeros((0, 3), np.float32), direction=np.zeros((0, 3), np.float32),
                  energy=np.zeros((0, 3), np.float32), cos_inner=np.zeros(0, np.float32),
                  cos_outer=np.zeros(0, np.float32)),
        sun=dict(direction=S.normalize(np.array([[0.3, -0.8, 0.4]], np.float32)),
                 energy=np.array([[3.0, 2.9, 2.6]], np.float32)),
        area=S.area_lights(meshes[-1], color[emitter, :3]),
        view=S.camera_view(np.array([half * 0.9, half * 0.55, half * 0.9], np.float32),
                           np.zeros(3, np.float32), 60.0, W, H),
        moving=list(range(len(kinds))))
