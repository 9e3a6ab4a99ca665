"""Scene snapshot / resume.

Reference (feature `serde`): SerializableScene (rfw-scene/src/lib.rs:157-203)
+ per-mesh bincode with material/texture remap (objects_3d/mod.rs:519-671),
camera `.cam` files (camera/mod.rs:318-339), saved by Instance::save_scene
as `.scenev1` (rfw/src/lib.rs:292-298).

TPU rebuild: one compressed npz holding every SoA array + a JSON manifest —
meshes, instance pools, materials, textures (base mip only; mips regen on
load), lights, cameras, node graphs (TRS arrays, parents, skins, animation
channels, instance wiring), and optionally the progressive film accumulator
(so long renders resume mid-accumulation). Extension: `.scenev1.npz`.

Host copy of `rfw_tpu/scene/serialize.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np

from rfw_tpu_torch.models.mesh3d import Mesh3D
from rfw_tpu_torch.scene.camera import Camera3D
from rfw_tpu_torch.scene.materials import Material, Texture
from rfw_tpu_torch.scene.scene import Scene

EXTENSION = ".scenev1.npz"


def _handles_with_slots(scene: "Scene", handles):
    """Recover (mesh_slot, handle) pairs by identity of the owning list."""
    out = []
    for h in handles:
        for slot, il in scene.instances_3d.items():
            if h._list is il:
                out.append((slot, h))
                break
    return out
_MAT_FIELDS = (
    "metallic subsurface specular_f roughness specular_tint anisotropic sheen "
    "sheen_tint clearcoat clearcoat_gloss transmission eta custom0 custom1 "
    "custom2 custom3 diffuse_tex normal_tex metallic_roughness_tex emissive_tex "
    "sheen_tex custom_tex double_sided"
).split()


def save_scene(scene: Scene, path: str, camera: Optional[Camera3D] = None,
               film: Optional[np.ndarray] = None, spp: int = 0) -> None:
    if not path.endswith(EXTENSION):
        path += EXTENSION
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict = {"version": 1, "meshes": [], "materials": [], "textures": [],
                      "lights": {}, "instances": {}}

    for slot, mesh in scene.meshes_3d:
        key = f"mesh{slot}"
        manifest["meshes"].append({"slot": slot, "name": mesh.name,
                                   "has_skin": mesh.has_skin,
                                   "has_morphs": mesh.has_morphs})
        arrays[f"{key}_positions"] = mesh.positions
        arrays[f"{key}_normals"] = mesh.normals
        arrays[f"{key}_uvs"] = mesh.uvs
        arrays[f"{key}_tangents"] = mesh.tangents
        arrays[f"{key}_indices"] = mesh.indices
        arrays[f"{key}_tri_material"] = mesh.tri_material
        arrays[f"{key}_ranges"] = mesh.ranges
        if mesh.has_skin:
            arrays[f"{key}_joints"] = mesh.joints
            arrays[f"{key}_weights"] = mesh.weights
        if mesh.has_morphs:
            arrays[f"{key}_morph_targets"] = mesh.morph_targets
            if mesh.morph_normals is not None:
                arrays[f"{key}_morph_normals"] = mesh.morph_normals
            if mesh.morph_tangents is not None:
                arrays[f"{key}_morph_tangents"] = mesh.morph_tangents

    for slot, il in scene.instances_3d.items():
        arrays[f"inst{slot}_matrices"] = il.matrices
        arrays[f"inst{slot}_skin_ids"] = il.skin_ids
        arrays[f"inst{slot}_active"] = il.active
        if il.morph_weights is not None:
            arrays[f"inst{slot}_morph_weights"] = il.morph_weights
        manifest["instances"][str(slot)] = int(il.capacity)

    for idx, mat in scene.materials.materials:
        entry = {"slot": idx, "name": mat.name}
        entry.update({f: (getattr(mat, f) if not isinstance(getattr(mat, f), bool)
                          else bool(getattr(mat, f))) for f in _MAT_FIELDS})
        manifest["materials"].append(entry)
        arrays[f"mat{idx}_color"] = mat.color
        arrays[f"mat{idx}_specular"] = mat.specular
        arrays[f"mat{idx}_absorption"] = mat.absorption

    for idx, tex in scene.materials.textures:
        manifest["textures"].append({"slot": idx, "srgb": tex.srgb, "path": tex.path})
        arrays[f"tex{idx}_base"] = tex.mips[0]

    lights = scene.lights
    manifest["lights"]["point"] = [
        {"slot": i} for i, _ in lights.point
    ]
    for i, l in lights.point:
        arrays[f"plight{i}"] = np.concatenate([l.position, l.energy])
    manifest["lights"]["spot"] = [
        {"slot": i, "inner": l.inner_angle, "outer": l.outer_angle}
        for i, l in lights.spot
    ]
    for i, l in lights.spot:
        arrays[f"slight{i}"] = np.concatenate([l.position, l.direction, l.energy])
    manifest["lights"]["directional"] = [{"slot": i} for i, _ in lights.directional]
    for i, l in lights.directional:
        arrays[f"dlight{i}"] = np.concatenate([l.direction, l.energy])

    # node graphs (flattened SoA + animation channels + instance wiring)
    manifest["graphs"] = []
    for gi, g in scene.graph.storage:
        key = f"g{gi}"
        gm = {
            "slot": gi,
            "name": g.name,
            "names": g.names,
            "mesh_nodes": [[int(a), int(b)] for a, b in g.mesh_nodes],
            "node_skin": {str(k): int(v) for k, v in g.node_skin.items()},
            "scene_skin_ids": [int(x) for x in g.scene_skin_ids],
            "skins": [
                {"name": sk.name, "n_anim": 0} for sk in g.skins
            ],
            "animations": [
                {
                    "name": a.name,
                    "channels": [
                        {"node": int(c.node), "path": c.path,
                         "interpolation": c.interpolation}
                        for c in a.channels
                    ],
                }
                for a in g.animations
            ],
            "instances": {
                str(node): [[slot, h.index]
                            for slot, h in _handles_with_slots(scene, hs)]
                for node, hs in g.instance_handles.items()
            },
        }
        manifest["graphs"].append(gm)
        arrays[f"{key}_translation"] = g.translation
        arrays[f"{key}_rotation"] = g.rotation
        arrays[f"{key}_scale"] = g.scale
        arrays[f"{key}_matrix_override"] = g.matrix_override
        arrays[f"{key}_has_override"] = g.has_override
        arrays[f"{key}_parent"] = g.parent
        arrays[f"{key}_root_matrix"] = g.root_matrix
        for si, sk in enumerate(g.skins):
            arrays[f"{key}_skin{si}_joints"] = sk.joint_nodes
            arrays[f"{key}_skin{si}_ibm"] = sk.inverse_bind
        for ai, a in enumerate(g.animations):
            for ci, c in enumerate(a.channels):
                arrays[f"{key}_a{ai}c{ci}_times"] = c.times
                arrays[f"{key}_a{ai}c{ci}_values"] = c.values

    sky = scene.skybox.value
    if sky is not None:
        manifest["skybox"] = {"srgb": bool(sky.srgb)}
        arrays["skybox_base"] = sky.mips[0]

    if camera is not None:
        arrays["camera"] = np.concatenate([
            camera.position, camera.direction,
            np.array([camera.fov, camera.aperture, camera.focal_distance,
                      camera.near_plane, camera.far_plane, camera.speed], np.float32),
        ])
    if film is not None:
        arrays["film"] = np.asarray(film)
        manifest["film_spp"] = int(spp)

    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_scene(path: str) -> Tuple[Scene, Optional[Camera3D], Optional[np.ndarray], int]:
    """Returns (scene, camera, film, spp)."""
    if not path.endswith(EXTENSION):
        path += EXTENSION
    data = np.load(path, allow_pickle=False)
    manifest = json.loads(bytes(data["__manifest__"]).decode())

    scene = Scene()
    # materials: slot 0/default already exist — overwrite by slot
    for entry in manifest["materials"]:
        idx = entry["slot"]
        mat = Material(name=entry.get("name", ""))
        for f in _MAT_FIELDS:
            setattr(mat, f, entry[f])
        mat.color = data[f"mat{idx}_color"].astype(np.float32)
        mat.specular = data[f"mat{idx}_specular"].astype(np.float32)
        mat.absorption = data[f"mat{idx}_absorption"].astype(np.float32)
        scene.materials.materials.overwrite(idx, mat)

    for entry in manifest["textures"]:
        idx = entry["slot"]
        tex = Texture.from_array(data[f"tex{idx}_base"], path=entry.get("path"),
                                 srgb=entry.get("srgb", True))
        scene.materials.textures.overwrite(idx, tex)

    for m in manifest["meshes"]:
        slot = m["slot"]
        key = f"mesh{slot}"
        mesh = Mesh3D(
            positions=data[f"{key}_positions"],
            normals=data[f"{key}_normals"],
            uvs=data[f"{key}_uvs"],
            tangents=data[f"{key}_tangents"],
            indices=data[f"{key}_indices"],
            tri_material=data[f"{key}_tri_material"],
            tri_light=np.full(data[f"{key}_indices"].shape[0], -1, np.int32),
            ranges=data[f"{key}_ranges"],
            joints=data[f"{key}_joints"] if m["has_skin"] else None,
            weights=data[f"{key}_weights"] if m["has_skin"] else None,
            morph_targets=(data[f"{key}_morph_targets"]
                           if m.get("has_morphs") else None),
            morph_normals=(data[f"{key}_morph_normals"]
                           if f"{key}_morph_normals" in data else None),
            morph_tangents=(data[f"{key}_morph_tangents"]
                            if f"{key}_morph_tangents" in data else None),
            aabb_min=data[f"{key}_positions"].min(axis=0),
            aabb_max=data[f"{key}_positions"].max(axis=0),
            name=m.get("name", ""),
        )
        scene.meshes_3d.overwrite(slot, mesh)
        from rfw_tpu_torch.scene.instances import InstanceList3D

        il = InstanceList3D()
        if f"inst{slot}_matrices" in data:
            il.matrices = data[f"inst{slot}_matrices"].astype(np.float32)
            il.skin_ids = data[f"inst{slot}_skin_ids"].astype(np.int32)
            il.active = data[f"inst{slot}_active"].astype(bool)
            il.changed = np.ones_like(il.active)
            if f"inst{slot}_morph_weights" in data:
                il.morph_weights = (
                    data[f"inst{slot}_morph_weights"].astype(np.float32))
            il._free = [i for i in range(il.capacity) if not il.active[i]]
            il.any_changed = True
        scene.instances_3d[slot] = il
    scene._instances_changed = True

    from rfw_tpu_torch.scene.lights import DirectionalLight, PointLight, SpotLight

    for e in manifest["lights"]["point"]:
        v = data[f"plight{e['slot']}"]
        scene.lights.point.overwrite(e["slot"], PointLight(v[:3], v[3:6]))
    for e in manifest["lights"]["spot"]:
        v = data[f"slight{e['slot']}"]
        scene.lights.spot.overwrite(
            e["slot"], SpotLight(v[:3], v[3:6], v[6:9], e["inner"], e["outer"])
        )
    for e in manifest["lights"]["directional"]:
        v = data[f"dlight{e['slot']}"]
        scene.lights.directional.overwrite(e["slot"], DirectionalLight(v[:3], v[3:6]))

    # node graphs
    from rfw_tpu_torch.scene.descriptor import (
        AnimationDescriptor, AnimChannelDescriptor, NodeDescriptor,
        SceneDescriptor, SkinDescriptor,
    )
    from rfw_tpu_torch.scene.graph import NodeGraph
    from rfw_tpu_torch.scene.instances import InstanceHandle3D

    for gm in manifest.get("graphs", []):
        gi = gm["slot"]
        key = f"g{gi}"
        parent = data[f"{key}_parent"]
        n = parent.shape[0]
        nodes = []
        for i in range(n):
            nd = NodeDescriptor(name=gm["names"][i] if i < len(gm["names"]) else "")
            nd.translation = data[f"{key}_translation"][i]
            nd.rotation = data[f"{key}_rotation"][i]
            nd.scale = data[f"{key}_scale"][i]
            if data[f"{key}_has_override"][i]:
                nd.matrix = data[f"{key}_matrix_override"][i]
            nodes.append(nd)
        for i in range(n):
            p = int(parent[i])
            if p >= 0:
                nodes[p].children.append(i)
        skins = [
            SkinDescriptor(
                name=sm["name"],
                joint_nodes=data[f"{key}_skin{si}_joints"].tolist(),
                inverse_bind_matrices=data[f"{key}_skin{si}_ibm"],
            )
            for si, sm in enumerate(gm["skins"])
        ]
        anims = []
        for ai, am in enumerate(gm["animations"]):
            chans = [
                AnimChannelDescriptor(
                    node=cm["node"], path=cm["path"],
                    times=data[f"{key}_a{ai}c{ci}_times"],
                    values=data[f"{key}_a{ai}c{ci}_values"],
                    interpolation=cm["interpolation"],
                )
                for ci, cm in enumerate(am["channels"])
            ]
            anims.append(AnimationDescriptor(name=am["name"], channels=chans))
        desc = SceneDescriptor(
            name=gm["name"], nodes=nodes,
            roots=[i for i in range(n) if parent[i] < 0],
            skins=skins, animations=anims,
        )
        g = NodeGraph(desc, {})
        g.mesh_nodes = [(a, b) for a, b in gm["mesh_nodes"]]
        g.node_skin = {int(k): v for k, v in gm["node_skin"].items()}
        g.scene_skin_ids = list(gm["scene_skin_ids"])
        g.root_matrix = data[f"{key}_root_matrix"]
        for node_str, pairs in gm["instances"].items():
            hs = []
            for slot, idx in pairs:
                il = scene.instances_3d.get(slot)
                if il is not None:
                    hs.append(InstanceHandle3D(il, idx))
            g.instance_handles[int(node_str)] = hs
        scene.graph.storage.overwrite(gi, g)
        # skins storage entries
        from rfw_tpu_torch.backend.structs import SkinView

        for sk, sid in zip(g.skins, g.scene_skin_ids):
            scene.skins.overwrite(sid, SkinView(joint_matrices=sk.joint_matrices))

    if "skybox_base" in data:
        scene.set_skybox(Texture.from_array(
            data["skybox_base"],
            srgb=manifest.get("skybox", {}).get("srgb", True)))

    camera = None
    if "camera" in data:
        c = data["camera"]
        camera = Camera3D(position=c[:3].astype(np.float32),
                          direction=c[3:6].astype(np.float32),
                          fov=float(c[6]), aperture=float(c[7]),
                          focal_distance=float(c[8]), near_plane=float(c[9]),
                          far_plane=float(c[10]), speed=float(c[11]))
    film = data["film"] if "film" in data else None
    spp = manifest.get("film_spp", 0)
    return scene, camera, film, spp
