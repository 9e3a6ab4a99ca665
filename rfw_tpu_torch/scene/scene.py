"""Scene — the single source of truth (reference crates/rfw-scene/src/lib.rs
:123-135 `Scene` struct, plus the synchronize_system delta pump from
rfw/src/system/mod.rs:19-206 which lives here as `Scene.synchronize`).

Holds tracked storages for meshes/instances (3D + 2D), the scene graph,
skins, materials, lights, cameras; every mutation flips dirty state that
`synchronize(backend)` drains through the Backend protocol once per frame.

Host copy of `rfw_tpu/scene/scene.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np

from rfw_tpu_torch.backend.contract import Backend
from rfw_tpu_torch.backend.structs import SkinView
from rfw_tpu_torch.models.mesh2d import Mesh2D
from rfw_tpu_torch.models.mesh3d import Mesh3D
from rfw_tpu_torch.scene.camera import Camera2D, Camera3D
from rfw_tpu_torch.scene.descriptor import MeshDescriptor, SceneDescriptor
from rfw_tpu_torch.scene.graph import GraphHandle, NodeGraph, SceneGraph
from rfw_tpu_torch.scene.instances import (
    InstanceHandle2D,
    InstanceHandle3D,
    InstanceList2D,
    InstanceList3D,
)
from rfw_tpu_torch.scene.lights import (
    DirectionalLight,
    Lights,
    PointLight,
    SpotLight,
    extract_area_lights,
)
from rfw_tpu_torch.scene.materials import Material, Materials, Texture
from rfw_tpu_torch.utils.track import Tracked
from rfw_tpu_torch.utils import log
from rfw_tpu_torch.utils.collections import TrackedStorage

_LOG = log.get("scene")


class SceneError(Exception):
    """(reference SceneError enum, lib.rs:52-98)"""


class Scene:
    def __init__(self) -> None:
        self.meshes_3d: TrackedStorage[Mesh3D] = TrackedStorage()
        self.instances_3d: Dict[int, InstanceList3D] = {}
        self.meshes_2d: TrackedStorage[Mesh2D] = TrackedStorage()
        self.instances_2d: Dict[int, InstanceList2D] = {}
        self.graph = SceneGraph()
        self.skins: TrackedStorage = TrackedStorage()  # of SkinView
        self.materials = Materials()
        self.lights = Lights()
        #: environment map (reference Backend::set_skybox); Tracked so the
        #: sync pump pushes it to the backend exactly when it changes
        self.skybox: Tracked[Optional[Texture]] = Tracked(None, changed=False)
        self._instances_changed = True
        self._lights_rebuilt = False
        # per-mesh area-light chunks, reused when a mesh didn't change
        self._area_cache: Dict[int, object] = {}

    # ================= loading =================
    def load(self, path: str) -> Union[MeshDescriptor, SceneDescriptor]:
        """Dispatch by extension (reference Scene::load :271-300)."""
        from rfw_tpu_torch.loaders import LOADERS

        ext = os.path.splitext(path)[1].lower()
        loader = LOADERS.get(ext)
        if loader is None:
            raise SceneError(f"no loader for extension {ext!r}")
        return loader.load(path, self.materials)

    # ================= 3D objects =================
    def add_3d_object(self, mesh: Mesh3D) -> int:
        """(reference add_3d_object :324)"""
        slot = self.meshes_3d.push(mesh)
        self.instances_3d[slot] = InstanceList3D()
        _LOG.info("added 3d mesh %d (%s): %d tris", slot, mesh.name, mesh.num_triangles)
        return slot

    def add_3d_instance(self, mesh_id: int, matrix: Optional[np.ndarray] = None) -> InstanceHandle3D:
        """(reference add_3d_instance :450-483)"""
        if mesh_id not in self.meshes_3d:
            raise SceneError(f"mesh {mesh_id} does not exist")
        h = self.instances_3d[mesh_id].allocate()
        if matrix is not None:
            h.set_matrix(matrix)
        self._instances_changed = True
        return h

    def add_3d(self, desc: Union[MeshDescriptor, SceneDescriptor]) -> Union[int, GraphHandle]:
        """Instantiate a load result (reference Scene::add_3d :302-312 +
        SceneDescriptor::to_scene graph/mod.rs:389-401)."""
        if isinstance(desc, MeshDescriptor):
            return self.add_3d_object(desc.mesh)
        # scene descriptor: register meshes, build graph, wire instances/skins
        slot_map = {i: self.add_3d_object(m) for i, m in enumerate(desc.meshes)}
        g = NodeGraph(desc, slot_map)
        for node, mesh_slot in g.mesh_nodes:
            h = self.add_3d_instance(mesh_slot)
            g.instance_handles.setdefault(node, []).append(h)
        # skins -> scene skin storage
        for skin in g.skins:
            sid = self.skins.push(SkinView(joint_matrices=skin.joint_matrices))
            g.scene_skin_ids.append(sid)
        # attach skin ids to skinned instances
        for node, skin_id in g.node_skin.items():
            for h in g.instance_handles.get(node, []):
                if skin_id < len(g.scene_skin_ids):
                    h.set_skin(g.scene_skin_ids[skin_id])
        handle = self.graph.add_graph(g)
        g.update()
        return handle

    def remove_3d_object(self, mesh_id: int) -> None:
        self.meshes_3d.erase(mesh_id)
        self.instances_3d.pop(mesh_id, None)
        self._area_cache.pop(mesh_id, None)

    # ================= 2D objects =================
    def add_2d_object(self, mesh: Mesh2D) -> int:
        slot = self.meshes_2d.push(mesh)
        self.instances_2d[slot] = InstanceList2D()
        return slot

    def add_2d_instance(self, mesh_id: int, matrix: Optional[np.ndarray] = None) -> InstanceHandle2D:
        if mesh_id not in self.meshes_2d:
            raise SceneError(f"2d mesh {mesh_id} does not exist")
        h = self.instances_2d[mesh_id].allocate()
        if matrix is not None:
            h.set_matrix(matrix)
        return h

    def set_2d_object(self, mesh_id: int, mesh: Mesh2D) -> None:
        self.meshes_2d.overwrite(mesh_id, mesh)

    # ================= appearance =================
    def add_material(self, mat: Material) -> int:
        return self.materials.push(mat)

    def add_texture(self, tex: Texture) -> int:
        return self.materials.push_texture(tex)

    # ================= lights =================
    def add_point_light(self, position, energy) -> int:
        return self.lights.point.push(
            PointLight(np.asarray(position, np.float32), np.asarray(energy, np.float32))
        )

    def add_spot_light(self, position, direction, energy, inner_angle, outer_angle) -> int:
        return self.lights.spot.push(
            SpotLight(
                np.asarray(position, np.float32),
                np.asarray(direction, np.float32),
                np.asarray(energy, np.float32),
                float(inner_angle),
                float(outer_angle),
            )
        )

    def set_skybox(self, texture) -> None:
        """Set the environment map: a Texture, a path, or None to clear
        (reference Scene skybox -> Backend::set_skybox)."""
        if isinstance(texture, str):
            texture = Texture.load(texture, srgb=True)
        self.skybox.value = texture

    def add_directional_light(self, direction, energy) -> int:
        return self.lights.directional.push(
            DirectionalLight(np.asarray(direction, np.float32), np.asarray(energy, np.float32))
        )

    # ================= animation =================
    def synchronize_graph(self) -> bool:
        moved = self.graph.synchronize()
        if moved:
            self._instances_changed = True
            # push updated joint matrices into skin storage
            for _, g in self.graph.storage:
                for skin, sid in zip(g.skins, g.scene_skin_ids):
                    self.skins.overwrite(sid, SkinView(joint_matrices=skin.joint_matrices))
        return moved

    def set_animations_time(self, t: float) -> None:
        self.graph.set_animations_time(t)

    # ================= area lights =================
    def update_lights(self, changed_slots: Optional[set] = None) -> None:
        """Extract per-triangle area lights from emissive materials
        (reference update_lights, lib.rs:575-648): scans meshes whose
        materials have light_flags set, instantiates one AreaLight per
        emissive triangle per active instance, back-writes tri light ids.

        `changed_slots`: re-extract only these mesh slots; cached per-mesh
        chunks are reused for the rest (a 10k-instance scene where one mesh
        moves re-extracts one mesh, not all). tri_light back-writes are
        per-mesh ranks — the integrator only tests `tri_light >= 0`; the
        emissive-hit MIS pdf is reconstructed at shade time from the hit's
        own world area (render/wavefront.py), so ids need no global base."""
        flags = self.materials.light_flags()
        emis_table = self.materials.emission_table()
        from rfw_tpu_torch.backend.lights import AreaLightsView

        live_slots = set()
        for slot, mesh in self.meshes_3d:
            live_slots.add(slot)
            if changed_slots is not None and slot not in changed_slots:
                continue
            self._area_cache.pop(slot, None)
            il = self.instances_3d.get(slot)
            if il is None or len(il) == 0 or mesh.num_triangles == 0:
                continue
            valid = mesh.tri_material < len(flags)
            tm = np.minimum(mesh.tri_material, len(flags) - 1)
            emissive = np.where(valid, flags[tm], False)
            if not emissive.any():
                if (mesh.tri_light >= 0).any():
                    mesh.tri_light[:] = -1
                    self.meshes_3d.touch(slot)
                continue
            radiance = np.where((valid & emissive)[:, None], emis_table[tm], 0.0)
            lights, light_id = extract_area_lights(
                emissive, radiance.astype(np.float32), mesh.tri_vertices(),
                il.active_matrices(), slot,
                np.nonzero(il.active)[0].astype(np.int32),
            )
            if not np.array_equal(light_id, mesh.tri_light):
                mesh.tri_light[:] = light_id
                self.meshes_3d.touch(slot)
            if lights.count:
                self._area_cache[slot] = lights

        for stale in [s for s in self._area_cache if s not in live_slots]:
            del self._area_cache[stale]

        chunks = [self._area_cache[s] for s in sorted(self._area_cache)]
        if chunks:
            self.lights.area = AreaLightsView(
                *[np.concatenate([getattr(c, f) for c in chunks]) for f in AreaLightsView.__dataclass_fields__]
            )
        else:
            self.lights.area = AreaLightsView.empty()
        self.lights.area_changed = True

    # ================= the delta pump =================
    def synchronize(self, backend: Backend) -> None:
        """Drain all change feeds into the backend (reference
        synchronize_system, rfw/src/system/mod.rs:19-206)."""
        self.synchronize_graph()

        # skins
        if self.skins.any_changed:
            backend.set_skins(list(self.skins.iter_changed()))

        # area lights need re-extraction when emissive materials/instances moved
        mats_changed = self.materials.any_changed
        if mats_changed or self._instances_changed:
            emissive_exists = self.materials.light_flags().any()
            if emissive_exists or self.lights.area.count:
                if mats_changed:
                    self.update_lights()  # material edits can re-flag any mesh
                else:
                    moved = {
                        slot for slot, il in self.instances_3d.items()
                        if il.any_changed
                    }
                    moved.update(self.meshes_3d.changed_indices())
                    self.update_lights(moved)

        # meshes
        if self.meshes_3d.any_changed:
            backend.set_3d_meshes(
                [(i, m.view()) for i, m in self.meshes_3d.iter_changed()]
            )
            erased = self.meshes_3d.take_erased()
            if erased:
                backend.unload_3d_meshes(erased)

        # instances
        if self._instances_changed:
            payload = []
            for slot, il in self.instances_3d.items():
                if slot in self.meshes_3d:
                    m = self.meshes_3d[slot]
                    payload.append((slot, il.view(m.aabb_min, m.aabb_max)))
            backend.set_3d_instances(payload)

        # 2D
        if self.meshes_2d.any_changed:
            backend.set_2d_meshes([(i, m.view()) for i, m in self.meshes_2d.iter_changed()])
        changed_2d = [
            (slot, il.view()) for slot, il in self.instances_2d.items() if il.any_changed
        ]
        if changed_2d:
            backend.set_2d_instances(changed_2d)

        # materials + textures
        if self.materials.textures.any_changed:
            backend.set_textures(
                [(i, t.view()) for i, t in self.materials.textures.iter_changed()]
            )
        if mats_changed:
            backend.set_materials(
                self.materials.to_device(), self.materials.materials.changed_indices()
            )

        # skybox
        if self.skybox.changed:
            tex = self.skybox.value
            backend.set_skybox(None if tex is None else tex.view())

        # lights
        if self.lights.point.any_changed:
            backend.set_point_lights(self.lights.point_view())
        if self.lights.spot.any_changed:
            backend.set_spot_lights(self.lights.spot_view())
        if self.lights.directional.any_changed:
            backend.set_directional_lights(self.lights.directional_view())
        if self.lights.area_changed:
            backend.set_area_lights(self.lights.area)

        self.reset_changed()
        backend.synchronize()

    def reset_changed(self) -> None:
        """(reference reset_changed :558-573)"""
        self.meshes_3d.reset_changed()
        self.meshes_2d.reset_changed()
        self.materials.reset_changed()
        self.lights.reset_changed()
        self.skybox.reset_changed()
        self.skins.reset_changed()
        for il in self.instances_3d.values():
            il.reset_changed()
        for il in self.instances_2d.values():
            il.reset_changed()
        self._instances_changed = False
