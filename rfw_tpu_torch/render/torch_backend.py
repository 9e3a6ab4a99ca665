"""TorchBackend — the Backend contract over the ported path tracer.

Counterpart of `rfw_tpu/render/tpu_backend.py::TpuBackend`: the same
14-method contract (crates/rfw-backend/src/lib.rs:35-82, here
`rfw_tpu_torch.backend.contract.Backend`) and the same state model
(reference 'backends are dumb caches invalidated by dirty bits'):
`set_*` stage host-side copies + dirty flags; `synchronize()` does the
heavy lifting once per frame —
  * a geometry change: host LBS skinning and morph targets for deformed
    meshes, BLAS (re)build for changed meshes (cached per mesh slot) or
    refit, `pack_trace_scene` -> an equality-gated upload of the packed
    arenas (only fields whose host array changed, or that a device refit
    rewrote, are re-sent), then the device refit plans of every deformed
    unit (`render/refit_device.py`);
  * a skin pose or morph-weight change with the same layout
    (`device_dynamics`, the default): upload of the joint matrices and
    morph weights, then `apply_dynamic` on the device (skin, morph, BVH
    refit) — no repack, no arena upload;
  * instance-only motion: with `device_motion` (the default, from
    RFW_DEVICE_MOTION) and at least `motion_min_instances` instances,
    upload of the matrices and `instance_motion_update` on the device (the
    TLAS mirrors refit over the last host topology); else
    `repack_instances` (host TLAS rebuild) -> upload of the TLAS and
    instance fields, with the 8-wide TLAS built on the card by
    `build_tlas8_device` from DEVICE_TLAS_MIN_INSTANCES instances up.
    A pack wider than 8 (RFW_WIDE_ARITY 16 or 32) keeps the host routes
    of both: the refit plans and the device TLAS builder are 8-wide;
  * material block / texture atlas / light buffers upload on change, each
    alone.
`render()` runs `samples_per_frame` progressive samples of
`render_sample` (keys `fold_in(PRNGKey(42), sample)` for the random
sampler, as `TpuBackend` derives them), tonemaps on the device (FXAA
optional), composites the 2D overlay on the host, and returns an
(H, W, 4) uint8 frame. Progressive accumulation resets when the camera or
the scene changes (reference RenderMode::Reset semantics, gpu-rt
lib.rs:1690-1692).

The backend runs on the card unless the caller names another device
(`device="cpu"` runs the kernels' plain versions, as the tests do).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rfw_tpu_torch import native
from rfw_tpu_torch.accel.bvh_cpu import BvhNodes
from rfw_tpu_torch.accel.tlas_device import build_tlas8_device, tlas8_node_count
from rfw_tpu_torch.backend.contract import RenderMode, init_from_window_handle
from rfw_tpu_torch.backend.lights import (
    AreaLightsView,
    DirectionalLightsView,
    PointLightsView,
    SpotLightsView,
)
from rfw_tpu_torch.backend.structs import (
    CameraView2D,
    CameraView3D,
    DeviceMaterials,
    InstancesView2D,
    InstancesView3D,
    MeshView2D,
    MeshView3D,
    SkinView,
    TextureView,
)
from rfw_tpu_torch.convert import (
    atlas_to_device, lights_to_device, materials_to_device, scene_to_device,
    to_tensor, update_scene,
)
from rfw_tpu_torch.models.mesh3d import Mesh3D
from rfw_tpu_torch.render import film as film_mod
from rfw_tpu_torch.render.atlas import TextureAtlas, pack_atlas
from rfw_tpu_torch.render.lights_pack import DeviceLights, pack_lights
from rfw_tpu_torch.render.overlay import composite_overlay, rasterize_2d
from rfw_tpu_torch.render import refit_device, threefry
from rfw_tpu_torch.render.pack import TraceScene, pack_trace_scene, repack_instances
from rfw_tpu_torch.render.wavefront import (
    RenderConfig, mat_feature_mask, render_sample, tex_kinds_mask,
)
from rfw_tpu_torch.utils import Averager, log, trace

_LOG = log.get("torch_backend")

#: instance-count threshold for the on-device TLAS build in the
#: instance-only host route (below it, the host SAH collapse is trivial
#: and slightly higher quality)
DEVICE_TLAS_MIN_INSTANCES = 64


@dataclass
class TorchSettings:
    """Runtime knobs (reference WgpuSettings, backends/wgpu/src/lib.rs:32-38):
    `TpuSettings`'s fields and defaults."""

    samples_per_frame: int = 1
    max_bounces: int = 3
    clamp: float = 10.0
    sky_intensity: float = 0.0
    exposure: float = 1.0
    tonemap: str = "aces"
    enable_skinning: bool = True
    device_dynamics: bool = True  # skin/morph + BVH refit on the device per
    #   frame (render/refit_device.py): a pose sync uploads joint matrices
    #   and morph weights instead of repacking and re-uploading arenas.
    #   Off -> the host repack (LBS + BLAS refit on the host)
    sampler: str = "sobol"  # "sobol" (low-discrepancy) | "random" (threefry)
    fxaa: bool = False  # FXAA post-pass on the tonemapped frame (reference
    #   deferred_fxaa.frag)
    pixel_center: bool = False  # deterministic pixel-center primaries
    device_motion: bool = os.environ.get("RFW_DEVICE_MOTION", "1") != "0"
    #   instance-motion-only syncs refit every TLAS mirror on the device
    #   (refit_device.instance_motion_update): one matrix upload a frame,
    #   no host TLAS repack (reference gpu-rt rebuilds the TLAS on the host
    #   every synchronize, backends/gpu-rt/src/lib.rs:1570-1581). Off ->
    #   the host SAH rebuild
    motion_rebuild_every: int = 0  # >0: every Nth motion sync takes the
    #   host SAH rebuild to refresh the TLAS topology (the refit keeps
    #   boxes valid over the first topology). 0 = never
    motion_min_instances: int = 64  # below this instance count motion
    #   syncs take the host rebuild, which also refreshes the topology.
    #   0 = always the device route


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "TorchBackend runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain versions on the host")
    return torch.device("cuda", torch.cuda.current_device())


def _on_card(device: torch.device) -> bool:
    """The device TLAS build's gate (`TpuBackend` builds it off the CPU
    backend only)."""
    return device.type != "cpu"


def _mesh_from_view(v: MeshView3D) -> Mesh3D:
    return Mesh3D(
        positions=v.positions, normals=v.normals, uvs=v.uvs, tangents=v.tangents,
        indices=v.indices, tri_material=v.tri_material, tri_light=v.tri_light,
        ranges=v.ranges, joints=v.joints, weights=v.weights,
        aabb_min=v.aabb_min, aabb_max=v.aabb_max, name=v.name,
    )


def apply_skin(mesh: MeshView3D, joint_matrices: np.ndarray,
               positions: Optional[np.ndarray] = None) -> np.ndarray:
    """CPU linear-blend skinning -> deformed positions (reference
    SkinnedMesh3D::apply, rfw-backend/src/structs.rs:785-877; one einsum
    replaces the rayon par_iter), as `rfw_tpu`'s `apply_skin`: the native
    skin unless `RFW_NO_NATIVE=1`, else numpy. `positions` overrides the
    rest pose (glTF order: morph targets apply BEFORE the skin)."""
    p = mesh.positions if positions is None else positions
    if native.enabled():
        return native.skin_positions_native(p, mesh.joints, mesh.weights,
                                            joint_matrices)
    jm = joint_matrices[mesh.joints]  # (V,4,4,4)
    w = mesh.weights  # (V,4)
    blended = np.einsum("vj,vjab->vab", w, jm)  # (V,4,4)
    out = np.einsum("vab,vb->va", blended[:, :3, :3], p) + blended[:, :3, 3]
    # all-zero weights keep the rest pose (glTF permits unweighted vertices)
    has_w = w.sum(axis=-1) > 1e-8
    return np.where(has_w[:, None], out, p).astype(np.float32)


def skin_mesh_attributes(
    mesh: MeshView3D, joint_matrices: np.ndarray,
    positions: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    tangents: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LBS of positions AND shading attributes -> (positions, normals,
    tangents4). The reference transforms normals and tangents through the
    blended joint matrix inverse-transpose (SkinnedMesh3D::apply,
    rfw-backend/src/structs.rs:785-877).

    Normals use inverse-transpose(B) (correct under non-uniform scale);
    tangents transform like directions by B itself; handedness flips with
    a mirrored blend (sign of det). Degenerate blends (all-zero weights)
    keep the rest-pose attributes. `positions`/`normals`/`tangents`
    override the rest pose (glTF: morph targets apply BEFORE the skin)."""
    pos = apply_skin(mesh, joint_matrices, positions=positions)
    base_n = mesh.normals if normals is None else normals
    base_t = mesh.tangents if tangents is None else tangents

    jm = joint_matrices[mesh.joints][:, :, :3, :3]  # (V,4,3,3)
    B = np.einsum("vj,vjab->vab", mesh.weights, jm)  # (V,3,3)
    det = np.linalg.det(B)
    ok = np.abs(det) > 1e-12
    B_safe = np.where(ok[:, None, None], B, np.eye(3, dtype=B.dtype))
    n_mat = np.linalg.inv(B_safe).transpose(0, 2, 1)  # (V,3,3) inv-transpose

    n = np.einsum("vab,vb->va", n_mat, base_n)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(nlen > 1e-12, n / np.maximum(nlen, 1e-12), base_n)

    t_xyz = np.einsum("vab,vb->va", B_safe, base_t[:, :3])
    tlen = np.linalg.norm(t_xyz, axis=-1, keepdims=True)
    t_xyz = np.where(tlen > 1e-12, t_xyz / np.maximum(tlen, 1e-12),
                     base_t[:, :3])
    handed = base_t[:, 3:4] * np.where(det[:, None] < 0, -1.0, 1.0)
    tan = np.concatenate([t_xyz, handed], axis=1)
    return (pos, n.astype(np.float32), tan.astype(np.float32))


#: pseudo mesh-slot base for per-instance deform groups: `inst_mesh` rows
#: are int32 slot ids, so group copies of a skinned/morphed mesh pack
#: under `_PSEUDO_BASE + (slot << 12) + group` — far above any real
#: FlaggedStorage slot, still int32-safe
_PSEUDO_BASE = 1 << 20


def _pseudo_slot(slot: int, group: int) -> int:
    if group >= (1 << 12):
        # silent collision with the next slot's pseudo space would trace
        # instances against the wrong arena — fail loudly instead
        raise ValueError(
            f"mesh slot {slot} has {group + 1}+ distinct deform poses; "
            "the per-slot pseudo-slot space holds 4096")
    return _PSEUDO_BASE + (slot << 12) + group


def _group_keys(sids: np.ndarray, wrows: Optional[np.ndarray], count: int):
    """Per-instance deform identity: (skin id, morph-weight bytes)."""
    return [
        (int(sids[i]), wrows[i].tobytes() if wrows is not None else b"")
        for i in range(count)
    ]


def _pattern(keys) -> tuple:
    """Grouping pattern: first-occurrence group index per instance. A
    pattern change needs a full repack (a new group needs its own arena
    copy)."""
    uniq: Dict = {}
    return tuple(uniq.setdefault(k, len(uniq)) for k in keys)


def _deform_sids_wrows(mv: MeshView3D, iv: InstancesView3D,
                       skinning_enabled: bool):
    """The (sids, wrows) arrays _group_keys sees for this mesh's instances
    — gated exactly like _instance_layout so patterns compare stably."""
    count = iv.count
    skinnable = skinning_enabled and mv.has_skin
    if (skinnable and iv.skin_ids is not None
            and len(iv.skin_ids) == count):
        sids = np.asarray(iv.skin_ids, np.int64)
    else:
        sids = np.full(count, -1, np.int64)
    wrows = None
    if (mv.has_morphs and iv.morph_weights is not None
            and iv.morph_weights.shape[0] == count):
        wrows = np.asarray(iv.morph_weights, np.float32)
    return sids, wrows


def _same_ids(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    return len(a) == len(b) and np.array_equal(a, b)


def _same_morphs(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    if a is None and b is None:
        return True
    if a is None or b is None:
        # treat all-zero weights as equivalent to absent
        other = b if a is None else a
        return not np.any(other)
    return a.shape == b.shape and np.array_equal(a, b)


#: TraceScene fields an instance-only sync rewrites
_INSTANCE_FIELDS = (
    "tlas_min", "tlas_max", "tlas_left", "tlas_right",
    "tlas_count", "tlas_prim", "tlas_wide_f", "tlas_wide_i",
    "tlas8_box", "tlas8_code", "tlas8_cnt",
    "inst_matrix", "inst_inv", "inst_normal", "inst_mesh",
    "inst_aabb_min", "inst_aabb_max",
    "blas_root", "blas_wide_root", "blas8_root",
)


class TorchBackend:
    """Backend implementation (see module docstring)."""

    @classmethod
    def from_window_handle(cls, window, width=None, height=None,
                           scale=None, settings=None, device=None):
        """FromWindowHandle ctor (reference rfw-backend/src/lib.rs:26-33)."""
        return init_from_window_handle(cls, window, width, height, scale,
                                       settings, device=device)

    def __init__(self, width: int = 1280, height: int = 720,
                 settings: Optional[TorchSettings] = None, device=None) -> None:
        self.device = _default_device() if device is None else torch.device(device)
        self.settings = settings or TorchSettings()
        self.width = width
        self.height = height
        self.scale = 1.0

        # staged host state
        self._meshes: Dict[int, MeshView3D] = {}
        self._blas_cache: Dict[int, BvhNodes] = {}
        self._instances: Dict[int, InstancesView3D] = {}
        self._skins: Dict[int, SkinView] = {}
        self._materials: Optional[DeviceMaterials] = None
        self._textures: Dict[int, TextureView] = {}
        self._skybox: Optional[TextureView] = None
        self._point = PointLightsView.empty()
        self._spot = SpotLightsView.empty()
        self._area = AreaLightsView.empty()
        self._directional = DirectionalLightsView.empty()
        self._meshes_2d: Dict[int, MeshView2D] = {}
        self._instances_2d: Dict[int, InstancesView2D] = {}

        # dirty flags
        self._geo_dirty = True
        self._inst_dirty = False  # instance-only motion (fast repack path)
        self._mat_dirty = True
        self._tex_dirty = True
        self._light_dirty = True
        self._skin_dirty: set = set()
        self._morph_dirty: set = set()  # morph-weight-only changes (same
        #   grouping) for the device dynamic route; weight changes with
        #   count/topology changes still raise _geo_dirty

        # device dynamic-geometry state (render/refit_device.py): the
        # deform units, their device plans and the TLAS plan, or None
        self._dyn = None
        # device instance-motion state: the armed static inputs of the
        # instance_motion_update route (_try_device_motion), or None
        self._motion = None
        self._motion_syncs = 0  # device motion syncs since the last host rebuild
        self._group_sig: Dict[int, tuple] = {}  # per-slot grouping pattern
        #   of the last pack (_instance_layout); a pattern change forces a
        #   full repack
        self._dev_stale: set = set()  # TraceScene fields a device refit
        #   rewrote; the next host pack uploads them whatever the host
        #   comparison says

        # device state
        self._scene_dev: Optional[TraceScene] = None
        self._scene_host: Optional[TraceScene] = None
        self._mats_dev: Optional[DeviceMaterials] = None
        self._atlas_dev: Optional[TextureAtlas] = None
        self._lights_dev: Optional[DeviceLights] = None

        # film
        self._film: Optional[torch.Tensor] = None
        self._spp = 0
        self._last_view: Optional[np.ndarray] = None
        self._sky_tex_id = -1

        # observability (frame timers + Mrays/s counters)
        self.stats = {
            "sync_ms": Averager(100),
            "render_ms": Averager(100),
            "mrays_per_s": Averager(100),
            "spp_total": 0,
        }

    # ================= Backend contract =================
    def set_3d_meshes(self, changed: Sequence[Tuple[int, MeshView3D]]) -> None:
        for i, v in changed:
            self._meshes[i] = v
            self._blas_cache.pop(i, None)
        if changed:
            self._geo_dirty = True

    def unload_3d_meshes(self, ids: Sequence[int]) -> None:
        for i in ids:
            self._meshes.pop(i, None)
            self._blas_cache.pop(i, None)
            self._instances.pop(i, None)
        if ids:
            self._geo_dirty = True

    def set_3d_instances(self, changed: Sequence[Tuple[int, InstancesView3D]]) -> None:
        for i, v in changed:
            known = i in self._instances
            prev = self._instances.get(i)
            same_count = known and prev.count == v.count
            morphed = not _same_morphs(
                None if prev is None else prev.morph_weights, v.morph_weights
            )
            # skin REBINDING (ids, not poses) changes which deform unit an
            # instance belongs to -> repack; per-frame poses arrive via
            # set_skins
            rebound = known and not _same_ids(prev.skin_ids, v.skin_ids)
            self._instances[i] = v
            moved = not (known and same_count
                         and np.array_equal(prev.matrices, v.matrices))
            if rebound or not same_count:
                self._geo_dirty = True
            elif morphed:
                mv = self._meshes.get(i)
                pat = None
                if mv is not None:
                    sids, wrows = _deform_sids_wrows(
                        mv, v, self.settings.enable_skinning)
                    pat = _pattern(_group_keys(sids, wrows, v.count))
                if pat is not None and pat == self._group_sig.get(i):
                    # weight-only deformation, same grouping: the device
                    # dynamic route handles it without a repack (or
                    # synchronize repacks if no plan covers the slot)
                    self._morph_dirty.add(i)
                    if moved:
                        self._inst_dirty = True
                else:
                    self._geo_dirty = True  # grouping changed -> re-pack
            elif moved:
                self._inst_dirty = True  # motion only -> TLAS/instance repack

    def set_2d_meshes(self, changed: Sequence[Tuple[int, MeshView2D]]) -> None:
        for i, v in changed:
            self._meshes_2d[i] = v

    def set_2d_instances(self, changed: Sequence[Tuple[int, InstancesView2D]]) -> None:
        for i, v in changed:
            self._instances_2d[i] = v

    def set_materials(self, materials: DeviceMaterials, changed: Sequence[int]) -> None:
        self._materials = materials
        self._mat_dirty = True

    def set_textures(self, changed: Sequence[Tuple[int, TextureView]]) -> None:
        for i, v in changed:
            self._textures[i] = v
        if changed:
            self._tex_dirty = True

    def set_skybox(self, skybox: Optional[TextureView]) -> None:
        self._skybox = skybox
        self._tex_dirty = True

    def set_point_lights(self, lights: PointLightsView) -> None:
        self._point = lights
        self._light_dirty = True

    def set_spot_lights(self, lights: SpotLightsView) -> None:
        self._spot = lights
        self._light_dirty = True

    def set_area_lights(self, lights: AreaLightsView) -> None:
        self._area = lights
        self._light_dirty = True

    def set_directional_lights(self, lights: DirectionalLightsView) -> None:
        self._directional = lights
        self._light_dirty = True

    def set_skins(self, changed: Sequence[Tuple[int, SkinView]]) -> None:
        for i, v in changed:
            if i not in self._skins:
                # a NEW skin id can turn a packed-at-rest unit skinnable
                self._geo_dirty = True
            self._skins[i] = v
            self._skin_dirty.add(i)

    def synchronize(self) -> None:
        with trace.span("rfw.sync"):
            t0 = time.perf_counter()
            self._sync_scene()
            with trace.span("rfw.sync.upload"):
                self._sync_uploads()
            if self.device.type == "cuda":  # the clock stops after the uploads
                with trace.span("rfw.sync.wait"):
                    torch.cuda.synchronize(self.device)
            self.stats["sync_ms"].add((time.perf_counter() - t0) * 1e3)

    def _sync_scene(self) -> None:
        """The geometry and instance part of a sync: the device dynamics
        route, a full rebuild or an instance-only sync."""
        # skinned meshes force a geometry refresh when their skin updated
        skinned_dirty = any(
            m.has_skin for m in self._meshes.values()
        ) and bool(self._skin_dirty)
        morph_dirty = bool(self._morph_dirty)
        # device dynamic route: skins/morphs changed, the geometry layout
        # did not, and the last pack built refit plans covering every unit
        dyn_ok = (
            self._dyn is not None
            and self.settings.device_dynamics
            and not self._geo_dirty
            and self._morph_dirty <= self._dyn["slots"]
        )
        # pure instance motion also re-runs the device refit when plans
        # exist: the host instance repack only knows REST local AABBs, so
        # without the refit a posed unit's TLAS boxes would snap back to
        # the rest pose
        if (skinned_dirty or morph_dirty or self._inst_dirty) and dyn_ok:
            dyn_before = self._dyn
            if self._inst_dirty and self._scene_host is not None:
                # a grouping drift makes _sync_instances fall back to a full
                # _rebuild_scene, which replaces self._dyn and bakes the
                # poses on the host: refit only if the plans are current
                self._sync_instances()
            if self._dyn is not None and self._dyn is dyn_before:
                with trace.span("rfw.sync.dynamics"):
                    self._apply_device_dynamics()
            self._inst_dirty = False
            self._skin_dirty.clear()
            self._morph_dirty.clear()
            self._reset_film()
        elif self._geo_dirty or skinned_dirty or morph_dirty:
            with trace.span("rfw.sync.rebuild"):
                self._rebuild_scene()
            self._geo_dirty = False
            self._inst_dirty = False
            self._skin_dirty.clear()
            self._morph_dirty.clear()
            self._reset_film()
        elif self._inst_dirty and self._scene_host is not None:
            self._sync_instances()
            self._inst_dirty = False
            self._reset_film()

    def _sync_uploads(self) -> None:
        """Upload the material block, the texture atlas and the light
        buffers, each only when it changed."""
        if self._mat_dirty and self._materials is not None:
            self._mats_dev = materials_to_device(self._materials, self.device)
            self._mat_dirty = False
            self._reset_film()
        if self._tex_dirty:
            self._sync_textures()
        if self._light_dirty:
            self._lights_dev = lights_to_device(self._pack_lights(), self.device)
            self._light_dirty = False
            self._reset_film()

    def _sync_instances(self) -> None:
        """Instance-only motion: rebuild TLAS + instance arrays, keep
        geometry arenas on the device untouched (reference gpu-rt TLAS-only
        refit per synchronize)."""
        # the packed scene's instance rows follow the GROUPED layout
        # (per-instance deform units under pseudo slots); rebuild the same
        # layout with the fresh matrices so rows stay aligned with the arenas
        pack_meshes, instances, _units, sig = self._instance_layout()
        if sig != self._group_sig:
            # grouping drifted since the pack (defensive: normally
            # set_3d_instances flags _geo_dirty first) -> full repack
            with trace.span("rfw.sync.rebuild"):
                self._rebuild_scene()
            return
        ps_to_slot = dict(pack_meshes)
        meshes_info = [
            (ps, self._meshes[slot].aabb_min, self._meshes[slot].aabb_max)
            for ps, slot in pack_meshes
        ]
        if self._try_device_motion(meshes_info, instances):
            return
        with trace.span("rfw.sync.repack"):
            new_host = repack_instances(self._scene_host, meshes_info, instances)
            # device TLAS: for large instance pools on the card, the 8-wide
            # TLAS is built there as a complete 8-ary Morton tree instead of
            # uploading the host collapse (the other TLAS fields still upload).
            # Only the real prefix of the capacity-padded instance arenas
            # (inst_mesh >= 0) enters the build.
            n_inst = int((new_host.inst_mesh >= 0).sum())
            use_device_tlas = (
                _on_card(self.device)
                and n_inst >= DEVICE_TLAS_MIN_INSTANCES
                and tlas8_node_count(n_inst) <= new_host.tlas8_box.shape[0]
                # with device dynamics the refit plan refits tlas8 boxes over
                # the HOST topology, which the Morton tree would not match
                and self._dyn is None
                # the device builder emits 8-wide nodes only; wider packs
                # (RFW_WIDE_ARITY) keep the host collapse
                and new_host.tlas8_code.shape[1] == 8
            )
            fields = [f for f in _INSTANCE_FIELDS if not (
                use_device_tlas and f in ("tlas8_box", "tlas8_code", "tlas8_cnt"))]
            changed = {f: to_tensor(getattr(new_host, f), self.device) for f in fields}
            if use_device_tlas:
                def local(attr):
                    return to_tensor(np.stack([
                        getattr(self._meshes[ps_to_slot.get(int(m), int(m))], attr)
                        for m in new_host.inst_mesh[:n_inst]]), self.device)

                (changed["tlas8_box"], changed["tlas8_code"],
                 changed["tlas8_cnt"]) = build_tlas8_device(
                    changed["inst_matrix"][:n_inst], local("aabb_min"), local("aabb_max"),
                    pad_nodes=int(new_host.tlas8_box.shape[0]))
            self._scene_dev = self._scene_dev._replace(**changed)
            self._scene_host = new_host
            self._motion_syncs = 0  # the host rebuild refreshed the TLAS topology
            if self._dyn is not None:
                # the instance set / TLAS topology changed: rebuild the refit
                # plan's TLAS schedule from the new host arrays
                prev = self._dyn["tlas_plan"].passes_shape.shape[0]
                self._dyn["tlas_plan"] = refit_device.plan_to_device(
                    refit_device.build_tlas_plan(new_host, min_passes=prev), self.device)

    def _try_device_motion(self, meshes_info, instances) -> bool:
        """Instance-motion device route: when only matrices changed (the
        same instance set and layout as the packed arenas), refit every
        TLAS mirror on the device with `refit_device.instance_motion_update`
        — one (Icap,4,4) upload a frame, no host TLAS work. Returns False
        to fall back to the host SAH rebuild (which refreshes topology)."""
        base = self._scene_host
        if (not self.settings.device_motion or self._scene_dev is None
                or base is None):
            return False
        if base.tlas8_code.shape[1] != 8:
            # the TLAS refit plan schedules 8-wide supernodes only (rfw_tpu's
            # route rewrites a wider pack's tlas8_box as 8-wide rows, which
            # its Pallas tier then refuses): wider packs take the host route
            return False
        every = self.settings.motion_rebuild_every
        if every > 0 and self._motion_syncs + 1 >= every:
            return False  # periodic host rebuild refreshes the topology
        # mirror repack_instances' row layout: rows ordered by the
        # instances sequence, slots unknown to the base pack skipped
        known = {int(m) for m in base.inst_mesh if m >= 0}
        info = {s: (mn, mx) for s, mn, mx in meshes_info}
        mats_list, mesh_rows = [], []
        for slot, mats in instances:
            if slot not in known or slot not in info:
                continue
            m = np.asarray(mats, np.float32).reshape(-1, 4, 4)
            mats_list.append(m)
            mesh_rows.append(np.full(m.shape[0], slot, np.int32))
        if not mats_list:
            return False
        inst_mesh = np.concatenate(mesh_rows)
        n = inst_mesh.shape[0]
        if n < self.settings.motion_min_instances:
            return False  # the host SAH rebuild is faster below the gate
        icap = base.inst_matrix.shape[0]
        if n > icap or not np.array_equal(base.inst_mesh[:n], inst_mesh) \
                or not (base.inst_mesh[n:] < 0).all():
            self._motion = None  # the instance set changed: host repack
            return False

        with trace.span("rfw.sync.motion"):
            key = inst_mesh.tobytes()
            if self._motion is None or self._motion["key"] != key:
                # arm: static per-layout inputs (plan, local AABBs, live mask)
                plan = (self._dyn["tlas_plan"] if self._dyn is not None
                        else refit_device.plan_to_device(
                            refit_device.build_tlas_plan(base), self.device))
                lmin = np.zeros((icap, 3), np.float32)
                lmax = np.zeros((icap, 3), np.float32)
                lmin[:n] = np.stack([info[int(s)][0] for s in inst_mesh])
                lmax[:n] = np.stack([info[int(s)][1] for s in inst_mesh])
                self._motion = {
                    "key": key,
                    "plan": plan,
                    "lmin": to_tensor(lmin, self.device),
                    "lmax": to_tensor(lmax, self.device),
                    "live": to_tensor(np.arange(icap) < n, self.device),
                }
            pad = np.broadcast_to(np.eye(4, dtype=np.float32), (icap - n, 4, 4))
            mats = np.concatenate([np.concatenate(mats_list), pad])
            with trace.span("rfw.wait.upload"):
                mats = to_tensor(mats, self.device)
            self._scene_dev = refit_device.instance_motion_update(
                self._scene_dev, self._motion["plan"], mats,
                self._motion["lmin"], self._motion["lmax"], self._motion["live"])
            self._dev_stale |= set(refit_device.MOTION_FIELDS)
            self._motion_syncs += 1
            return True

    def _sync_textures(self) -> None:
        tex_list: List = []
        if self._textures:
            cap = max(self._textures) + 1
            tex_list = [None] * cap
            for i, t in self._textures.items():
                tex_list[i] = t
        # TextureView carries .mips/.srgb, all that atlas packing reads
        packed = list(tex_list)
        if self._skybox is not None:
            self._sky_tex_id = len(packed)
            packed.append(self._skybox)
        else:
            self._sky_tex_id = -1
        self._atlas_dev = atlas_to_device(pack_atlas(packed), self.device)
        self._tex_dirty = False
        self._reset_film()

    def render(
        self,
        view_2d: Optional[CameraView2D],
        view_3d: CameraView3D,
        mode: RenderMode = RenderMode.DEFAULT,
    ) -> np.ndarray:
        with trace.span("rfw.render"):
            t0 = time.perf_counter()
            if self._scene_dev is None or self._scene_dev.inst_matrix.shape[0] == 0:
                frame = np.zeros((self.height, self.width, 4), np.uint8)
            else:
                frame = self._render_frame(view_2d, view_3d, mode)
                # the frame is on the host: the device work is done
                dt = time.perf_counter() - t0
                self.stats["render_ms"].add(dt * 1e3)
                rays = (self.width * self.height * self.settings.samples_per_frame
                        * 2 * (self.settings.max_bounces + 1))
                self.stats["mrays_per_s"].add(rays / max(dt, 1e-9) / 1e6)
                self.stats["spp_total"] = self._spp
            trace.end_frame()
        return frame

    def _render_frame(self, view_2d: Optional[CameraView2D], view_3d: CameraView3D,
                      mode: RenderMode) -> np.ndarray:
        """The samples, the film and the 2D overlay of one frame."""
        with trace.span("rfw.render.setup"):
            cfg, view_dev, sky_tex, keys = self._frame_setup(view_3d, mode)
        last = None
        for s, key in enumerate(keys):
            res = render_sample(
                self._scene_dev, self._mats_dev, self._atlas_dev, self._lights_dev,
                view_dev, self.width, self.height, cfg, sky_tex=sky_tex,
                sample_index=self._spp + s, key=key,
            )
            with trace.span("rfw.film"):
                film_mod.add_sample(self._film, res.radiance)
            last = res
        self._spp += self.settings.samples_per_frame

        # AOV debug views (reference RenderMode -> G-buffer channels)
        if mode in (RenderMode.NORMAL, RenderMode.ALBEDO, RenderMode.GBUFFER,
                    RenderMode.SCREEN_SPACE, RenderMode.SSAO,
                    RenderMode.FILTERED_SSAO) and last is not None:
            frame = self._aov_frame(last, mode)
        else:
            with trace.span("rfw.film"):
                img = film_mod.tonemap(
                    self._film, float(self._spp), self.width, self.height,
                    exposure=self.settings.exposure, mode=self.settings.tonemap,
                    fxaa=self.settings.fxaa,
                )
                with trace.span("rfw.wait.readback"):
                    frame = img.cpu().numpy()

        # 2D overlay
        if self._meshes_2d and view_2d is not None:
            pairs = [
                (self._meshes_2d[i], self._instances_2d[i])
                for i in self._meshes_2d
                if i in self._instances_2d and self._instances_2d[i].count > 0
            ]
            if pairs:
                ov = rasterize_2d(
                    pairs, self._textures, view_2d.matrix, self.width, self.height
                )
                frame = composite_overlay(frame, ov)
        return frame

    def _frame_setup(self, view_3d: CameraView3D, mode: RenderMode):
        """render()'s work before its first sample: default materials,
        atlas and lights where none were set, the film (reset when the view
        changed or `mode` asks), the RenderConfig, the view on the device,
        the sky texture id and each sample's threefry key."""
        dev = self.device
        if self._mats_dev is None:
            self._materials = _default_materials()
            self._mats_dev = materials_to_device(self._materials, dev)
        if self._atlas_dev is None:
            self._atlas_dev = atlas_to_device(pack_atlas([]), dev)
        if self._lights_dev is None:
            self._lights_dev = lights_to_device(self._pack_lights(), dev)

        view_arr = view_3d.as_array()
        if mode == RenderMode.RESET or self._last_view is None or not np.allclose(
            view_arr, self._last_view
        ):
            self._reset_film()
            self._last_view = view_arr

        if self._film is None:
            self._film = film_mod.new_film(self.width, self.height, device=dev)
            self._spp = 0

        cfg = RenderConfig(
            max_bounces=self.settings.max_bounces,
            clamp=self.settings.clamp,
            sky_intensity=self.settings.sky_intensity,
            ao_aov=mode in (RenderMode.SSAO, RenderMode.FILTERED_SSAO),
            # color-only modes skip AOV capture + unsort entirely
            aovs=mode not in (RenderMode.DEFAULT, RenderMode.RESET),
            sampler=self.settings.sampler,
            pixel_center=self.settings.pixel_center,
            tex_mask=(tex_kinds_mask(self._materials.tex)
                      if self._materials is not None else 0),
            mat_features=(mat_feature_mask(self._materials)
                          if self._materials is not None else 0),
            # delta-only scenes skip the NEE<->BSDF MIS machinery
            has_area_lights=self._area.count > 0,
        )
        with trace.span("rfw.wait.upload"):
            view_dev = torch.from_numpy(view_arr).to(dev)
            sky_tex = (torch.tensor([self._sky_tex_id], dtype=torch.int32, device=dev)
                       if self._sky_tex_id >= 0 else None)
        key = threefry.PRNGKey(42)
        keys = [threefry.fold_in(key, self._spp + s)
                for s in range(self.settings.samples_per_frame)]
        return cfg, view_dev, sky_tex, keys

    def resize(self, width: int, height: int, scale: float = 1.0) -> None:
        self.width = int(width * scale)
        self.height = int(height * scale)
        self.scale = scale
        self._reset_film()

    def hdr_frame(self) -> Optional[np.ndarray]:
        """The linear-radiance mean of the progressive film as (H,W,3)
        float32 — the pre-tonemap HDR frame. None before the first
        render()."""
        if self._film is None or self._spp == 0:
            return None
        return (self._film.cpu().numpy().reshape(self.height, self.width, 3)
                / float(self._spp))

    # ================= internals =================
    def _reset_film(self) -> None:
        self._film = None
        self._spp = 0

    def _pack_lights(self) -> DeviceLights:
        return pack_lights(self._point, self._spot, self._directional, self._area)

    def _instance_layout(self):
        """Split instanced meshes into deform units.

        The reference gives every INSTANCE its own skin id and morph
        weights (rfw-scene/src/instances_3d.rs:10-322); a ray tracer needs
        a distinct deformed arena copy per distinct pose, so instances of
        a skinned/morphed mesh group by (skin_id, morph-weight bytes) and
        each group packs under its own pseudo mesh slot sharing the real
        slot's rest BLAS topology.

        Returns (pack_meshes [(pack_slot, real_slot)],
                 pack_instances [(pack_slot, matrices)],
                 units [dict], sig {real_slot: grouping pattern}).
        """
        pack_meshes = []
        pack_instances = []
        units = []
        sig = {}
        for slot, mv in self._meshes.items():
            iv = self._instances.get(slot)
            skinnable = self.settings.enable_skinning and mv.has_skin
            morphable = mv.has_morphs
            if iv is None or iv.count == 0 or not (skinnable or morphable):
                pack_meshes.append((slot, slot))
                if iv is not None and iv.count > 0:
                    pack_instances.append((slot, iv.matrices))
                continue
            count = iv.count
            # ONE source of truth for grouping: set_3d_instances compares
            # _pattern(_group_keys(_deform_sids_wrows(...))) against the
            # sig produced here — both sides must run the same helpers
            sids, wrows = _deform_sids_wrows(
                mv, iv, self.settings.enable_skinning)
            keys = _group_keys(sids, wrows, count)
            uniq: Dict = {}
            gidx = []
            for i, k in enumerate(keys):
                if k not in uniq:
                    uniq[k] = (len(uniq), i)
                gidx.append(uniq[k][0])
            sig[slot] = tuple(gidx)
            gidx = np.asarray(gidx)
            for (sid, _), (g, first) in uniq.items():
                ps = slot if len(uniq) == 1 else _pseudo_slot(slot, g)
                pack_meshes.append((ps, slot))
                pack_instances.append((ps, iv.matrices[gidx == g]))
                units.append(dict(
                    pack_slot=ps, slot=slot, sid=sid, w_row=first,
                    has_skin=skinnable and sid >= 0 and sid in self._skins,
                ))
        return pack_meshes, pack_instances, units, sig

    def _unit_deform_host(self, unit) -> Optional[Tuple]:
        """Host-side deformation for one unit at pack time -> (positions,
        (normals, tangents) or None), or None if the unit is at rest."""
        mv = self._meshes[unit["slot"]]
        pos = None
        nrm0 = tan0 = None
        if mv.has_morphs:
            iv = self._instances[unit["slot"]]
            mw = iv.morph_weights
            if mw is not None and mw.shape[0]:
                w = mw[min(unit["w_row"], mw.shape[0] - 1),
                       : mv.morph_targets.shape[0]]
                if np.any(w):  # glTF: morphs apply before the skin
                    pos = (mv.positions
                           + np.einsum("k,kvc->vc", w, mv.morph_targets))
                    # NORMAL/TANGENT deltas displace then renormalize
                    if mv.morph_normals is not None:
                        n = mv.normals + np.einsum(
                            "k,kvc->vc", w, mv.morph_normals)
                        ln = np.linalg.norm(n, axis=-1, keepdims=True)
                        nrm0 = np.where(ln > 1e-12,
                                        n / np.maximum(ln, 1e-12),
                                        mv.normals).astype(np.float32)
                    if mv.morph_tangents is not None:
                        t = mv.tangents[:, :3] + np.einsum(
                            "k,kvc->vc", w, mv.morph_tangents)
                        lt = np.linalg.norm(t, axis=-1, keepdims=True)
                        t = np.where(lt > 1e-12, t / np.maximum(lt, 1e-12),
                                     mv.tangents[:, :3])
                        tan0 = np.concatenate(
                            [t, mv.tangents[:, 3:4]], axis=1
                        ).astype(np.float32)
        attrs = None
        if unit["has_skin"]:
            pos, nrm, tan = skin_mesh_attributes(
                mv, self._skins[unit["sid"]].joint_matrices, positions=pos,
                normals=nrm0, tangents=tan0)
            attrs = (nrm, tan)
        elif nrm0 is not None or tan0 is not None:
            attrs = (nrm0 if nrm0 is not None else mv.normals,
                     tan0 if tan0 is not None else mv.tangents)
        if pos is None:
            return None
        return pos.astype(np.float32), attrs

    def _rebuild_scene(self) -> None:
        pack_meshes, instances, units, sig = self._instance_layout()
        self._group_sig = sig
        deformed: Dict[int, np.ndarray] = {}
        deformed_attrs: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        unit_by_ps = {u["pack_slot"]: u for u in units}
        meshes = []
        blas_out: Dict = {}
        for ps, slot in pack_meshes:
            mv = self._meshes[slot]
            u = unit_by_ps.get(ps)
            if u is not None:
                d = self._unit_deform_host(u)
                if d is not None:
                    deformed[ps] = d[0]
                    if d[1] is not None:
                        deformed_attrs[ps] = d[1]
            # groups share the real slot's rest-topology BLAS
            meshes.append((ps, _mesh_from_view(mv), self._blas_cache.get(slot)))
        ranges: Dict = {}
        scene = pack_trace_scene(
            meshes, instances, deformed_positions=deformed,
            deformed_attrs=deformed_attrs, built_blas_out=blas_out,
            mesh_ranges_out=ranges,
        )
        # write fresh BLAS builds back under their REAL slot (groups of
        # one mesh share the rest topology; first group's build wins)
        ps_to_slot = dict(pack_meshes)
        for ps, bvh in blas_out.items():
            self._blas_cache.setdefault(ps_to_slot.get(ps, ps), bvh)
        # equality-gated upload: a skinned rebuild leaves most arenas
        # byte-identical; re-upload only fields that actually changed, or
        # that a device refit rewrote since the last pack
        if self._scene_host is not None and self._scene_dev is not None:
            self._scene_dev = update_scene(
                self._scene_host, self._scene_dev, scene, self.device,
                stale=self._dev_stale)
        else:
            self._scene_dev = scene_to_device(scene, self.device)
        self._dev_stale.clear()
        self._scene_host = scene
        self._motion = None  # arena capacities may have changed: re-arm
        self._motion_syncs = 0
        self._build_dynamic_plans(scene, ranges, units)
        _LOG.info(
            "scene packed: %d tris, %d instances", scene.num_triangles,
            scene.num_instances,
        )

    def _build_dynamic_plans(self, scene: TraceScene, ranges: Dict,
                             units: List[Dict]) -> None:
        """Build the device refit plans (render/refit_device.py) of every
        deform unit (one per distinct (mesh, skin, morph-weights) group,
        `_instance_layout`), so later skin/morph updates skip the host
        repack. Plans are static per arena layout; rebuilt with every full
        pack."""
        self._dyn = None
        if not self.settings.device_dynamics:
            return
        if scene.blas8_code.shape[1] != 8:
            # the refit-plan builder emits 8-wide schedules only; wider packs
            # (RFW_WIDE_ARITY) take the host repack route
            return
        plans, dyn_units = [], []
        for u in units:
            mv = self._meshes[u["slot"]]
            if not (u["has_skin"] or mv.has_morphs):
                continue  # rest-pose unit: nothing to refit
            ps = u["pack_slot"]
            if ps not in ranges or "inst" not in ranges[ps]:
                continue
            plan = refit_device.build_unit_plan(
                scene, ranges[ps], mv.positions, mv.normals, mv.tangents,
                mv.joints if u["has_skin"] else None,
                mv.weights if u["has_skin"] else None,
                mv.morph_targets if mv.has_morphs else None,
                mv.morph_normals if mv.has_morphs else None,
                mv.morph_tangents if mv.has_morphs else None,
            )
            lo, hi = ranges[ps]["inst"]
            plan = plan._replace(inst_rows=np.arange(lo, hi, dtype=np.int32))
            plans.append(refit_device.plan_to_device(plan, self.device))
            dyn_units.append(u)
        if not plans:
            return
        self._dyn = {
            "slots": {u["slot"] for u in dyn_units},
            "units": dyn_units,
            "plans": tuple(plans),
            "tlas_plan": refit_device.plan_to_device(
                refit_device.build_tlas_plan(scene), self.device),
        }

    def _apply_device_dynamics(self) -> None:
        """Per-frame dynamic sync: upload the joint matrices and morph
        weights (KBs) and run the device skin + refit."""
        poses, morphs = [], []
        for u in self._dyn["units"]:
            jm = None
            if u["has_skin"]:
                jm = to_tensor(np.asarray(self._skins[u["sid"]].joint_matrices,
                                          np.float32), self.device)
            poses.append(jm)
            mw = None
            mv = self._meshes[u["slot"]]
            if mv.has_morphs:
                m = mv.morph_targets.shape[0]
                w = self._instances[u["slot"]].morph_weights
                if w is not None and w.shape[0]:
                    row = min(u["w_row"], w.shape[0] - 1)
                    mw = np.asarray(w[row, :m], np.float32)
                else:
                    mw = np.zeros((m,), np.float32)
                mw = to_tensor(mw, self.device)
            morphs.append(mw)
        self._scene_dev = refit_device.apply_dynamic(
            self._scene_dev, self._dyn["plans"], self._dyn["tlas_plan"],
            poses, morphs)
        self._dev_stale |= set(refit_device.UNIT_FIELDS + refit_device.TLAS_FIELDS)

    def _aov_frame(self, res, mode: RenderMode) -> np.ndarray:
        H, W = self.height, self.width
        if mode == RenderMode.NORMAL:
            img = (res.normal.cpu().numpy().reshape(H, W, 3) * 0.5 + 0.5)
        elif mode == RenderMode.ALBEDO:
            img = res.albedo.cpu().numpy().reshape(H, W, 3)
        elif mode == RenderMode.GBUFFER:
            d = res.depth.cpu().numpy().reshape(H, W, 1)
            finite = d < 1e25
            dmax = d[finite].max() if finite.any() else 1.0
            img = np.repeat(np.where(finite, d / max(dmax, 1e-6), 1.0), 3, axis=-1)
        elif mode in (RenderMode.SSAO, RenderMode.FILTERED_SSAO):
            ao = res.ao.cpu().numpy().reshape(H, W, 1)
            if mode == RenderMode.FILTERED_SSAO:
                from scipy.ndimage import gaussian_filter

                ao = gaussian_filter(ao, sigma=(2, 2, 0))
            img = np.repeat(ao, 3, axis=-1)
        else:  # SCREEN_SPACE: world position, normalized
            p = res.position.cpu().numpy().reshape(H, W, 3)
            ext = np.abs(p).max() or 1.0
            img = p / ext * 0.5 + 0.5
        rgba = np.concatenate(
            [np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8),  # round, as
             # film.tonemap does
             np.full((H, W, 1), 255, np.uint8)], axis=-1
        )
        return rgba


def _default_materials() -> DeviceMaterials:
    from rfw_tpu_torch.scene.materials import Materials

    return Materials().to_device()
