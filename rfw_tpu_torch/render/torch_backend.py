"""TorchBackend — the Backend contract over the ported path tracer.

Counterpart of `rfw_tpu/render/tpu_backend.py::TpuBackend`: the same
14-method contract (crates/rfw-backend/src/lib.rs:35-82, here
`rfw_tpu_torch.backend.contract.Backend`) and the same state model
(reference 'backends are dumb caches invalidated by dirty bits'):
`set_*` stage host-side copies + dirty flags; `synchronize()` does the
heavy lifting once per frame —
  * CPU LBS skinning and morph targets for deformed meshes -> BLAS refit;
  * BLAS (re)build for changed meshes, cached per mesh slot;
  * `pack_trace_scene` -> an equality-gated upload of the packed arenas
    (only fields whose host array changed are re-sent);
  * instance-only motion -> `repack_instances` (host TLAS rebuild and its
    8-wide collapse) -> upload of the TLAS and instance fields;
  * material block / texture atlas / light buffers upload on change, each
    alone.
`render()` runs `samples_per_frame` progressive samples of
`render_sample`, tonemaps on the device (FXAA optional), composites the 2D
overlay on the host, and returns an (H, W, 4) uint8 frame. Progressive
accumulation resets when the camera or the scene changes (reference
RenderMode::Reset semantics, gpu-rt lib.rs:1690-1692).

Not ported yet (ROADMAP queue A, item 4: dynamics): the on-device skin,
morph and BVH refit (`TpuBackend._build_dynamic_plans`,
`_apply_device_dynamics`), the on-device instance-motion refit
(`_try_device_motion`) and the on-device TLAS build
(`build_tlas8_device`). So skin and morph syncs take the full host repack
and motion syncs `repack_instances` with the host TLAS collapse: the
routes `TpuBackend` takes with `device_dynamics=False,
device_motion=False`. `TorchSettings` refuses either switch.

The backend runs on the card unless the caller names another device
(`device="cpu"` runs the kernels' plain versions, as the tests do).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rfw_tpu_torch.accel.bvh_cpu import BvhNodes
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
from rfw_tpu_torch.render.pack import TraceScene, pack_trace_scene, repack_instances
from rfw_tpu_torch.render.wavefront import (
    RenderConfig, mat_feature_mask, render_sample, tex_kinds_mask,
)
from rfw_tpu_torch.utils import Averager, log

_LOG = log.get("torch_backend")

_NOT_PORTED = ("{} is not ported yet: the on-device dynamics (skin/morph refit, "
               "instance-motion TLAS refit) wait for ROADMAP queue A, item 4 "
               "(dynamics); leave it False")


@dataclass
class TorchSettings:
    """Runtime knobs (reference WgpuSettings, backends/wgpu/src/lib.rs:32-38):
    `TpuSettings`'s fields and defaults, but for `device_dynamics` and
    `device_motion`, which default to False and raise when set, and
    `motion_rebuild_every`/`motion_min_instances`, which only the device
    motion path reads and which come with it (see the module docstring)."""

    samples_per_frame: int = 1
    max_bounces: int = 3
    clamp: float = 10.0
    sky_intensity: float = 0.0
    exposure: float = 1.0
    tonemap: str = "aces"
    enable_skinning: bool = True
    device_dynamics: bool = False  # skin/morph + BVH refit on the device
    sampler: str = "sobol"  # "sobol" (low-discrepancy) | "random"
    fxaa: bool = False  # FXAA post-pass on the tonemapped frame (reference
    #   deferred_fxaa.frag)
    pixel_center: bool = False  # deterministic pixel-center primaries
    device_motion: bool = False  # instance-motion TLAS refit on the device

    def __post_init__(self) -> None:
        for name in ("device_dynamics", "device_motion"):
            if getattr(self, name):
                raise NotImplementedError(_NOT_PORTED.format(name))


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "TorchBackend runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain versions on the host")
    return torch.device("cuda", torch.cuda.current_device())


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
    replaces the rayon par_iter): the numpy path of `rfw_tpu`'s
    `apply_skin`. `positions` overrides the rest pose (glTF order: morph
    targets apply BEFORE the skin)."""
    p = mesh.positions if positions is None else positions
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
        self._morph_dirty: set = set()  # morph-weight-only changes
        #   (same grouping): a full repack until the device dynamics land

        self._group_sig: Dict[int, tuple] = {}  # per-slot grouping pattern
        #   of the last pack (_instance_layout); a pattern change forces a
        #   full repack

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
                    # weight-only deformation, same grouping
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
        t0 = time.perf_counter()
        # skinned meshes force a geometry refresh when their skin updated
        skinned_dirty = any(
            m.has_skin for m in self._meshes.values()
        ) and bool(self._skin_dirty)
        morph_dirty = bool(self._morph_dirty)
        if self._geo_dirty or skinned_dirty or morph_dirty:
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
        if self.device.type == "cuda":  # the clock stops after the uploads
            torch.cuda.synchronize(self.device)
        self.stats["sync_ms"].add((time.perf_counter() - t0) * 1e3)

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
            self._rebuild_scene()
            return
        meshes_info = [
            (ps, self._meshes[slot].aabb_min, self._meshes[slot].aabb_max)
            for ps, slot in pack_meshes
        ]
        new_host = repack_instances(self._scene_host, meshes_info, instances)
        self._scene_dev = self._scene_dev._replace(**{
            f: to_tensor(getattr(new_host, f), self.device) for f in _INSTANCE_FIELDS})
        self._scene_host = new_host

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
        if self._scene_dev is None or self._scene_dev.inst_matrix.shape[0] == 0:
            return np.zeros((self.height, self.width, 4), np.uint8)
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

        t0 = time.perf_counter()
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
        view_dev = torch.from_numpy(view_arr).to(dev)
        sky_tex = (torch.tensor([self._sky_tex_id], dtype=torch.int32, device=dev)
                   if self._sky_tex_id >= 0 else None)
        last = None
        for s in range(self.settings.samples_per_frame):
            res = render_sample(
                self._scene_dev, self._mats_dev, self._atlas_dev, self._lights_dev,
                view_dev, self.width, self.height, cfg, sky_tex=sky_tex,
                sample_index=self._spp + s,
            )
            film_mod.add_sample(self._film, res.radiance)
            last = res
        self._spp += self.settings.samples_per_frame

        # AOV debug views (reference RenderMode -> G-buffer channels)
        if mode in (RenderMode.NORMAL, RenderMode.ALBEDO, RenderMode.GBUFFER,
                    RenderMode.SCREEN_SPACE, RenderMode.SSAO,
                    RenderMode.FILTERED_SSAO) and last is not None:
            frame = self._aov_frame(last, mode)
        else:
            frame = film_mod.tonemap(
                self._film, float(self._spp), self.width, self.height,
                exposure=self.settings.exposure, mode=self.settings.tonemap,
                fxaa=self.settings.fxaa,
            ).cpu().numpy()

        # the frame is on the host: the device work is done
        dt = time.perf_counter() - t0
        self.stats["render_ms"].add(dt * 1e3)
        rays = (self.width * self.height * self.settings.samples_per_frame
                * 2 * (self.settings.max_bounces + 1))
        self.stats["mrays_per_s"].add(rays / max(dt, 1e-9) / 1e6)
        self.stats["spp_total"] = self._spp

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
        scene = pack_trace_scene(
            meshes, instances, deformed_positions=deformed,
            deformed_attrs=deformed_attrs, built_blas_out=blas_out,
        )
        # write fresh BLAS builds back under their REAL slot (groups of
        # one mesh share the rest topology; first group's build wins)
        ps_to_slot = dict(pack_meshes)
        for ps, bvh in blas_out.items():
            self._blas_cache.setdefault(ps_to_slot.get(ps, ps), bvh)
        # equality-gated upload: a skinned rebuild leaves most arenas
        # byte-identical; re-upload only fields that actually changed
        if self._scene_host is not None and self._scene_dev is not None:
            self._scene_dev = update_scene(
                self._scene_host, self._scene_dev, scene, self.device)
        else:
            self._scene_dev = scene_to_device(scene, self.device)
        self._scene_host = scene
        _LOG.info(
            "scene packed: %d tris, %d instances", scene.num_triangles,
            scene.num_instances,
        )

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
