"""CpuReferenceBackend — the numpy pixel oracle behind the Backend seam.

Host copy of `rfw_tpu/render/cpu_reference.py` with its imports rewritten
to `rfw_tpu_torch`: an independent, slow, obviously-correct renderer that
implements the same 14-method contract as `TorchBackend` (reference Backend
trait, crates/rfw-backend/src/lib.rs:35-82; the reference's own "second
implementation of the same trait" is the cpu-rt backend). Its job is
end-to-end pixel parity tests: configs render through BOTH backends and
must agree — exactly (<=1e-3 RMSE) for the noise-free AOV modes,
statistically for the path-traced DEFAULT mode (both estimators are
unbiased, so means converge to the same image). It is a CPU oracle by
design: it takes no device and is not on the card's render path.

Two deviations from the original:
  * `brute_force_closest` (with `T_MIN`/`T_MAX`) is a private numpy copy of
    `rfw_tpu/render/intersect.py:45-86`, whose module imports jax. It is
    not the port's torch `render/intersect.py::brute_force_closest`: the
    oracle stays independent of the code under test.
  * its settings type is `TorchSettings`, which has every field it reads
    (`enable_skinning`, `sky_intensity`, `samples_per_frame`, `exposure`,
    `max_bounces`, `clamp`).

Design choices that make it an oracle rather than a port of the device
path:
  * world-space triangle soup per frame (instances flattened, skinning
    applied) — no BVH, no packed arenas: brute-force O(R*T) closest hit;
  * NEE-only estimator: emitted radiance is collected at the first hit
    (and after delta glass bounces, where NEE cannot reach), and every
    bounce adds direct light from an explicit loop over ALL lights (one
    area sample each) — a different decomposition than the integrator's
    power-CDF pick + MIS, unbiased for these BSDFs;
  * plain numpy RNG (Philox via default_rng), no Sobol;
  * pixel-center primaries by default (deterministic AOVs).

Scope: the full Backend contract, including the 2D overlay (an
independent full-frame edge-function rasterizer — nothing shared with
render/overlay.py's bbox-scan fill).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from rfw_tpu_torch.backend.contract import RenderMode
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
    MATFLAG_EMISSIVE,
    MeshView2D,
    MeshView3D,
    SkinView,
    TextureView,
)
from rfw_tpu_torch.render.torch_backend import TorchSettings

PI = np.float32(np.pi)

# the reference constants (rfw-scene/src/constants.rs:1-4), as in
# rfw_tpu/render/intersect.py
T_MIN = 1e-5
T_MAX = 1e26


# ------------------------------------------------------- brute-force oracle
def brute_force_closest(
    ray_o: np.ndarray, ray_d: np.ndarray,
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
    t_min: float = T_MIN, t_max: float = T_MAX,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Numpy oracle: closest hit of R rays against T triangles, O(R*T).

    Returns (t, prim, u, v); prim == -1 for miss. Batched over triangles to
    bound memory."""
    R = ray_o.shape[0]
    best_t = np.full(R, t_max, np.float32)
    best_p = np.full(R, -1, np.int32)
    best_u = np.zeros(R, np.float32)
    best_v = np.zeros(R, np.float32)
    CHUNK = max(1, 8_000_000 // max(R, 1))
    for s in range(0, v0.shape[0], CHUNK):
        tv0 = v0[s : s + CHUNK]
        te1 = e1[s : s + CHUNK]
        te2 = e2[s : s + CHUNK]
        # Moller-Trumbore, broadcast (R,1,3) x (1,T,3)
        pvec = np.cross(ray_d[:, None, :], te2[None, :, :])
        det = np.sum(te1[None] * pvec, axis=-1)
        inv_det = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
        tvec = ray_o[:, None, :] - tv0[None]
        u = np.sum(tvec * pvec, axis=-1) * inv_det
        qvec = np.cross(tvec, te1[None])
        v = np.sum(ray_d[:, None, :] * qvec, axis=-1) * inv_det
        t = np.sum(te2[None] * qvec, axis=-1) * inv_det
        hit = (
            (np.abs(det) > 1e-12)
            & (u >= -1e-7) & (v >= -1e-7) & (u + v <= 1 + 1e-7)
            & (t > t_min) & (t < best_t[:, None])
        )
        t_masked = np.where(hit, t, np.inf)
        j = np.argmin(t_masked, axis=1)
        rows = np.arange(R)
        better = t_masked[rows, j] < best_t
        best_t = np.where(better, t[rows, j], best_t)
        best_p = np.where(better, (s + j).astype(np.int32), best_p)
        best_u = np.where(better, u[rows, j], best_u)
        best_v = np.where(better, v[rows, j], best_v)
    return best_t, best_p, best_u, best_v


def _oracle_skin(mv: MeshView3D, joint_matrices: np.ndarray,
                 positions: np.ndarray, base_n=None, base_t=None):
    """Independent LBS (positions + normals + tangents) for the oracle —
    deliberately NOT shared with the backends' apply_skin/skin_mesh_attributes
    so a skinning bug on the product path cannot hide behind a correlated
    oracle. Normal matrix built from the explicit adjugate (cofactor)
    rather than np.linalg.inv; reference semantics structs.rs:785-877."""
    B4 = np.einsum("vj,vjab->vab", mv.weights,
                   joint_matrices[mv.joints])  # (V,4,4)
    pos = np.einsum("vab,vb->va", B4[:, :3, :3], positions) + B4[:, :3, 3]
    # unweighted vertices keep the rest pose (matches product + device)
    has_w = mv.weights.sum(axis=-1) > 1e-8
    pos = np.where(has_w[:, None], pos, positions)

    m = B4[:, :3, :3]
    # adjugate^T rows = cross products of m's rows: adjT = cof(m), and
    # n' ~ cof(m) @ n  (== det * inv(m)^T @ n, same direction up to det sign)
    c0 = np.cross(m[:, 1], m[:, 2])
    c1 = np.cross(m[:, 2], m[:, 0])
    c2 = np.cross(m[:, 0], m[:, 1])
    cof = np.stack([c0, c1, c2], axis=1)  # (V,3,3) rows r1xr2, r2xr0, r0xr1
    det = np.einsum("va,va->v", m[:, 0], c0)
    bn = mv.normals if base_n is None else base_n
    bt = mv.tangents if base_t is None else base_t
    n = np.einsum("vab,vb->va", cof, bn) * np.sign(det)[:, None]
    nl = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(nl > 1e-12, n / np.maximum(nl, 1e-12), bn)

    t = np.einsum("vab,vb->va", m, bt[:, :3])
    tl = np.linalg.norm(t, axis=-1, keepdims=True)
    t = np.where(tl > 1e-12, t / np.maximum(tl, 1e-12), bt[:, :3])
    tan = np.concatenate(
        [t, bt[:, 3:4] * np.where(det[:, None] < 0, -1.0, 1.0)],
        axis=1)
    return (pos.astype(np.float32), n.astype(np.float32),
            tan.astype(np.float32))


# --------------------------------------------------------------- BSDF (numpy)
def _schlick(x):
    m = np.clip(1.0 - x, 0.0, 1.0)
    return m * m * m * m * m


def _luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _gtr2(ndh, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndh * ndh
    return a2 / (PI * t * t + 1e-12)


def _smith_ggx(ndv, a):
    a2 = a * a
    b = ndv * ndv
    return 1.0 / (ndv + np.sqrt(a2 + b - a2 * b) + 1e-12)


def _gtr1(ndh, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndh * ndh
    return np.where(a >= 1.0, 1.0 / PI, (a2 - 1.0) / (PI * np.log(a2) * t))


def disney_eval_np(base_color, metallic, roughness, specular_f,
                   specular_tint, sheen, sheen_tint, subsurface,
                   wo, wi, clearcoat=None, clearcoat_gloss=None) -> np.ndarray:
    """Numpy transcription of render.disney.disney_eval (all reflection
    lobes incl. the GTR1 clearcoat; transmission is blended externally by
    the integrator loop, matching the product's trans_w factoring).
    Local frame, +z = shading normal."""
    ndv = wo[..., 2]
    ndl = wi[..., 2]
    up = (ndv > 1e-6) & (ndl > 1e-6)
    h = wi + wo
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    ndh = h[..., 2]
    ldh = np.sum(wi * h, axis=-1)

    lum = _luminance(base_color)[..., None]
    ctint = np.where(lum > 0, base_color / np.maximum(lum, 1e-7), 1.0)
    f0_base = 0.08 * specular_f
    cspec0 = (
        f0_base[..., None]
        * ((1.0 - specular_tint[..., None]) + specular_tint[..., None] * ctint)
        * (1.0 - metallic[..., None])
        + base_color * metallic[..., None]
    )
    csheen = (1.0 - sheen_tint[..., None]) + sheen_tint[..., None] * ctint

    fl = _schlick(ndl)
    fv = _schlick(ndv)
    fd90 = 0.5 + 2.0 * ldh * ldh * roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = ldh * ldh * roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / np.maximum(ndl + ndv, 1e-6) - 0.5) + 0.5)
    diffuse_w = np.where(subsurface > 0, (1.0 - subsurface) * fd + subsurface * ss, fd)
    f_diffuse = (base_color / PI) * diffuse_w[..., None]

    fh = _schlick(ldh)
    f_sheen = fh[..., None] * sheen[..., None] * csheen

    alpha = np.maximum(1e-3, roughness * roughness)
    ds = _gtr2(ndh, alpha)
    fs = cspec0 + (1.0 - cspec0) * fh[..., None]
    gs = _smith_ggx(ndl, alpha) * _smith_ggx(ndv, alpha)
    f_spec = ds[..., None] * fs * gs[..., None]

    f = (f_diffuse + f_sheen) * (1.0 - metallic[..., None]) + f_spec
    if clearcoat is not None:
        a_cc = 0.1 * (1.0 - clearcoat_gloss) + 0.001 * clearcoat_gloss
        dr = _gtr1(ndh, a_cc)
        fr = 0.04 + 0.96 * fh
        gr = _smith_ggx(ndl, 0.25) * _smith_ggx(ndv, 0.25)
        f = f + (0.25 * clearcoat * dr * fr * gr)[..., None]
    return np.where(up[..., None], f, 0.0).astype(np.float32)


# ------------------------------------------------------------------- backend
class CpuReferenceBackend:
    """Numpy oracle implementing the Backend contract (see module doc)."""

    @classmethod
    def from_window_handle(cls, window, width=None, height=None,
                           scale=None, settings=None):
        """FromWindowHandle ctor (reference rfw-backend/src/lib.rs:26-33)."""
        from rfw_tpu_torch.backend.contract import init_from_window_handle

        return init_from_window_handle(cls, window, width, height, scale,
                                       settings)

    def __init__(self, width: int = 256, height: int = 256,
                 settings: Optional[TorchSettings] = None) -> None:
        self.settings = settings or TorchSettings()
        self.width = width
        self.height = height
        #: deterministic pixel-center primaries (set False for AA jitter)
        self.pixel_center = True
        self.rng = np.random.default_rng(1234)

        self._meshes: Dict[int, MeshView3D] = {}
        self._instances: Dict[int, InstancesView3D] = {}
        self._meshes_2d: Dict[int, MeshView2D] = {}
        self._instances_2d: Dict[int, InstancesView2D] = {}
        self._skins: Dict[int, SkinView] = {}
        self._materials: Optional[DeviceMaterials] = None
        self._textures: Dict[int, TextureView] = {}
        self._point = PointLightsView.empty()
        self._spot = SpotLightsView.empty()
        self._area = AreaLightsView.empty()
        self._directional = DirectionalLightsView.empty()
        self._skybox: Optional[TextureView] = None

        self._world = None  # flattened scene dict after synchronize()

    # ---- contract: geometry ------------------------------------------
    def set_3d_meshes(self, changed: Sequence[Tuple[int, MeshView3D]]) -> None:
        for i, v in changed:
            self._meshes[i] = v

    def unload_3d_meshes(self, ids: Sequence[int]) -> None:
        for i in ids:
            self._meshes.pop(i, None)
            self._instances.pop(i, None)

    def set_3d_instances(self, changed: Sequence[Tuple[int, InstancesView3D]]) -> None:
        for i, v in changed:
            self._instances[i] = v

    def set_2d_meshes(self, changed: Sequence[Tuple[int, MeshView2D]]) -> None:
        for i, v in changed:
            self._meshes_2d[i] = v

    def set_2d_instances(self, changed: Sequence[Tuple[int, InstancesView2D]]) -> None:
        for i, v in changed:
            self._instances_2d[i] = v

    def set_materials(self, materials: DeviceMaterials, changed: Sequence[int]) -> None:
        self._materials = materials

    def set_textures(self, changed: Sequence[Tuple[int, TextureView]]) -> None:
        for i, v in changed:
            self._textures[i] = v

    def set_skybox(self, skybox: Optional[TextureView]) -> None:
        self._skybox = skybox

    def set_point_lights(self, lights: PointLightsView) -> None:
        self._point = lights

    def set_spot_lights(self, lights: SpotLightsView) -> None:
        self._spot = lights

    def set_area_lights(self, lights: AreaLightsView) -> None:
        self._area = lights

    def set_directional_lights(self, lights: DirectionalLightsView) -> None:
        self._directional = lights

    def set_skins(self, changed: Sequence[Tuple[int, SkinView]]) -> None:
        for i, v in changed:
            self._skins[i] = v

    def resize(self, width: int, height: int, scale: float = 1.0) -> None:
        self.width = int(width * scale)
        self.height = int(height * scale)

    # ---- synchronize: flatten to a world-space soup -------------------
    def synchronize(self) -> None:
        v0s, e1s, e2s = [], [], []
        n0s, n1s, n2s = [], [], []
        uv0s, uv1s, uv2s = [], [], []
        tgs = []
        mats, lids = [], []
        for slot, iv in self._instances.items():
            if slot not in self._meshes or iv.count == 0:
                continue
            mv = self._meshes[slot]
            idx = mv.indices
            u0, u1, u2 = (mv.uvs[idx[:, k]] for k in range(3))

            # per-INSTANCE deformation (reference instances carry their own
            # skin_ids / node weights, rfw-scene/src/instances_3d.rs:10-322),
            # memoized by (skin id, weight bytes) so identical poses skin once
            deform_cache: Dict[Tuple[int, bytes], Tuple] = {}

            def _deformed(i):
                sid = -1
                if (mv.has_skin and self.settings.enable_skinning
                        and i < len(iv.skin_ids)):
                    sid = int(iv.skin_ids[i])
                wrow = b""
                w = None
                if (mv.has_morphs and iv.morph_weights is not None
                        and i < iv.morph_weights.shape[0]):
                    w = iv.morph_weights[i, : mv.morph_targets.shape[0]]
                    wrow = w.tobytes()
                key = (sid, wrow)
                if key in deform_cache:
                    return deform_cache[key]
                pos = mv.positions
                nrm, tangents = mv.normals, mv.tangents
                if w is not None and np.any(w):  # glTF: morphs before the skin
                    pos = pos + np.einsum("k,kvc->vc", w, mv.morph_targets)
                    # NORMAL/TANGENT deltas: displace then renormalize
                    if mv.morph_normals is not None:
                        n = nrm + np.einsum("k,kvc->vc", w, mv.morph_normals)
                        ln = np.linalg.norm(n, axis=-1, keepdims=True)
                        nrm = np.where(ln > 1e-12,
                                       n / np.maximum(ln, 1e-12), nrm)
                    if mv.morph_tangents is not None:
                        t = tangents[:, :3] + np.einsum(
                            "k,kvc->vc", w, mv.morph_tangents)
                        lt = np.linalg.norm(t, axis=-1, keepdims=True)
                        t = np.where(lt > 1e-12, t / np.maximum(lt, 1e-12),
                                     tangents[:, :3])
                        tangents = np.concatenate(
                            [t, tangents[:, 3:4]], axis=1)
                if sid >= 0 and sid in self._skins:
                    pos, nrm, tangents = _oracle_skin(
                        mv, self._skins[sid].joint_matrices, pos,
                        base_n=nrm, base_t=tangents)
                out = (
                    pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]],
                    nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]],
                    tangents[idx[:, 0]],  # corner-0 tangent xyz + handed
                )
                deform_cache[key] = out
                return out

            for i, m in enumerate(iv.matrices):
                p0, p1, p2, n0, n1, n2, tg0 = _deformed(i)
                r, t = m[:3, :3], m[:3, 3]
                nrm = np.linalg.inv(r).T  # normal matrix
                w0 = p0 @ r.T + t
                v0s.append(w0)
                e1s.append((p1 - p0) @ r.T)
                e2s.append((p2 - p0) @ r.T)
                n0s.append(n0 @ nrm.T)
                n1s.append(n1 @ nrm.T)
                n2s.append(n2 @ nrm.T)
                uv0s.append(u0)
                uv1s.append(u1)
                uv2s.append(u2)
                tgs.append(np.concatenate(
                    [tg0[:, :3] @ r.T, tg0[:, 3:4]], axis=1))
                mats.append(mv.tri_material)
                lids.append(mv.tri_light)
        if not v0s:
            self._world = None
            return
        self._world = dict(
            v0=np.concatenate(v0s).astype(np.float32),
            e1=np.concatenate(e1s).astype(np.float32),
            e2=np.concatenate(e2s).astype(np.float32),
            n0=np.concatenate(n0s).astype(np.float32),
            n1=np.concatenate(n1s).astype(np.float32),
            n2=np.concatenate(n2s).astype(np.float32),
            uv0=np.concatenate(uv0s).astype(np.float32),
            uv1=np.concatenate(uv1s).astype(np.float32),
            uv2=np.concatenate(uv2s).astype(np.float32),
            tg=np.concatenate(tgs).astype(np.float32),
            mat=np.concatenate(mats).astype(np.int32),
            light=np.concatenate(lids).astype(np.int32),
        )

    # ---- rendering -----------------------------------------------------
    def _primary_rays(self, view: CameraView3D) -> Tuple[np.ndarray, np.ndarray]:
        W, H = self.width, self.height
        n = W * H
        px = (np.arange(n) % W).astype(np.float32)
        py = (np.arange(n) // W).astype(np.float32)
        if self.pixel_center:
            ju = jv = 0.5
        else:
            j = self.rng.random((n, 2), dtype=np.float32)
            ju, jv = j[:, 0], j[:, 1]
        r = (px + ju) * view.inv_width
        s = (py + jv) * view.inv_height
        target = view.p1[None] + r[:, None] * view.right[None] + s[:, None] * view.up[None]
        o = np.broadcast_to(view.pos[None], (n, 3)).astype(np.float32)
        d = target - o
        d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        return o.copy(), d.astype(np.float32)

    def _shade_point(self, w, ray_d, prim, u, v):
        """Interpolated shading attrs for hit triangles. Normal orientation
        matches wavefront._shading_basis: ng faces the ray, ns agrees with
        ng."""
        b0 = (1.0 - u - v)[:, None]
        ns = b0 * w["n0"][prim] + u[:, None] * w["n1"][prim] + v[:, None] * w["n2"][prim]
        ns /= np.maximum(np.linalg.norm(ns, axis=-1, keepdims=True), 1e-12)
        uv = (b0 * w["uv0"][prim] + u[:, None] * w["uv1"][prim]
              + v[:, None] * w["uv2"][prim])
        ng = np.cross(w["e1"][prim], w["e2"][prim])
        ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-12)
        flip = np.sum(ng * ray_d, -1) > 0
        entering = ~flip  # front-face hit (pre-flip geometric normal)
        ng = np.where(flip[:, None], -ng, ng)
        ns = np.where(np.sum(ns * ng, -1)[:, None] < 0, -ns, ns)
        # tangent frame (matches wavefront._shading_basis: Gram-Schmidt the
        # corner-0 tangent against ns, fallback frame where degenerate)
        tg = w["tg"][prim]
        tan = tg[:, :3] - ns * np.sum(tg[:, :3] * ns, -1, keepdims=True)
        tlen = np.linalg.norm(tan, axis=-1, keepdims=True)
        t_fb, _ = _frames(ns)
        tan = np.where(tlen > 1e-6, tan / np.maximum(tlen, 1e-12), t_fb)
        bitan = np.cross(ns, tan) * tg[:, 3:4]
        ns = ns.astype(np.float32)
        return ns, ng.astype(np.float32), uv.astype(np.float32), \
            tan.astype(np.float32), bitan.astype(np.float32), entering

    def _albedo(self, mat_id, uv) -> np.ndarray:
        m = self._materials
        color = m.color[mat_id][:, :3].copy()
        tex_id = m.tex[mat_id][:, 0]
        has = tex_id >= 0
        if has.any():
            for t in np.unique(tex_id[has]):
                sel = np.where(tex_id == t)[0]
                tv = self._textures.get(int(t))
                if tv is None:
                    continue
                img = tv.mips[0].astype(np.float32) / 255.0
                if tv.srgb:
                    img = np.where(img <= 0.04045, img / 12.92,
                                   ((img + 0.055) / 1.055) ** 2.4)
                h, wd = img.shape[:2]
                # bilinear, wrap
                fu = (uv[sel, 0] % 1.0) * wd - 0.5
                fv = (uv[sel, 1] % 1.0) * h - 0.5
                x0 = np.floor(fu).astype(int)
                y0 = np.floor(fv).astype(int)
                ax = (fu - x0)[:, None]
                ay = (fv - y0)[:, None]
                x0 %= wd
                y0 %= h
                x1 = (x0 + 1) % wd
                y1 = (y0 + 1) % h
                texel = (
                    img[y0, x0, :3] * (1 - ax) * (1 - ay)
                    + img[y0, x1, :3] * ax * (1 - ay)
                    + img[y1, x0, :3] * (1 - ax) * ay
                    + img[y1, x1, :3] * ax * ay
                )
                color[sel] *= texel
        return color.astype(np.float32)

    def _sky(self, d: np.ndarray) -> np.ndarray:
        """Sky radiance for miss directions: constant, or the equirect
        env map (same mapping as the integrator: u = atan2(z,x)/2pi+0.5,
        v = acos(y)/pi; bilinear, sRGB-decoded)."""
        base = float(self.settings.sky_intensity)
        if self._skybox is None:
            return np.full((d.shape[0], 3), base, np.float32)
        img = self._skybox.mips[0].astype(np.float32) / 255.0
        if getattr(self._skybox, "srgb", True):
            img = np.where(img <= 0.04045, img / 12.92,
                           ((img + 0.055) / 1.055) ** 2.4)
        h, wd = img.shape[:2]
        u = np.arctan2(d[:, 2], d[:, 0]) / (2.0 * np.pi) + 0.5
        v = np.arccos(np.clip(d[:, 1], -1.0, 1.0)) / np.pi
        fu = (u % 1.0) * wd - 0.5
        fv = (v % 1.0) * h - 0.5
        x0 = np.floor(fu).astype(int) % wd
        y0 = np.floor(fv).astype(int) % h
        ax = (fu - np.floor(fu))[:, None]
        ay = (fv - np.floor(fv))[:, None]
        x1 = (x0 + 1) % wd
        y1 = (y0 + 1) % h
        texel = (img[y0, x0, :3] * (1 - ax) * (1 - ay)
                 + img[y0, x1, :3] * ax * (1 - ay)
                 + img[y1, x0, :3] * (1 - ax) * ay
                 + img[y1, x1, :3] * ax * ay)
        return (texel * base).astype(np.float32)

    def _occluded(self, o, d, dist) -> np.ndarray:
        w = self._world
        t, prim, _, _ = brute_force_closest(
            o, d, w["v0"], w["e1"], w["e2"], t_min=T_MIN,
        )
        return (prim >= 0) & (t < dist * (1.0 - 1e-4))

    def _direct_light(self, p, ns, wo_world, mat_cols) -> np.ndarray:
        """Sum of direct radiance over ALL lights (one area sample each)."""
        R = p.shape[0]
        total = np.zeros((R, 3), np.float32)
        eps = 1e-3
        # all light vectors measured from the OFFSET shadow origin — else a
        # sample point on the light itself lands at t = dist - eps*cos and
        # the light occludes its own shadow ray
        p = p + ns * eps

        def add(wi, dist, radiance):
            cos_l = np.sum(wi * ns, -1)
            ok = cos_l > 1e-6
            occ = self._occluded(p[ok], wi[ok], dist[ok])
            f = self._eval_bsdf(mat_cols, ns, wo_world, wi)
            contrib = f * (cos_l * ok)[:, None] * radiance
            contrib[np.where(ok)[0][occ]] = 0.0
            total[:] += np.nan_to_num(contrib)

        for i in range(self._point.count):
            vec = self._point.position[i][None] - p
            d2 = np.maximum(np.sum(vec * vec, -1), 1e-8)
            wi = vec / np.sqrt(d2)[:, None]
            add(wi, np.sqrt(d2), self._point.energy[i][None] / d2[:, None])
        for i in range(self._spot.count):
            vec = self._spot.position[i][None] - p
            d2 = np.maximum(np.sum(vec * vec, -1), 1e-8)
            wi = vec / np.sqrt(d2)[:, None]
            cos_to = np.sum(-wi * self._spot.direction[i][None], -1)
            ci = self._spot.cos_inner[i]
            co = self._spot.cos_outer[i]
            # linear cone falloff — reference gpu-rt shade.comp:315-318 /
            # wgpu lighting.comp:109-122
            fall = np.clip((cos_to - co) / max(ci - co, 1e-6), 0.0, 1.0)
            add(wi, np.sqrt(d2),
                self._spot.energy[i][None] * (fall / d2)[:, None])
        for i in range(self._directional.count):
            wi = np.broadcast_to(-self._directional.direction[i][None], p.shape)
            add(wi.astype(np.float32), np.full(p.shape[0], T_MAX * 0.5, np.float32),
                np.broadcast_to(self._directional.energy[i][None], p.shape))
        for i in range(self._area.count):
            u = self.rng.random((R, 2), dtype=np.float32)
            su = np.sqrt(u[:, 0])
            b0 = 1.0 - su
            b1 = u[:, 1] * su
            pt = (self._area.v0[i][None] * b0[:, None]
                  + self._area.v1[i][None] * b1[:, None]
                  + self._area.v2[i][None] * (1 - b0 - b1)[:, None])
            vec = pt - p
            d2 = np.maximum(np.sum(vec * vec, -1), 1e-8)
            dist = np.sqrt(d2)
            wi = vec / dist[:, None]
            cos_l = np.abs(np.sum(-wi * self._area.normal[i][None], -1))
            pdf_sa = d2 / np.maximum(cos_l * self._area.area[i], 1e-8)
            add(wi, dist,
                self._area.radiance[i][None] / np.maximum(pdf_sa, 1e-8)[:, None])
        return total

    def _normal_map(self, mat_id, uv, ns, tan, bitan):
        """Apply tangent-space normal maps (linear data; matches the
        integrator's n_ts transform)."""
        m = self._materials
        tex_id = m.tex[mat_id][:, 1]
        has = tex_id >= 0
        if not has.any():
            return ns
        out = ns.copy()
        for t in np.unique(tex_id[has]):
            sel = np.where(tex_id == t)[0]
            tv = self._textures.get(int(t))
            if tv is None:
                continue
            img = tv.mips[0].astype(np.float32) / 255.0  # linear (srgb=False)
            h, wd = img.shape[:2]
            fu = (uv[sel, 0] % 1.0) * wd - 0.5
            fv = (uv[sel, 1] % 1.0) * h - 0.5
            x0 = np.floor(fu).astype(int) % wd
            y0 = np.floor(fv).astype(int) % h
            ax = (fu - np.floor(fu))[:, None]
            ay = (fv - np.floor(fv))[:, None]
            x1 = (x0 + 1) % wd
            y1 = (y0 + 1) % h
            texel = (img[y0, x0, :3] * (1 - ax) * (1 - ay)
                     + img[y0, x1, :3] * ax * (1 - ay)
                     + img[y1, x0, :3] * (1 - ax) * ay
                     + img[y1, x1, :3] * ax * ay)
            n_ts = texel * 2.0 - 1.0
            nw = (n_ts[:, 0:1] * tan[sel] + n_ts[:, 1:2] * bitan[sel]
                  + n_ts[:, 2:3] * ns[sel])
            nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)
            out[sel] = nw
        return out.astype(np.float32)

    def _mat_cols(self, mat_id, uv):
        m = self._materials
        par = m.params[mat_id]
        return dict(
            base=self._albedo(mat_id, uv),
            metallic=par[:, 0], subsurface=par[:, 1], specular_f=par[:, 2],
            roughness=par[:, 3], specular_tint=par[:, 4],
            sheen=par[:, 6], sheen_tint=par[:, 7],
            clearcoat=par[:, 8], clearcoat_gloss=par[:, 9],
            emissive=(m.flags[mat_id] & MATFLAG_EMISSIVE) != 0,
            emission=m.color[mat_id][:, :3],
            transmission=par[:, 10], eta=np.where(par[:, 11] > 1e-3,
                                                  par[:, 11], 1.5),
            absorption=m.absorption[mat_id][:, :3],
        )

    def _eval_bsdf(self, cols, ns, wo_world, wi_world):
        """Disney eval in world space via per-row local frames."""
        t, b = _frames(ns)
        wo = np.stack([np.sum(wo_world * t, -1), np.sum(wo_world * b, -1),
                       np.sum(wo_world * ns, -1)], -1)
        wi = np.stack([np.sum(wi_world * t, -1), np.sum(wi_world * b, -1),
                       np.sum(wi_world * ns, -1)], -1)
        return disney_eval_np(
            cols["base"], cols["metallic"], cols["roughness"],
            cols["specular_f"], cols["specular_tint"], cols["sheen"],
            cols["sheen_tint"], cols["subsurface"], wo, wi,
            clearcoat=cols["clearcoat"],
            clearcoat_gloss=cols["clearcoat_gloss"],
        )

    def render(
        self,
        view_2d: Optional[CameraView2D],
        view_3d: CameraView3D,
        mode: RenderMode = RenderMode.DEFAULT,
    ) -> np.ndarray:
        W, H = self.width, self.height
        if self._world is None or self._materials is None:
            return np.zeros((H, W, 4), np.uint8)
        w = self._world
        o, d = self._primary_rays(view_3d)
        t, prim, u, v = brute_force_closest(o, d, w["v0"], w["e1"], w["e2"])
        found = prim >= 0
        prim_s = np.maximum(prim, 0)
        ns, ng, uv, tan, bitan, _ = self._shade_point(w, d, prim_s, u, v)
        mat_id = w["mat"][prim_s]
        ns = self._normal_map(mat_id, uv, ns, tan, bitan)
        cols = self._mat_cols(mat_id, uv)

        if mode == RenderMode.NORMAL:
            # misses carry normal 0 -> 0.5 gray (matches the backends' _aov_frame)
            img = np.where(found[:, None], ns, 0.0) * 0.5 + 0.5
            return self._composite_2d(_to_rgba(img, W, H), view_2d)
        if mode == RenderMode.ALBEDO:
            img = np.where(found[:, None], cols["base"], 0.0)
            return self._composite_2d(_to_rgba(img, W, H), view_2d)
        if mode == RenderMode.GBUFFER:
            dd = t[:, None]  # T_MAX on miss, same as the integrator's AOV
            finite = dd < 1e25
            dmax = dd[finite].max() if finite.any() else 1.0
            img = np.repeat(np.where(finite, dd / max(dmax, 1e-6), 1.0), 3, -1)
            return self._composite_2d(_to_rgba(img, W, H), view_2d)

        # DEFAULT: NEE-only path trace, `spp` progressive samples
        spp = self.settings.samples_per_frame
        accum = np.zeros((W * H, 3), np.float32)
        for _ in range(spp):
            accum += self._trace_once(view_3d)
        img = accum / max(spp, 1)
        # same tonemap chain as film.tonemap
        img = _aces(img * self.settings.exposure)
        img = np.where(img <= 0.0031308, 12.92 * img,
                       1.055 * np.power(np.maximum(img, 1e-9), 1 / 2.4) - 0.055)
        return self._composite_2d(_to_rgba(img, W, H), view_2d)

    # ---------------------------------------------------------- 2D overlay
    def _composite_2d(self, frame: np.ndarray,
                      view_2d: Optional[CameraView2D]) -> np.ndarray:
        """Independent full-frame 2D rasterizer (closes the last oracle
        scope gap). Deliberately NOT the product's bbox-scan barycentric
        fill (render/overlay.py): every triangle is edge-function-tested
        against the WHOLE pixel grid — slow, obviously correct, and
        uncorrelated with the code it checks. Same conventions: pixel
        centers at +0.5, NDC y-flip, straight alpha-over, nearest-texel
        modulation."""
        if view_2d is None or not self._meshes_2d:
            return frame
        H, W = frame.shape[:2]
        out = frame.astype(np.float32) / 255.0
        xs, ys = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5,
                             np.arange(H, dtype=np.float32) + 0.5)
        cam = view_2d.matrix
        for slot, mesh in self._meshes_2d.items():
            iv = self._instances_2d.get(slot)
            if iv is None or iv.count == 0 or mesh.num_vertices == 0:
                continue
            tex = self._textures.get(mesh.texture_id)
            tex_img = (tex.mips[0].astype(np.float32) / 255.0
                       if tex is not None else None)
            for m in iv.matrices:
                mm = cam @ m
                pclip = mesh.positions @ mm[:3, :3].T + mm[:3, 3]
                px = (pclip[:, 0] * 0.5 + 0.5) * W
                py = (1.0 - (pclip[:, 1] * 0.5 + 0.5)) * H
                tris = np.stack([px, py], -1).reshape(-1, 3, 2)
                uvs = mesh.uvs.reshape(-1, 3, 2)
                cols = mesh.colors.reshape(-1, 3, 4)
                for t in range(tris.shape[0]):
                    (x0, y0), (x1, y1), (x2, y2) = tris[t]
                    # signed edge functions over the full grid
                    e0 = (x1 - x0) * (ys - y0) - (y1 - y0) * (xs - x0)
                    e1 = (x2 - x1) * (ys - y1) - (y2 - y1) * (xs - x1)
                    e2 = (x0 - x2) * (ys - y2) - (y0 - y2) * (xs - x2)
                    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
                    if abs(area) < 1e-9:
                        continue
                    inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                              | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
                    if not inside.any():
                        continue
                    # barycentrics from edge functions (opposite-vertex)
                    l0 = e1 / area
                    l1 = e2 / area
                    l2 = e0 / area
                    rgba = (l0[..., None] * cols[t, 0]
                            + l1[..., None] * cols[t, 1]
                            + l2[..., None] * cols[t, 2])
                    if tex_img is not None:
                        u = (l0 * uvs[t, 0, 0] + l1 * uvs[t, 1, 0]
                             + l2 * uvs[t, 2, 0])
                        v = (l0 * uvs[t, 0, 1] + l1 * uvs[t, 1, 1]
                             + l2 * uvs[t, 2, 1])
                        th, tw = tex_img.shape[:2]
                        ti = np.clip((v * th).astype(np.int32), 0, th - 1)
                        tj = np.clip((u * tw).astype(np.int32), 0, tw - 1)
                        rgba = rgba * tex_img[ti, tj]
                    a = np.clip(rgba[..., 3], 0.0, 1.0) * inside
                    out[..., :3] = (out[..., :3] * (1 - a[..., None])
                                    + rgba[..., :3] * a[..., None])
        return (np.clip(out, 0, 1) * 255).astype(np.uint8)

    def _trace_once(self, view_3d: CameraView3D) -> np.ndarray:
        w = self._world
        o, d = self._primary_rays(view_3d)
        R = o.shape[0]
        radiance = np.zeros((R, 3), np.float32)
        throughput = np.ones((R, 3), np.float32)
        alive = np.ones(R, bool)
        was_delta = np.zeros(R, bool)  # previous bounce was the glass lobe
        eps = 1e-3
        for depth in range(self.settings.max_bounces + 1):
            if not alive.any():
                break
            idx = np.where(alive)[0]
            t, prim, u, v = brute_force_closest(o[idx], d[idx], w["v0"], w["e1"], w["e2"])
            found = prim >= 0
            # sky on miss (constant or equirect env map)
            miss = idx[~found]
            radiance[miss] += throughput[miss] * self._sky(d[miss])
            hit = idx[found]
            if hit.size == 0:
                break
            prim_h = prim[found]
            dh = d[hit]
            ns, ng, uv, tan, bitan, entering = self._shade_point(
                w, dh, prim_h, u[found], v[found])
            p = o[hit] + t[found][:, None] * dh
            mat_id = w["mat"][prim_h]
            ns = self._normal_map(mat_id, uv, ns, tan, bitan)
            cols = self._mat_cols(mat_id, uv)
            trans_w = np.clip(cols["transmission"], 0, 1) * (1 - cols["metallic"])
            # Beer-Lambert: a backface hit on glass ends an inside segment
            inside = ~entering & (trans_w > 0)
            throughput[hit] *= np.where(
                inside[:, None],
                np.exp(-cols["absorption"] * t[found][:, None]), 1.0)
            # emission: first hit, or after a delta (glass) bounce — NEE
            # cannot reach an emitter through the interface, so the BSDF
            # path is the sole estimator there (MIS weight 1, like the
            # integrator's spec_or_first)
            direct_em = (depth == 0) | was_delta[hit]
            em = np.where((cols["emissive"] & direct_em)[:, None],
                          cols["emission"], 0.0)
            radiance[hit] += throughput[hit] * em
            # direct light (reflective share only: the glass lobe replaces
            # (1 - trans_w) of the BSDF, matching disney_eval's blend)
            direct = self._direct_light(p, ns, -dh, cols)
            radiance[hit] += throughput[hit] * (1 - trans_w)[:, None] * np.clip(
                direct, 0, self.settings.clamp)
            if depth == self.settings.max_bounces:
                break
            # branch: glass delta lobe with prob trans_w, else cosine bounce
            pick = self.rng.random(hit.size).astype(np.float32)
            glass = pick < trans_w
            u1 = self.rng.random(hit.size, dtype=np.float32)
            u2 = self.rng.random(hit.size, dtype=np.float32)
            # cosine branch
            r = np.sqrt(u1)
            phi = 2 * np.pi * u2
            wi_l = np.stack([r * np.cos(phi), r * np.sin(phi),
                             np.sqrt(np.maximum(1 - u1, 0))], -1).astype(np.float32)
            tt, bb = _frames(ns)
            wi = wi_l[:, 0:1] * tt + wi_l[:, 1:2] * bb + wi_l[:, 2:3] * ns
            f = self._eval_bsdf(cols, ns, -dh, wi)
            pdf = np.maximum(wi_l[:, 2] / np.pi, 1e-8)
            tp = f * (wi_l[:, 2] / pdf)[:, None]
            # glass branch: GTR2 microfacet + exact Fresnel split (same math
            # as disney_sample's delta transmission lobe)
            eta_rel = np.where(entering, 1.0 / cols["eta"], cols["eta"])
            alpha = np.maximum(1e-3, cols["roughness"] ** 2)
            cos_h = np.sqrt(np.clip(
                (1.0 - u1) / (1.0 + (alpha * alpha - 1.0) * u1), 0, 1))
            sin_h = np.sqrt(np.clip(1 - cos_h ** 2, 0, 1))
            phi_h = 2 * np.pi * u2
            h_l = np.stack([sin_h * np.cos(phi_h), sin_h * np.sin(phi_h),
                            cos_h], -1).astype(np.float32)
            h = h_l[:, 0:1] * tt + h_l[:, 1:2] * bb + h_l[:, 2:3] * ns
            wo_w = -dh
            cos_i = np.clip(np.sum(wo_w * h, -1), 0, 1)
            sin2_t = eta_rel ** 2 * (1 - cos_i ** 2)
            tir = sin2_t >= 1.0
            cos_t = np.sqrt(np.clip(1 - sin2_t, 0, 1))
            rpar = (eta_rel * cos_i - cos_t) / np.maximum(
                eta_rel * cos_i + cos_t, 1e-12)
            rperp = (cos_i - eta_rel * cos_t) / np.maximum(
                cos_i + eta_rel * cos_t, 1e-12)
            fr = np.where(tir, 1.0, np.clip(0.5 * (rpar**2 + rperp**2), 0, 1))
            pick_t = np.where(trans_w > 0, pick / np.maximum(trans_w, 1e-8), 0)
            do_refl = tir | (pick_t < fr)
            wi_refl = (2 * cos_i[:, None] * h + dh)
            wi_refl /= np.maximum(
                np.linalg.norm(wi_refl, axis=-1, keepdims=True), 1e-12)
            wi_refr = (dh * eta_rel[:, None]
                       + (eta_rel * cos_i - cos_t)[:, None] * h)
            wi_refr /= np.maximum(
                np.linalg.norm(wi_refr, axis=-1, keepdims=True), 1e-12)
            wi_g = np.where(do_refl[:, None], wi_refl, wi_refr)
            tp_g = np.where(do_refl[:, None], 1.0, cols["base"])
            wi = np.where(glass[:, None], wi_g, wi).astype(np.float32)
            tp = np.where(glass[:, None], tp_g, tp)
            side = np.where(np.sum(wi * ng, -1) >= 0, 1.0, -1.0)
            new_alive = np.zeros(R, bool)
            cont = (glass | (wi_l[:, 2] > 1e-6)) & ~cols["emissive"]
            new_alive[hit[cont]] = True
            was_delta[hit] = glass
            throughput[hit] *= np.nan_to_num(tp)
            o[hit] = p + ng * (eps * side)[:, None]
            d[hit] = wi
            alive = new_alive & (np.max(throughput, -1) > 1e-5)
        return radiance


def _frames(n: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Branchless orthonormal basis (Duff et al.), matching
    disney.build_tangent_frame."""
    s = np.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = np.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1)
    bt = np.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t.astype(np.float32), bt.astype(np.float32)


def _aces(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return np.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def _to_rgba(img: np.ndarray, W: int, H: int) -> np.ndarray:
    rgb = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8).reshape(H, W, 3)
    alpha = np.full((H, W, 1), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)
