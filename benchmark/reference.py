"""The plain reference: one path per (pixel, sample) of a `SceneSpec`.

Plain PyTorch over (N,) lanes, independent of the program: it imports
nothing of `rfw_tpu_torch` and takes nothing the program built (no BVH, no
packed arena, no atlas, no light table, no refit). It works from the
generated arrays and the frame's instance matrices:

  * intersection: every ray against every instance's world box, then the
    candidate instances' triangles in object space (Moller-Trumbore), with
    the triangles of each mesh cut into clusters of 64 by the Morton order
    of their centroids so that only clusters whose box the ray enters are
    tested;
  * sampling and shading: a frozen copy of the port's integrator
    (`render/wavefront.py::render_sample` under the Sobol sampler,
    `render/sampler.py`, `render/disney.py`, the potential-weighted light
    pick, MIS against the BSDF, the bilinear mip fetch of `render/atlas.py`),
    pruned to one path per lane in pixel-id order: no sort, no compaction,
    no AOVs, no kernels.

`dtype` is the precision everything floating is computed in: float32, as
the configurations state, or bfloat16 for the control (`control.py`).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

PI = 3.14159265358979
T_MIN = 1e-5
T_MAX = 1e26
SHADOW_EPS = 1e-3
#: light rows up to which the pick weighs each light by its potential at the
#: shading point (the port's POTENTIAL_MAX default; its light table pads the
#: count to a power of two)
POTENTIAL_MAX = 16
#: elements a chunk of the intersection's broadcast tensors may hold
CHUNK = 1 << 23
CLUSTER = 64

FEAT_TRANSMISSION, FEAT_CLEARCOAT, FEAT_SUBSURFACE, FEAT_SHEEN = 1, 2, 4, 8

Vec3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ------------------------------------------------------------------ vectors
def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def neg(a):
    return (-a[0], -a[1], -a[2])


def where(m, a, b):
    return tuple(torch.where(m, a[j], b[j]) for j in range(3))


def normalize(a, eps=1e-12):
    return scale(a, 1.0 / torch.clamp(torch.sqrt(dot(a, a)), min=eps))


def split(v):
    return (v[:, 0], v[:, 1], v[:, 2])


def lum(r, g, b):
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


# ------------------------------------------------------------ Sobol sampler
M32 = 0xFFFFFFFF


def _hash(x):
    x = x & M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _rev(x):
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def _owen(x, seed):
    x = _rev(x)
    x = (x + seed) & M32
    x = x ^ ((x * 0x6C50B47C) & M32)
    x = x ^ ((x * 0xB82F1E52) & M32)
    x = x ^ ((x * 0xC7AFE638) & M32)
    x = x ^ ((x * 0x8D22F6E6) & M32)
    return _rev(x)


def _sobol_dim1(index):
    result = torch.zeros_like(index)
    v = 1 << 31
    for j in range(32):
        result = torch.where(((index >> j) & 1) == 1, result ^ v, result)
        v = v ^ (v >> 1)
    return result


def sobol(sample_index, pid, slot: int, n: int) -> List[torch.Tensor]:
    """n (2 or 3) Owen-scrambled Sobol uniforms (float32) per lane for one
    use site `slot`, keyed by pixel id and sample index (int64 lanes)."""
    slot_u = ((slot & M32) * 0x85EBCA6B) & M32
    seed = _hash((pid * 0x9E3779B9 + slot_u) & M32)
    idx = _owen(sample_index & M32, _hash(seed))
    d0 = _owen(_rev(idx), _hash(seed ^ 0x68BC21EB))
    d1 = _owen(_sobol_dim1(idx), _hash(seed ^ 0x02E5BE93))
    out = [d0, d1]
    if n == 3:
        out.append(_rev(_owen(sample_index & M32, _hash(seed ^ 0x94D049BB))))
    return [x.to(torch.float32) * (1.0 / 4294967296.0) for x in out]


# ------------------------------------------------------------------- Disney
class Mat(NamedTuple):
    base: Vec3
    metallic: torch.Tensor
    roughness: torch.Tensor
    specular_f: torch.Tensor
    specular_tint: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    subsurface: torch.Tensor
    transmission: torch.Tensor
    eta_rel: torch.Tensor


def _sqr(x):
    return x * x


def _schlick(u):
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    return _sqr(_sqr(m)) * m


def _gtr1(ndh, a):
    a2 = _sqr(a)
    t = 1.0 + (a2 - 1.0) * _sqr(ndh)
    return torch.where(a >= 1.0, 1.0 / PI, (a2 - 1.0) / (PI * torch.log(a2) * t))


def _gtr2(ndh, a):
    a2 = _sqr(a)
    t = 1.0 + (a2 - 1.0) * _sqr(ndh)
    return a2 / (PI * _sqr(t) + 1e-12)


def _smith(ndv, a):
    a2 = _sqr(a)
    b = _sqr(ndv)
    return 1.0 / (ndv + torch.sqrt(a2 + b - a2 * b) + 1e-12)


def _tint(base):
    lu = lum(*base)
    inv = 1.0 / torch.clamp(lu, min=1e-7)
    one = torch.ones_like(lu)
    return tuple(torch.where(lu > 0, base[j] * inv, one) for j in range(3))


def bsdf_eval(p: Mat, wo, wi, features: int):
    ndv, ndl = wo[2], wi[2]
    up = (ndv > 1e-6) & (ndl > 1e-6)
    h = normalize(add(wi, wo))
    ndh, ldh = h[2], dot(wi, h)
    ctint = _tint(p.base)
    f0 = 0.08 * p.specular_f
    one_m_metal = 1.0 - p.metallic
    cspec0 = tuple(f0 * ((1.0 - p.specular_tint) + p.specular_tint * ctint[j]) * one_m_metal
                   + p.base[j] * p.metallic for j in range(3))
    csheen = tuple((1.0 - p.sheen_tint) + p.sheen_tint * ctint[j] for j in range(3))
    fl, fv = _schlick(ndl), _schlick(ndv)
    fd90 = 0.5 + 2.0 * _sqr(ldh) * p.roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    if features & FEAT_SUBSURFACE:
        fss90 = _sqr(ldh) * p.roughness
        fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
        ss = 1.25 * (fss * (1.0 / torch.clamp(ndl + ndv, min=1e-6) - 0.5) + 0.5)
        fd = torch.where(p.subsurface > 0, (1.0 - p.subsurface) * fd + p.subsurface * ss, fd)
    diff_s = fd / PI
    fh = _schlick(ldh)
    alpha = torch.clamp(_sqr(p.roughness), min=1e-3)
    dsgs = _gtr2(ndh, alpha) * (_smith(ndl, alpha) * _smith(ndv, alpha))
    if features & FEAT_CLEARCOAT:
        a_cc = 0.1 * (1.0 - p.clearcoat_gloss) + 0.001 * p.clearcoat_gloss
        f_cc = (0.25 * p.clearcoat * _gtr1(ndh, a_cc) * (0.04 + 0.96 * fh)
                * (_smith(ndl, 0.25) * _smith(ndv, 0.25)))
    else:
        f_cc = 0.0
    trans_scale = (1.0 - torch.clamp(p.transmission, 0.0, 1.0) * one_m_metal
                   if features & FEAT_TRANSMISSION else None)
    out = []
    for j in range(3):
        f_diff = p.base[j] * diff_s
        if features & FEAT_SHEEN:
            f_diff = f_diff + fh * p.sheen * csheen[j]
        f = f_diff * one_m_metal + dsgs * (cspec0[j] + (1.0 - cspec0[j]) * fh) + f_cc
        if trans_scale is not None:
            f = f * trans_scale
        out.append(torch.where(up, f, torch.zeros_like(ndv)))
    return tuple(out)


def _lobes(p: Mat, features: int):
    if not features & FEAT_CLEARCOAT:
        spec_w = 0.5 + 0.5 * p.metallic
        diff_w = (1.0 - p.metallic) * 0.5
        total = spec_w + diff_w + 1e-8
        return spec_w / total, torch.zeros_like(spec_w), diff_w / total
    spec_w = 1.0 / (1.0 + p.clearcoat * 0.5) * (0.5 + 0.5 * p.metallic)
    cc_w = (p.clearcoat * 0.25) / (1.0 + p.clearcoat * 0.25)
    diff_w = (1.0 - p.metallic) * 0.5
    total = spec_w + cc_w + diff_w + 1e-8
    return spec_w / total, cc_w / total, diff_w / total


def bsdf_pdf(p: Mat, wo, wi, features: int):
    ndl, ndv = wi[2], wo[2]
    up = (ndl > 1e-6) & (ndv > 1e-6)
    h = normalize(add(wi, wo))
    ndh = torch.clamp(h[2], min=1e-6)
    ldh = torch.clamp(dot(wi, h), min=1e-6)
    spec_w, cc_w, diff_w = _lobes(p, features)
    alpha = torch.clamp(_sqr(p.roughness), min=1e-3)
    pdf = diff_w * (ndl / PI) + spec_w * (_gtr2(ndh, alpha) * ndh / (4.0 * ldh))
    if features & FEAT_CLEARCOAT:
        a_cc = 0.1 * (1.0 - p.clearcoat_gloss) + 0.001 * p.clearcoat_gloss
        pdf = pdf + cc_w * _gtr1(ndh, a_cc) * ndh / (4.0 * ldh)
    if features & FEAT_TRANSMISSION:
        pdf = pdf * (1.0 - torch.clamp(p.transmission, 0.0, 1.0) * (1.0 - p.metallic))
    return torch.where(up, pdf, 0.0)


def _fresnel(cos_i, eta):
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = _sqr(eta) * (1.0 - _sqr(cos_i))
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    f = 0.5 * (_sqr(r_par) + _sqr(r_perp))
    return torch.where(sin2_t >= 1.0, 1.0, torch.clamp(f, 0.0, 1.0))


def _refract(wo, h, eta):
    cos_i = dot(wo, h)
    sin2_t = _sqr(eta) * (1.0 - _sqr(cos_i))
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi = add(scale(neg(wo), eta), scale(h, eta * cos_i - cos_t))
    return normalize(wi), sin2_t >= 1.0


def _reflect(wo, h):
    return sub(scale(h, 2.0 * dot(wo, h)), wo)


def _cosine(u1, u2):
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    return (r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(torch.clamp(1.0 - u1, min=0.0)))


def _gtr2_h(u1, u2, alpha):
    phi = 2.0 * PI * u1
    cos_t = torch.sqrt(torch.clamp((1.0 - u2) / (1.0 + (_sqr(alpha) - 1.0) * u2), 0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - _sqr(cos_t), min=0.0))
    return (sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def _gtr1_h(u1, u2, a):
    a2 = _sqr(a)
    phi = 2.0 * PI * u1
    cos2 = (1.0 - torch.pow(a2, 1.0 - u2)) / torch.clamp(1.0 - a2, min=1e-6)
    cos_t = torch.sqrt(torch.clamp(cos2, 0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos2, min=0.0))
    return (sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def bsdf_sample(p: Mat, wo, u0, u1, u2, features: int):
    """(wi, f, pdf, is_delta); f excludes the cosine."""
    spec_w, cc_w, _ = _lobes(p, features)
    if features & FEAT_TRANSMISSION:
        trans_w = torch.clamp(p.transmission, 0.0, 1.0) * (1.0 - p.metallic)
        use_trans = u0 < trans_w
        pick_r = torch.clamp((u0 - trans_w) / torch.clamp(1.0 - trans_w, min=1e-8), 0.0, 1.0)
    else:
        use_trans = torch.zeros(u0.shape, dtype=torch.bool, device=u0.device)
        pick_r = u0
    use_spec = (~use_trans) & (pick_r < spec_w)
    use_cc = (~use_trans) & (~use_spec) & (pick_r < spec_w + cc_w)
    alpha = torch.clamp(_sqr(p.roughness), min=1e-3)
    h_spec = _gtr2_h(u1, u2, alpha)
    wi_spec = _reflect(wo, h_spec)
    wi_diff = _cosine(u1, u2)
    if features & FEAT_CLEARCOAT:
        a_cc = 0.1 * (1.0 - p.clearcoat_gloss) + 0.001 * p.clearcoat_gloss
        wi = where(use_spec, wi_spec, where(use_cc, _reflect(wo, _gtr1_h(u1, u2, a_cc)), wi_diff))
    else:
        wi = where(use_spec, wi_spec, wi_diff)
    wi = normalize(wi)
    f = bsdf_eval(p, wo, wi, features)
    pdf = bsdf_pdf(p, wo, wi, features)
    if not features & FEAT_TRANSMISSION:
        return wi, f, pdf, use_trans
    fr = _fresnel(dot(wo, h_spec), p.eta_rel)
    wi_refr, tir = _refract(wo, h_spec, p.eta_rel)
    pick_t = torch.clamp(u0 / torch.clamp(trans_w, min=1e-8), 0.0, 1.0)
    do_reflect = tir | (pick_t < fr)
    wi_trans = where(do_reflect, _reflect(wo, h_spec), wi_refr)
    ones = torch.ones_like(p.base[0])
    w_trans = where(do_reflect, (ones, ones, ones), p.base)
    inv_share = torch.clamp(trans_w, min=1e-8) / torch.clamp(torch.abs(wi_trans[2]), min=1e-6)
    return (where(use_trans, wi_trans, wi), where(use_trans, scale(w_trans, inv_share), f),
            torch.where(use_trans, trans_w, pdf), use_trans)


def tangent_frame(n):
    s = torch.where(n[2] >= 0.0, 1.0, -1.0).to(n[2].dtype)
    a = -1.0 / (s + n[2])
    b = n[0] * n[1] * a
    return (1.0 + s * n[0] * n[0] * a, s * b, -s * n[0]), (b, s + n[1] * n[1] * a, -n[1])


def to_local(t, bt, n, v):
    return (dot(v, t), dot(v, bt), dot(v, n))


def to_world(t, bt, n, v):
    return tuple(v[0] * t[j] + v[1] * bt[j] + v[2] * n[j] for j in range(3))


# ------------------------------------------------------------------ scene
class Hit(NamedTuple):
    t: torch.Tensor
    inst: torch.Tensor  # global instance index, -1 = miss
    tri: torch.Tensor  # global triangle row
    u: torch.Tensor
    v: torch.Tensor


class Reference:
    """The spec's geometry, materials, textures and lights as tensors on
    `device`; `set_instances` places the instances of one frame and
    `radiance(pid, sample)` renders one path per lane."""

    def __init__(self, spec, device, dtype=torch.float32):
        self.spec, self.dev, self.dt = spec, torch.device(device), dtype
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.dev).to(dtype)  # noqa: E731
        rows, cl_min, cl_max, cl_tri, self.tri_base, self.cl_range = [], [], [], [], [], []
        nt = nc = 0
        for m in spec.meshes:
            p = m.positions.astype(np.float64)
            i0, i1, i2 = m.indices[:, 0], m.indices[:, 1], m.indices[:, 2]
            v0, e1, e2 = p[i0], p[i1] - p[i0], p[i2] - p[i0]
            uv = m.uvs[m.indices].astype(np.float64)
            uv_area = 0.5 * np.abs((uv[:, 1, 0] - uv[:, 0, 0]) * (uv[:, 2, 1] - uv[:, 0, 1])
                                   - (uv[:, 1, 1] - uv[:, 0, 1]) * (uv[:, 2, 0] - uv[:, 0, 0]))
            w_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            lodf = np.sqrt(uv_area / np.maximum(w_area, 1e-12))
            rows.append(np.concatenate([
                v0, e1, e2, m.normals[i0], m.normals[i1], m.normals[i2],
                m.uvs[i0], m.uvs[i1], m.uvs[i2], m.tangents[i0], lodf[:, None],
                v0 + (e1 + e2) / 3.0, m.tri_material[:, None], m.tri_light[:, None]],
                axis=1).astype(np.float32))
            # clusters of CLUSTER triangles in the Morton order of their centroids
            c = v0 + (e1 + e2) / 3.0
            q = ((c - c.min(0)) / np.maximum(np.ptp(c, axis=0), 1e-9) * 1023).astype(np.int64)
            code = np.zeros(len(c), np.int64)
            for b in range(10):
                for k in range(3):
                    code |= ((q[:, k] >> b) & 1) << (3 * b + k)
            order = np.argsort(code, kind="stable")
            n_cl = -(-len(order) // CLUSTER)
            pad = np.full(n_cl * CLUSTER, -1, np.int64)
            pad[:len(order)] = order
            pad = pad.reshape(n_cl, CLUSTER)
            corners = np.stack([v0, v0 + e1, v0 + e2], 1)  # (T,3,3)
            cc = corners[np.maximum(pad, 0)]  # (C,64,3,3)
            lo = np.where((pad >= 0)[..., None, None], cc, np.inf).min(axis=(1, 2))
            hi = np.where((pad >= 0)[..., None, None], cc, -np.inf).max(axis=(1, 2))
            pad_eps = 1e-5 * (np.abs(lo) + np.abs(hi) + 1e-3)
            cl_min.append(lo - pad_eps)
            cl_max.append(hi + pad_eps)
            cl_tri.append(np.where(pad >= 0, pad + nt, -1))
            self.tri_base.append(nt)
            self.cl_range.append((nc, nc + n_cl))
            nt += len(order)
            nc += n_cl
        self.tri = f(np.concatenate(rows))  # (T, 34)
        self.cl_min, self.cl_max = f(np.concatenate(cl_min)), f(np.concatenate(cl_max))
        self.cl_tri = torch.as_tensor(np.concatenate(cl_tri), device=self.dev)
        self.color = f(spec.color)
        self.params = f(spec.params)
        self.tex_id = torch.as_tensor(spec.tex[:, 0], device=self.dev)
        pr = spec.params
        self.features = int((FEAT_TRANSMISSION * (pr[:, 10] > 0).any())
                            | (FEAT_CLEARCOAT * (pr[:, 8] > 0).any())
                            | (FEAT_SUBSURFACE * (pr[:, 1] > 0).any())
                            | (FEAT_SHEEN * (pr[:, 6] > 0).any()))
        self.textures = []
        for mips, srgb in zip(spec.textures, spec.texture_srgb):
            offs = np.cumsum([0] + [m.shape[0] * m.shape[1] for m in mips])[:-1]
            self.textures.append(dict(
                texels=torch.as_tensor(np.concatenate([m.reshape(-1, 4) for m in mips]),
                                       device=self.dev).to(torch.int64),
                off=torch.as_tensor(offs, device=self.dev),
                w=torch.as_tensor([m.shape[1] for m in mips], device=self.dev),
                h=torch.as_tensor([m.shape[0] for m in mips], device=self.dev),
                n=len(mips), srgb=srgb))
        self._lights(spec)
        s = spec.settings
        self.max_bounces = int(s.get("max_bounces", 3))
        self.clamp = float(s.get("clamp", 10.0))
        self.sky = float(s.get("sky_intensity", 0.0))
        self.view = f(spec.view)
        self.mesh_box = [(m.aabb_min, m.aabb_max) for m in spec.meshes]

    def _lights(self, spec):
        """The light rows in pick order (spot, directional, area), with the
        columns the pick reads: 0:3 position | v0, 3:6 direction | v1,
        6:9 energy | v2, 9:12 area normal, 12:15 area radiance, 15 cos
        inner, 16 cos outer, 17 area."""
        sp, sun, ar = spec.spot, spec.sun, spec.area
        n_s = len(sp.get("position", ()))
        n_d, n_a = len(sun["direction"]), len(ar["area"])
        rows = np.zeros((n_s + n_d + n_a, 20), np.float32)
        if n_s:
            rows[:n_s, 0:3], rows[:n_s, 3:6] = sp["position"], sp["direction"]
            rows[:n_s, 6:9] = sp["energy"]
            rows[:n_s, 15], rows[:n_s, 16] = sp["cos_inner"], sp["cos_outer"]
        rows[n_s:n_s + n_d, 3:6], rows[n_s:n_s + n_d, 6:9] = sun["direction"], sun["energy"]
        a = slice(n_s + n_d, n_s + n_d + n_a)
        rows[a, 0:3], rows[a, 3:6], rows[a, 6:9] = ar["v0"], ar["v1"], ar["v2"]
        rows[a, 9:12], rows[a, 12:15], rows[a, 17] = ar["normal"], ar["radiance"], ar["area"]
        if len(rows) > POTENTIAL_MAX:
            raise ValueError(f"{len(rows)} lights: the reference holds the potential-weighted "
                             f"pick only, up to {POTENTIAL_MAX} lights")
        self.n_spot, self.n_dir, self.n_area = n_s, n_d, n_a
        self.n_lights = len(rows)
        self.light = torch.as_tensor(rows, device=self.dev).to(self.dt)

    def holds(self, spec) -> bool:
        """Whether `spec` differs from the one this was built from in its
        instances alone, so that `set_instances` places it."""
        return all(getattr(spec, f.name) is getattr(self.spec, f.name)
                   for f in dataclasses.fields(spec) if f.name != "instances")

    def set_instances(self, matrices: List[np.ndarray]) -> None:
        """Place every slot's instances (world matrices, (I,4,4) a slot)."""
        mats = np.concatenate(matrices).astype(np.float64)
        mesh = np.concatenate([np.full(len(m), i) for i, m in enumerate(matrices)])
        inv = np.linalg.inv(mats)
        nrm = np.transpose(np.linalg.inv(mats[:, :3, :3]), (0, 2, 1))
        lo = np.stack([self.mesh_box[k][0] for k in mesh]).astype(np.float64)
        hi = np.stack([self.mesh_box[k][1] for k in mesh]).astype(np.float64)
        corners = np.stack([np.where(np.array([(c >> k) & 1 for k in range(3)], bool), hi, lo)
                            for c in range(8)], 1)  # (I,8,3)
        w = np.einsum("iab,ikb->ika", mats[:, :3, :3], corners) + mats[:, None, :3, 3]
        eps = 1e-5 * (np.abs(w).max(axis=1) + 1e-3)
        f = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.dev).to(self.dt)  # noqa: E731
        self.inst_mesh = torch.as_tensor(mesh, device=self.dev)
        self.inst_inv = f(inv[:, :3, :4].reshape(-1, 12))
        self.inst_shade = f(np.concatenate([nrm.reshape(-1, 9), mats[:, :3, :3].reshape(-1, 9),
                                            mats[:, :3, 3]], axis=1))  # (I,21)
        self.w_min, self.w_max = f(w.min(axis=1) - eps), f(w.max(axis=1) + eps)

    # ------------------------------------------------------- intersection
    def trace(self, o: Vec3, d: Vec3, tmax: torch.Tensor, any_hit: bool):
        """Closest hit (a Hit) or occlusion ((N,) bool) of rays o + t d,
        t in (T_MIN, tmax)."""
        N = o[0].shape[0]
        dev, dt = self.dev, self.dt
        O = torch.stack(o, 1)
        D = torch.stack(d, 1)
        ad = D.abs()
        invd = 1.0 / torch.where(ad < 1e-20, torch.where(D < 0, -1e-20, 1e-20).to(dt), D)
        live = (tmax > T_MIN).nonzero().squeeze(1)
        best = tmax.clone()
        occluded = torch.zeros(N, dtype=torch.bool, device=dev)
        ri, ii = [live[:0]], [live[:0]]
        n_inst = self.w_min.shape[0]
        step = max(1, CHUNK // (3 * n_inst))
        for s in range(0, live.shape[0], step):
            r = live[s:s + step]
            t0 = (self.w_min[None] - O[r, None]) * invd[r, None]
            t1 = (self.w_max[None] - O[r, None]) * invd[r, None]
            tn = torch.minimum(t0, t1).amax(-1)
            tf = torch.maximum(t0, t1).amin(-1)
            a, b = ((tn <= tf) & (tf > T_MIN) & (tn < best[r, None])).nonzero(as_tuple=True)
            ri.append(r[a])
            ii.append(b)
        ri, ii = torch.cat(ri), torch.cat(ii)
        cand = []
        mesh_of = self.inst_mesh[ii]
        for m, (c0, c1) in enumerate(self.cl_range):
            sel = (mesh_of == m).nonzero().squeeze(1)
            if sel.numel() == 0:
                continue
            rm, im = ri[sel], ii[sel]
            A = self.inst_inv[im]  # (P,12)
            oo = tuple(A[:, 4 * k] * O[rm, 0] + A[:, 4 * k + 1] * O[rm, 1]
                       + A[:, 4 * k + 2] * O[rm, 2] + A[:, 4 * k + 3] for k in range(3))
            dd = tuple(A[:, 4 * k] * D[rm, 0] + A[:, 4 * k + 1] * D[rm, 1]
                       + A[:, 4 * k + 2] * D[rm, 2] for k in range(3))
            oo, dd = torch.stack(oo, 1), torch.stack(dd, 1)
            idd = 1.0 / torch.where(dd.abs() < 1e-20, torch.where(dd < 0, -1e-20, 1e-20).to(dt), dd)
            cmin, cmax = self.cl_min[c0:c1], self.cl_max[c0:c1]
            pstep = max(1, CHUNK // (3 * (c1 - c0)))
            for s in range(0, rm.shape[0], pstep):
                po, pd, pi = oo[s:s + pstep], idd[s:s + pstep], slice(s, s + pstep)
                t0 = (cmin[None] - po[:, None]) * pd[:, None]
                t1 = (cmax[None] - po[:, None]) * pd[:, None]
                tn = torch.minimum(t0, t1).amax(-1)
                tf = torch.maximum(t0, t1).amin(-1)
                pp, cc = ((tn <= tf) & (tf > T_MIN)
                          & (tn < best[rm[pi], None])).nonzero(as_tuple=True)
                pp = pp + s
                qstep = max(1, CHUNK // (CLUSTER * 9))
                for q in range(0, pp.shape[0], qstep):
                    self._triangles(pp[q:q + qstep], cc[q:q + qstep] + c0, rm, im, oo, dd,
                                    best, any_hit, occluded, cand)
        if any_hit:
            return occluded
        hit = Hit(best, torch.full((N,), -1, dtype=torch.int64, device=dev),
                  torch.zeros(N, dtype=torch.int64, device=dev),
                  torch.zeros(N, dtype=dt, device=dev), torch.zeros(N, dtype=dt, device=dev))
        if not cand:
            return hit
        r, t, inst, tri, u, v = (torch.cat(x) for x in zip(*cand))
        best.scatter_reduce_(0, r, t, "amin")
        win = t == best[r]
        r, inst, tri, u, v = r[win], inst[win], tri[win], u[win], v[win]
        hit.inst[r], hit.tri[r], hit.u[r], hit.v[r] = inst, tri, u, v
        return hit

    def _triangles(self, pp, cc, rm, im, oo, dd, best, any_hit, occluded, cand):
        """Moller-Trumbore of the pairs' object rays against the triangles
        of their clusters."""
        tri = self.cl_tri[cc]  # (Q,64)
        valid = tri >= 0
        rec = self.tri[torch.clamp(tri, min=0)]  # (Q,64,34)
        v0, e1, e2 = rec[..., 0:3], rec[..., 3:6], rec[..., 6:9]
        o, d = oo[pp][:, None], dd[pp][:, None]
        pvec = torch.linalg.cross(d.expand_as(e2), e2, dim=-1)
        det = (e1 * pvec).sum(-1)
        inv_det = torch.where(det.abs() > 1e-12, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
        tvec = o - v0
        u = (tvec * pvec).sum(-1) * inv_det
        qvec = torch.linalg.cross(tvec, e1, dim=-1)
        v = (d * qvec).sum(-1) * inv_det
        t = (e2 * qvec).sum(-1) * inv_det
        ray = rm[pp]
        ok = (valid & (det.abs() > 1e-12) & (u >= -1e-7) & (v >= -1e-7) & (u + v <= 1 + 1e-7)
              & (t > T_MIN) & (t < best[ray, None]))
        if any_hit:
            occluded[ray[ok.any(1)]] = True
            return
        k = torch.where(ok, t, float("inf")).argmin(1, keepdim=True)
        take = ok.gather(1, k).squeeze(1)
        g = lambda x: x.gather(1, k).squeeze(1)[take]  # noqa: E731
        cand.append((ray[take], g(t), im[pp][take], g(tri), g(u), g(v)))

    # ------------------------------------------------------------ shading
    def _basis(self, hit: Hit, ray_d: Vec3):
        rec = self.tri[hit.tri]
        m = self.inst_shade[torch.clamp(hit.inst, min=0)]
        w = 1.0 - hit.u - hit.v
        col = lambda j: rec[:, j]  # noqa: E731
        ns_obj = tuple(w * col(9 + j) + hit.u * col(12 + j) + hit.v * col(15 + j) for j in range(3))
        uv = tuple(w * col(18 + j) + hit.u * col(20 + j) + hit.v * col(22 + j) for j in range(2))

        def mat3(base, v):
            return tuple(m[:, base + 3 * r] * v[0] + m[:, base + 3 * r + 1] * v[1]
                         + m[:, base + 3 * r + 2] * v[2] for r in range(3))

        ns = normalize(mat3(0, ns_obj))
        e1w, e2w = mat3(9, (col(3), col(4), col(5))), mat3(9, (col(6), col(7), col(8)))
        ng_raw = cross(e1w, e2w)
        area2 = torch.sqrt(torch.clamp(dot(ng_raw, ng_raw), min=0.0))
        ng = scale(ng_raw, 1.0 / torch.clamp(area2, min=1e-12))
        flip = dot(ng, ray_d) > 0
        ng = where(flip, neg(ng), ng)
        ns = where(dot(ns, ng) < 0, neg(ns), ns)
        tan = mat3(9, (col(24), col(25), col(26)))
        tan = sub(tan, scale(ns, dot(tan, ns)))
        tlen = torch.sqrt(torch.clamp(dot(tan, tan), min=0.0))
        t_fb, _ = tangent_frame(ns)
        tan = where(tlen > 1e-6, scale(tan, 1.0 / torch.clamp(tlen, min=1e-12)), t_fb)
        bitan = scale(cross(ns, tan), col(27))
        cen = add(mat3(9, (col(29), col(30), col(31))), (m[:, 18], m[:, 19], m[:, 20]))
        return dict(ns=ns, ng=ng, uv=uv, tan=tan, bitan=bitan, world_area=0.5 * area2,
                    entering=~flip, lodf=col(28), centroid=cen,
                    mat=rec[:, 32].to(torch.int64), light=rec[:, 33].to(torch.int64))

    def _texture(self, tex_id, uv, lod):
        """Bilinear fetch at the rounded mip of the footprint, wrapped; white
        where a lane has no texture. (N,3) linear rgb."""
        out = torch.ones((tex_id.shape[0], 3), dtype=self.dt, device=self.dev)
        for k, T in enumerate(self.textures):
            lanes = (tex_id == k).nonzero().squeeze(1)
            if lanes.numel() == 0:
                continue
            l = lod[lanes] + torch.log2(T["w"][0].to(self.dt)) - 10.0
            l = torch.minimum(torch.clamp(l, min=0.0), torch.tensor(float(T["n"] - 1), dtype=self.dt,
                                                                    device=self.dev))
            mip = torch.round(l).to(torch.int64)
            off, w, h = T["off"][mip], T["w"][mip], T["h"][mip]
            u, v = uv[0][lanes], uv[1][lanes]
            x = (u - torch.floor(u)) * w.to(self.dt) - 0.5
            y = (v - torch.floor(v)) * h.to(self.dt) - 0.5
            x0, y0 = torch.floor(x), torch.floor(y)
            fx, fy = (x - x0)[:, None], (y - y0)[:, None]
            xi, yi = torch.remainder(x0.to(torch.int64), w), torch.remainder(y0.to(torch.int64), h)
            xj, yj = torch.remainder(xi + 1, w), torch.remainder(yi + 1, h)
            tx = lambda xx, yy: T["texels"][off + yy * w + xx].to(self.dt) * (1.0 / 255.0)  # noqa: E731
            c = ((tx(xi, yi) * (1 - fx) + tx(xj, yi) * fx) * (1 - fy)
                 + (tx(xi, yj) * (1 - fx) + tx(xj, yj) * fx) * fy)[:, :3]
            if T["srgb"]:
                c = torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))
            out[lanes] = c
        return out

    def _material(self, b, lod):
        mid = b["mat"]
        color = self.color[mid]
        pr = self.params[mid]
        diff = self._texture(self.tex_id[mid], b["uv"], lod)
        base = tuple(color[:, j] * diff[:, j] for j in range(3))
        emissive = torch.maximum(torch.maximum(color[:, 0], color[:, 1]), color[:, 2]) > 1.0
        emission = tuple(torch.where(emissive, color[:, j], 0.0) for j in range(3))
        eta = torch.where(pr[:, 11] > 1e-3, pr[:, 11], 1.5)
        mat = Mat(base=base, metallic=pr[:, 0], roughness=torch.clamp(pr[:, 3], 0.02, 1.0),
                  specular_f=pr[:, 2], specular_tint=pr[:, 4], sheen=pr[:, 6],
                  sheen_tint=pr[:, 7], clearcoat=pr[:, 8], clearcoat_gloss=pr[:, 9],
                  subsurface=pr[:, 1], transmission=pr[:, 10],
                  eta_rel=torch.where(b["entering"], 1.0 / eta, eta))
        return mat, emission

    def _potentials(self, p, ns):
        """(L, N) unshadowed contribution estimates of every light row."""
        tab = self.light
        L = tab.shape[0]
        idx = torch.arange(L, device=self.dev)
        is_spot = (idx < self.n_spot)[:, None]
        is_dir = (~is_spot) & (idx < self.n_spot + self.n_dir)[:, None]
        is_area = (idx >= self.n_spot + self.n_dir)[:, None]
        col = lambda j: tab[:, j:j + 1]  # noqa: E731
        lum_en = 0.2126 * col(6) + 0.7152 * col(7) + 0.0722 * col(8)
        lum_rad = 0.2126 * col(12) + 0.7152 * col(13) + 0.0722 * col(14)
        cen = tuple(torch.where(is_area, (col(j) + col(3 + j) + col(6 + j)) / 3.0, col(j))
                    for j in range(3))
        vec = tuple(cen[j] - p[j][None, :] for j in range(3))
        d2 = torch.clamp(vec[0] * vec[0] + vec[1] * vec[1] + vec[2] * vec[2], min=1e-8)
        inv_d = 1.0 / torch.sqrt(d2)
        wi = tuple(vec[j] * inv_d for j in range(3))
        cos_to = -(wi[0] * col(3) + wi[1] * col(4) + wi[2] * col(5))
        falloff = torch.clamp((cos_to - col(16)) / torch.clamp(col(15) - col(16), min=1e-6),
                              0.0, 1.0)
        cos_l = torch.abs(wi[0] * col(9) + wi[1] * col(10) + wi[2] * col(11))
        q = torch.where(is_spot, lum_en * falloff / d2,
                        torch.where(is_dir, lum_en.expand_as(d2), lum_rad * col(17) * cos_l / d2))
        wi_eff = tuple(torch.where(is_dir, -col(3 + j), wi[j]) for j in range(3))
        cos_s = torch.clamp(ns[0][None, :] * wi_eff[0] + ns[1][None, :] * wi_eff[1]
                            + ns[2][None, :] * wi_eff[2], min=0.0)
        return q * torch.where(is_area, 1.0, cos_s)

    def _sample_light(self, p, u0, u1, u2, ns):
        """Potential-weighted pick of one light per lane and a point on it:
        (wi, dist, radiance over pdf, is_delta, solid-angle pdf, Z)."""
        qs = self._potentials(p, ns)
        total = self.n_lights
        z = qs[0]
        for q in qs[1:]:
            z = z + q
        inv_z = torch.where(z > 0, 0.5 / torch.clamp(z, min=1e-12), 0.0)
        probs = [q * inv_z + 0.5 / total for q in qs]
        cdf_total = probs[0]
        for pr in probs[1:]:
            cdf_total = cdf_total + pr
        target = u0 * cdf_total
        run = torch.zeros_like(target)
        count = torch.zeros(target.shape, dtype=torch.int64, device=self.dev)
        for pr in probs:
            run = run + pr
            count = count + (target > run).to(torch.int64)
        pick = torch.clamp(count, max=total - 1)
        pick_pr = torch.zeros_like(target)
        for i, pr in enumerate(probs):
            pick_pr = torch.where(pick == i, pr, pick_pr)
        pick_p = torch.clamp(pick_pr / torch.clamp(cdf_total, min=1e-12), min=1e-12)
        row = self.light[pick]
        r_pos, r_dir, r_en = split(row[:, 0:3]), split(row[:, 3:6]), split(row[:, 6:9])
        is_spot = pick < self.n_spot
        is_dir = (~is_spot) & (pick < self.n_spot + self.n_dir)
        is_area = (~is_spot) & (~is_dir)
        p_vec = sub(r_pos, p)
        p_d2 = torch.clamp(dot(p_vec, p_vec), min=1e-8)
        p_dist = torch.sqrt(p_d2)
        p_wi = scale(p_vec, 1.0 / p_dist)
        falloff = torch.clamp((-dot(p_wi, r_dir) - row[:, 16])
                              / torch.clamp(row[:, 15] - row[:, 16], min=1e-6), 0.0, 1.0)
        s_rad = scale(r_en, falloff / p_d2)
        su = torch.sqrt(torch.clamp(u1, min=0.0))
        b0 = 1.0 - su
        b1 = u2 * su
        b2 = 1.0 - b0 - b1
        a_pt = tuple(r_pos[j] * b0 + r_dir[j] * b1 + r_en[j] * b2 for j in range(3))
        a_vec = sub(a_pt, p)
        a_d2 = torch.clamp(dot(a_vec, a_vec), min=1e-8)
        a_dist = torch.sqrt(a_d2)
        a_wi = scale(a_vec, 1.0 / a_dist)
        cos_l = torch.abs(dot(a_wi, split(row[:, 9:12])))
        a_pdf = a_d2 / torch.clamp(cos_l * row[:, 17], min=1e-8)
        a_rad = scale(split(row[:, 12:15]), 1.0 / torch.clamp(a_pdf, min=1e-8))
        wi = where(is_spot, p_wi, where(is_dir, neg(r_dir), a_wi))
        dist = torch.where(is_spot, p_dist, torch.where(is_dir, T_MAX * 0.5, a_dist))
        rad = where(is_spot, s_rad, where(is_dir, r_en, a_rad))
        rad = scale(rad, 1.0 / pick_p)
        return wi, dist, rad, is_spot | is_dir, torch.where(is_area, a_pdf * pick_p, 0.0), z

    # ------------------------------------------------------------- paths
    def radiance(self, pid: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
        """(N,3) float32 radiance of one path per lane: pixel id `pid`, Sobol
        sample index `sample` (int64 tensors on the device)."""
        dev, dt = self.dev, self.dt
        W = self.spec.width
        N = pid.shape[0]
        view = self.view
        u = lambda slot, n: [x.to(dt) for x in sobol(sample, pid, slot, n)]  # noqa: E731
        jit, lens = u(0, 2), u(1, 2)
        px, py = (pid % W).to(dt), (pid // W).to(dt)
        r = (px + jit[0]) * view[17]
        s = (py + jit[1]) * view[18]
        b9 = lens[0] * 9.0
        blade = torch.floor(b9)
        r2, r3 = b9 - blade, lens[1]
        fold = (r2 + r3) > 1.0
        r2, r3 = torch.where(fold, 1.0 - r2, r2), torch.where(fold, 1.0 - r3, r3)
        a1, a2 = blade * (PI / 4.5), (blade + 1.0) * (PI / 4.5)
        xr = (torch.sin(a1) * r2 + torch.sin(a2) * r3) * view[15]
        yr = (torch.cos(a1) * r2 + torch.cos(a2) * r3) * view[15]
        rn = view[3:6] / torch.clamp(torch.sqrt(torch.sum(view[3:6] * view[3:6])), min=1e-12)
        un = view[6:9] / torch.clamp(torch.sqrt(torch.sum(view[6:9] * view[6:9])), min=1e-12)
        ray_o = tuple(view[j] + xr * rn[j] + yr * un[j] for j in range(3))
        ray_d = normalize(tuple(view[9 + j] + r * view[3 + j] + s * view[6 + j] - ray_o[j]
                                for j in range(3)))
        zero = torch.zeros(N, dtype=dt, device=dev)
        one = torch.ones(N, dtype=dt, device=dev)
        sky = torch.full((N,), self.sky, dtype=dt, device=dev)
        hit = self.trace(ray_o, ray_d, torch.full((N,), T_MAX, dtype=dt, device=dev), False)
        found = hit.inst >= 0
        st = dict(rad=tuple(torch.where(found, 0.0, sky) for _ in range(3)),
                  thr=(one, one, one), alive=found,
                  spec_or_first=torch.ones(N, dtype=torch.bool, device=dev),
                  prev_pdf=zero, o=ray_o, d=ray_d, pick_norm=zero)
        for depth in range(self.max_bounces + 1):
            if depth > 0:
                hit = self.trace(st["o"], st["d"], torch.where(st["alive"], T_MAX, 0.0).to(dt),
                                 False)
            st = self._vertex(st, hit, depth, sample, pid, sky)
        return torch.clamp(torch.stack(st["rad"], 1).to(torch.float32), min=0.0)

    def _vertex(self, st, hit: Hit, depth: int, sample, pid, sky):
        dt, dev = self.dt, self.dev
        first, last = depth == 0, depth == self.max_bounces
        N = pid.shape[0]
        found = (hit.inst >= 0) & st["alive"]
        rad = st["rad"]
        if not first:
            rad = where(st["alive"] & ~found, add(rad, mul(st["thr"], (sky, sky, sky))), rad)
        b = self._basis(hit, st["d"])
        pos = add(st["o"], scale(st["d"], hit.t))
        lod = torch.log2(torch.clamp(hit.t * self.view[16] * b["lodf"] * 1024.0, min=1e-6))
        mat, emission = self._material(b, lod)
        thr0 = st["thr"]
        ns = normalize(tuple(0.0 * b["tan"][j] + 0.0 * b["bitan"][j] + 1.0 * b["ns"][j]
                             for j in range(3)))
        is_emitter = torch.maximum(torch.maximum(emission[0], emission[1]), emission[2]) > 0.0
        if first:
            mis_w = torch.ones(N, dtype=dt, device=dev)
        else:
            cos_hit = torch.abs(dot(b["ng"], st["d"]))
            n_l = float(max(self.n_lights, 1))
            cvec = sub(b["centroid"], st["o"])
            c_d2 = torch.clamp(dot(cvec, cvec), min=1e-8)
            cos_c = torch.abs(dot(b["ng"], cvec)) / torch.sqrt(c_d2)
            q_hit = lum(*emission) * b["world_area"] * cos_c / c_d2
            hit_pick = torch.where(st["pick_norm"] > 0,
                                   0.5 * q_hit / torch.clamp(st["pick_norm"], min=1e-12) + 0.5 / n_l,
                                   1.0 / n_l)
            pdf_nee = (hit.t * hit.t) / torch.clamp(cos_hit * b["world_area"], min=1e-8) * hit_pick
            nee_exists = (b["light"] >= 0) & (self.n_area > 0)
            mis_w = torch.where(st["spec_or_first"] | ~nee_exists, 1.0,
                                st["prev_pdf"] / torch.clamp(st["prev_pdf"] + pdf_nee, min=1e-12))
        rad = where(found & is_emitter, add(rad, scale(mul(thr0, emission), mis_w)), rad)
        alive = found & ~is_emitter
        tan, bitan = b["tan"], b["bitan"]
        wo = to_local(tan, bitan, ns, neg(st["d"]))
        ul = [x.to(dt) for x in sobol(sample, pid, 2 + depth * 3, 3)]
        wi_l, dist_l, rop, is_delta, pdf_sa, pick_norm = self._sample_light(pos, *ul, ns)
        wi_loc = to_local(tan, bitan, ns, wi_l)
        f_l = bsdf_eval(mat, wo, wi_loc, self.features)
        cos_l = torch.clamp(wi_loc[2], min=0.0)
        can = alive & (cos_l > 0)
        occ = self.trace(add(pos, scale(b["ng"], SHADOW_EPS)), wi_l,
                         torch.where(can, dist_l - 2.0 * SHADOW_EPS, 0.0).to(dt), True)
        if self.n_area > 0:
            pdf_b = bsdf_pdf(mat, wo, wi_loc, self.features)
            mis_nee = torch.where(is_delta, 1.0, pdf_sa / torch.clamp(pdf_sa + pdf_b, min=1e-12))
        else:
            mis_nee = 1.0
        w_nee = cos_l * mis_nee
        contrib = tuple(torch.clamp(thr0[j] * f_l[j] * w_nee * rop[j], 0.0, self.clamp)
                        for j in range(3))
        rad = where(can & ~occ, add(rad, contrib), rad)
        if last:
            return dict(st, rad=rad)
        ub = [x.to(dt) for x in sobol(sample, pid, 3 + depth * 3, 3)]
        wi_b, f_b, pdf_b, delta_b = bsdf_sample(mat, wo, *ub, self.features)
        ok = alive & (pdf_b > 1e-9) & (torch.abs(wi_b[2]) > 1e-6)
        bsdf_w = torch.abs(wi_b[2]) / torch.clamp(pdf_b, min=1e-9)
        side = torch.where(wi_b[2] >= 0, 1.0, -1.0).to(dt)
        return dict(rad=rad, thr=where(ok, mul(thr0, scale(f_b, bsdf_w)), thr0), alive=ok,
                    spec_or_first=(mat.roughness < 0.05) | delta_b, prev_pdf=pdf_b,
                    o=where(ok, add(pos, scale(b["ng"], SHADOW_EPS * side)), st["o"]),
                    d=where(ok, to_world(tan, bitan, ns, wi_b), st["d"]), pick_norm=pick_norm)
