"""Disney principled BSDF — batched torch eval/sample/pdf.

Counterpart of `rfw_tpu/render/disney.py`, operation for operation: diffuse
(Burley retro-reflection + subsurface approximation), GTR2 specular with
Smith G, GTR1 clearcoat, sheen, and a delta-style dielectric transmission
lobe. Shading happens in local space (normal = +z); eval() excludes the
|cos θ_i| factor, which the integrator multiplies.

The core (`*_c` functions) is component-wise: 3-vectors and colors are
(x, y, z) tuples of (R,) float32 tensors, as in the JAX package, so the two
can be compared term by term.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

PI = 3.14159265358979

#: static feature bits for eval/pdf/sample `features` masks: lobes whose
#: driving parameter is zero across the whole material set are skipped.
#: wavefront.mat_feature_mask() computes the mask from DeviceMaterials.
FEAT_TRANSMISSION = 1
FEAT_CLEARCOAT = 2
FEAT_SUBSURFACE = 4
FEAT_SHEEN = 8
FEAT_ALL = 15

#: a component 3-vector: (x, y, z) tuple of (R,) tensors
Vec3C = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class MatParams(NamedTuple):
    """Per-point material parameters, each (R,); base_color is a Vec3C."""

    base_color: Vec3C  # linear albedo
    metallic: torch.Tensor
    roughness: torch.Tensor
    specular_f: torch.Tensor  # "specular" 0..1 -> F0 = 0.08 * specular_f
    specular_tint: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    subsurface: torch.Tensor
    anisotropic: torch.Tensor
    transmission: torch.Tensor  # 0..1 specular-transmission weight
    eta_rel: torch.Tensor  # relative ior across the interface for the
    #   incident side: 1/ior entering the medium, ior exiting

    @property
    def base_c(self) -> Vec3C:
        return self.base_color


# --------------------------------------------------------- component vec3
def v3_split(v: torch.Tensor) -> Vec3C:
    return (v[..., 0], v[..., 1], v[..., 2])


def v3_stack(v: Vec3C) -> torch.Tensor:
    return torch.stack(v, dim=-1)


def v3_dot(a: Vec3C, b: Vec3C) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v3_cross(a: Vec3C, b: Vec3C) -> Vec3C:
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def v3_add(a: Vec3C, b: Vec3C) -> Vec3C:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v3_sub(a: Vec3C, b: Vec3C) -> Vec3C:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v3_scale(a: Vec3C, s) -> Vec3C:
    return (a[0] * s, a[1] * s, a[2] * s)


def v3_mul(a: Vec3C, b: Vec3C) -> Vec3C:
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def v3_neg(a: Vec3C) -> Vec3C:
    return (-a[0], -a[1], -a[2])


def v3_where(m: torch.Tensor, a: Vec3C, b: Vec3C) -> Vec3C:
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]))


def v3_normalize(a: Vec3C, eps: float = 1e-12) -> Vec3C:
    inv = 1.0 / torch.clamp(torch.sqrt(v3_dot(a, a)), min=eps)
    return v3_scale(a, inv)


def _sqr(x):
    return x * x


def _luminance_c(r, g, b):
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


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


def _smith_ggx(ndv, a):
    a2 = _sqr(a)
    b = _sqr(ndv)
    return 1.0 / (ndv + torch.sqrt(a2 + b - a2 * b) + 1e-12)


def _tint_c(base: Vec3C) -> Vec3C:
    lum = _luminance_c(*base)
    has = lum > 0
    inv = 1.0 / torch.clamp(lum, min=1e-7)
    one = torch.ones_like(lum)
    return (torch.where(has, base[0] * inv, one),
            torch.where(has, base[1] * inv, one),
            torch.where(has, base[2] * inv, one))


# ------------------------------------------------------------- component core
def disney_eval_c(p: MatParams, wo: Vec3C, wi: Vec3C,
                  features: int = FEAT_ALL) -> Vec3C:
    """BRDF value f(wo, wi) in local space (+z = normal), per channel.

    Reflection-only; the transmission share scales the reflective lobes
    down (the glass lobe itself is sampled by disney_sample_c)."""
    ndv = wo[2]
    ndl = wi[2]
    up = (ndv > 1e-6) & (ndl > 1e-6)

    h = v3_normalize(v3_add(wi, wo))
    ndh = h[2]
    ldh = v3_dot(wi, h)

    base = p.base_c
    ctint = _tint_c(base)
    f0_base = 0.08 * p.specular_f
    spec_lerp = tuple(
        (1.0 - p.specular_tint) + p.specular_tint * ctint[j] for j in range(3))
    one_m_metal = 1.0 - p.metallic
    cspec0 = tuple(
        f0_base * spec_lerp[j] * one_m_metal + base[j] * p.metallic
        for j in range(3))
    csheen = tuple(
        (1.0 - p.sheen_tint) + p.sheen_tint * ctint[j] for j in range(3))

    # --- diffuse (Burley retro-reflection + subsurface approx) -------------
    fl = _schlick(ndl)
    fv = _schlick(ndv)
    fd90 = 0.5 + 2.0 * _sqr(ldh) * p.roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)

    if features & FEAT_SUBSURFACE:
        fss90 = _sqr(ldh) * p.roughness
        fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
        ss = 1.25 * (fss * (1.0 / torch.clamp(ndl + ndv, min=1e-6) - 0.5) + 0.5)
        diffuse_w = torch.where(
            p.subsurface > 0,
            (1.0 - p.subsurface) * fd + p.subsurface * ss, fd)
    else:
        diffuse_w = fd
    diff_s = diffuse_w / PI

    # --- sheen + specular GTR2 + clearcoat GTR1 ----------------------------
    fh = _schlick(ldh)
    alpha = torch.clamp(_sqr(p.roughness), min=1e-3)
    ds = _gtr2(ndh, alpha)
    gs = _smith_ggx(ndl, alpha) * _smith_ggx(ndv, alpha)
    dsgs = ds * gs

    if features & FEAT_CLEARCOAT:
        a_cc = 0.1 * (1.0 - p.clearcoat_gloss) + 0.001 * p.clearcoat_gloss
        dr = _gtr1(ndh, a_cc)
        fr = 0.04 + 0.96 * fh
        gr = _smith_ggx(ndl, 0.25) * _smith_ggx(ndv, 0.25)
        f_cc = 0.25 * p.clearcoat * dr * fr * gr
    else:
        f_cc = 0.0

    if features & FEAT_TRANSMISSION:
        # the glass lobe replaces the reflective BSDF in proportion to the
        # transmission share
        trans_scale = 1.0 - torch.clamp(p.transmission, 0.0, 1.0) * one_m_metal
    else:
        trans_scale = None

    out = []
    zero = torch.zeros_like(ndv)
    for j in range(3):
        f_diffuse = base[j] * diff_s
        if features & FEAT_SHEEN:
            f_diffuse = f_diffuse + fh * p.sheen * csheen[j]
        fs = cspec0[j] + (1.0 - cspec0[j]) * fh
        f = f_diffuse * one_m_metal + dsgs * fs + f_cc
        if trans_scale is not None:
            f = f * trans_scale
        out.append(torch.where(up, f, zero))
    return tuple(out)


def disney_pdf_c(p: MatParams, wo: Vec3C, wi: Vec3C,
                 features: int = FEAT_ALL) -> torch.Tensor:
    """Solid-angle pdf of disney_sample for the given pair. (R,)."""
    ndl = wi[2]
    ndv = wo[2]
    up = (ndl > 1e-6) & (ndv > 1e-6)
    h = v3_normalize(v3_add(wi, wo))
    ndh = torch.clamp(h[2], min=1e-6)
    ldh = torch.clamp(v3_dot(wi, h), min=1e-6)

    spec_w, cc_w, diff_w = _lobe_weights(p, features)

    alpha = torch.clamp(_sqr(p.roughness), min=1e-3)
    pdf_spec = _gtr2(ndh, alpha) * ndh / (4.0 * ldh)
    pdf_diff = ndl / PI

    pdf = diff_w * pdf_diff + spec_w * pdf_spec
    if features & FEAT_CLEARCOAT:
        a_cc = 0.1 * (1.0 - p.clearcoat_gloss) + 0.001 * p.clearcoat_gloss
        pdf = pdf + cc_w * _gtr1(ndh, a_cc) * ndh / (4.0 * ldh)
    if features & FEAT_TRANSMISSION:
        # the reflective mixture only gets (1 - transmission-share) of the
        # sample picks (disney_sample_c) — the MIS competitor pdf must match
        trans_w = torch.clamp(p.transmission, 0.0, 1.0) * (1.0 - p.metallic)
        pdf = pdf * (1.0 - trans_w)
    return torch.where(up, pdf, 0.0)


def _lobe_weights(p: MatParams, features: int = FEAT_ALL
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sampling mixture weights (specular, clearcoat, diffuse) for the
    reflective lobes, summing to 1."""
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


def fresnel_dielectric(cos_i: torch.Tensor, eta_rel: torch.Tensor) -> torch.Tensor:
    """Exact unpolarized dielectric Fresnel reflectance; 1.0 under total
    internal reflection."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = _sqr(eta_rel) * (1.0 - _sqr(cos_i))
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta_rel * cos_i - cos_t) / torch.clamp(eta_rel * cos_i + cos_t, min=1e-12)
    r_perp = (cos_i - eta_rel * cos_t) / torch.clamp(cos_i + eta_rel * cos_t, min=1e-12)
    f = 0.5 * (_sqr(r_par) + _sqr(r_perp))
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def _refract_c(wo: Vec3C, h: Vec3C, eta_rel):
    """Refract -wo through microfacet normal h. Returns (wi, tir)."""
    cos_i = v3_dot(wo, h)
    sin2_t = _sqr(eta_rel) * (1.0 - _sqr(cos_i))
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    k = eta_rel * cos_i - cos_t
    wi = v3_add(v3_scale(v3_neg(wo), eta_rel), v3_scale(h, k))
    return v3_normalize(wi), tir


def _sample_cosine_c(u1, u2) -> Vec3C:
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    return (r * torch.cos(phi), r * torch.sin(phi),
            torch.sqrt(torch.clamp(1.0 - u1, min=0.0)))


def _sample_gtr2_h_c(u1, u2, alpha) -> Vec3C:
    phi = 2.0 * PI * u1
    cos_t = torch.sqrt(torch.clamp(
        (1.0 - u2) / (1.0 + (_sqr(alpha) - 1.0) * u2), 0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - _sqr(cos_t), min=0.0))
    return (sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def _sample_gtr1_h_c(u1, u2, a) -> Vec3C:
    a2 = _sqr(a)
    phi = 2.0 * PI * u1
    cos2 = (1.0 - torch.pow(a2, 1.0 - u2)) / torch.clamp(1.0 - a2, min=1e-6)
    cos_t = torch.sqrt(torch.clamp(cos2, 0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos2, min=0.0))
    return (sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)


def _reflect_c(wo: Vec3C, h: Vec3C) -> Vec3C:
    k = 2.0 * v3_dot(wo, h)
    return v3_sub(v3_scale(h, k), wo)


def disney_sample_c(
    p: MatParams, wo: Vec3C, u0, u1, u2, features: int = FEAT_ALL
) -> Tuple[Vec3C, Vec3C, torch.Tensor, torch.Tensor]:
    """Sample wi ~ pdf; (u0,u1,u2): (R,) uniforms (lobe pick, 2x direction).

    Returns (wi, f, pdf, is_delta) — f excludes the ndl cosine. The
    transmission lobe is delta-style: pdf == trans share and
    f == weight * share / |wi.z|, so f*|cos|/pdf applies exactly `weight`;
    is_delta marks those lanes."""
    spec_w, cc_w, _ = _lobe_weights(p, features)
    pick = u0
    if features & FEAT_TRANSMISSION:
        trans_w = torch.clamp(p.transmission, 0.0, 1.0) * (1.0 - p.metallic)
        use_trans = pick < trans_w
        # remap the survivor pick into [0,1) for the reflective lobes
        pick_r = torch.clamp(
            (pick - trans_w) / torch.clamp(1.0 - trans_w, min=1e-8), 0.0, 1.0)
    else:
        use_trans = torch.zeros(pick.shape, dtype=torch.bool, device=pick.device)
        pick_r = pick
    use_spec = (~use_trans) & (pick_r < spec_w)
    use_cc = (~use_trans) & (~use_spec) & (pick_r < spec_w + cc_w)

    alpha = torch.clamp(_sqr(p.roughness), min=1e-3)

    h_spec = _sample_gtr2_h_c(u1, u2, alpha)
    wi_spec = _reflect_c(wo, h_spec)
    wi_diff = _sample_cosine_c(u1, u2)

    if features & FEAT_CLEARCOAT:
        a_cc = 0.1 * (1.0 - p.clearcoat_gloss) + 0.001 * p.clearcoat_gloss
        h_cc = _sample_gtr1_h_c(u1, u2, a_cc)
        wi_cc = _reflect_c(wo, h_cc)
        wi = v3_where(use_spec, wi_spec, v3_where(use_cc, wi_cc, wi_diff))
    else:
        wi = v3_where(use_spec, wi_spec, wi_diff)
    wi = v3_normalize(wi)
    f = disney_eval_c(p, wo, wi, features)
    # disney_pdf_c already folds in the (1 - trans_w) share
    pdf = disney_pdf_c(p, wo, wi, features)

    if not features & FEAT_TRANSMISSION:
        return wi, f, pdf, use_trans

    # ---- transmission lobe (delta-style) -----------------------------------
    h_t = h_spec  # same GTR2 microfacet roughens the glass
    cos_ih = v3_dot(wo, h_t)
    fr = fresnel_dielectric(cos_ih, p.eta_rel)
    wi_refr, tir = _refract_c(wo, h_t, p.eta_rel)
    # Fresnel decision reuses the remapped pick inside the trans share
    pick_t = torch.clamp(pick / torch.clamp(trans_w, min=1e-8), 0.0, 1.0)
    do_reflect = tir | (pick_t < fr)
    wi_trefl = _reflect_c(wo, h_t)
    wi_trans = v3_where(do_reflect, wi_trefl, wi_refr)
    # refraction tints by base_color; reflection is white
    base = p.base_c
    ones = torch.ones_like(base[0])
    w_trans = v3_where(do_reflect, (ones, ones, ones), base)
    abs_cos = torch.clamp(torch.abs(wi_trans[2]), min=1e-6)
    inv_share = torch.clamp(trans_w, min=1e-8) / abs_cos
    f_trans = v3_scale(w_trans, inv_share)
    pdf_trans = trans_w  # so f*cos/pdf = w_trans exactly

    wi = v3_where(use_trans, wi_trans, wi)
    f = v3_where(use_trans, f_trans, f)
    pdf = torch.where(use_trans, pdf_trans, pdf)
    return wi, f, pdf, use_trans


# ------------------------------------------------------------------ frames
def build_tangent_frame_c(n: Vec3C) -> Tuple[Vec3C, Vec3C]:
    """Branchless orthonormal basis (Duff et al. 2017), component form."""
    s = torch.where(n[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[2])
    b = n[0] * n[1] * a
    t = (1.0 + s * n[0] * n[0] * a, s * b, -s * n[0])
    bt = (b, s + n[1] * n[1] * a, -n[1])
    return t, bt


def to_local_c(t: Vec3C, bt: Vec3C, n: Vec3C, v: Vec3C) -> Vec3C:
    return (v3_dot(v, t), v3_dot(v, bt), v3_dot(v, n))


def to_world_c(t: Vec3C, bt: Vec3C, n: Vec3C, v: Vec3C) -> Vec3C:
    return (v[0] * t[0] + v[1] * bt[0] + v[2] * n[0],
            v[0] * t[1] + v[1] * bt[1] + v[2] * n[1],
            v[0] * t[2] + v[1] * bt[2] + v[2] * n[2])


# -------------------------------------------------- batched (R,3) wrappers
# rfw_tpu's original API, which its tools and tests call: (R,3) tensors in
# and out, over the component core the integrator runs.
def disney_eval(p: MatParams, wo: torch.Tensor, wi: torch.Tensor,
                features: int = FEAT_ALL) -> torch.Tensor:
    """BRDF value f(wo, wi) in local space (+z = normal). (R,3)."""
    return v3_stack(disney_eval_c(p, v3_split(wo), v3_split(wi), features))


def disney_pdf(p: MatParams, wo: torch.Tensor, wi: torch.Tensor,
               features: int = FEAT_ALL) -> torch.Tensor:
    """Solid-angle pdf of disney_sample for the given pair. (R,)."""
    return disney_pdf_c(p, v3_split(wo), v3_split(wi), features)


def disney_sample(p: MatParams, wo: torch.Tensor, u: torch.Tensor,
                  features: int = FEAT_ALL):
    """Sample wi ~ pdf; u: (R,3) uniforms. Returns (wi (R,3), f (R,3),
    pdf (R,), is_delta (R,)); see disney_sample_c."""
    wi, f, pdf, is_delta = disney_sample_c(
        p, v3_split(wo), u[..., 0], u[..., 1], u[..., 2], features)
    return v3_stack(wi), v3_stack(f), pdf, is_delta


def build_tangent_frame(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal basis (Duff et al. 2017). n: (R,3)."""
    t, bt = build_tangent_frame_c(v3_split(n))
    return v3_stack(t), v3_stack(bt)


def to_local(t, bt, n, v) -> torch.Tensor:
    return v3_stack(to_local_c(v3_split(t), v3_split(bt), v3_split(n), v3_split(v)))


def to_world(t, bt, n, v) -> torch.Tensor:
    return v3_stack(to_world_c(v3_split(t), v3_split(bt), v3_split(n), v3_split(v)))
