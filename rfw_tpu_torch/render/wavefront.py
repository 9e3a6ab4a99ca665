"""Wavefront path-tracing integrator (torch).

Counterpart of `rfw_tpu/render/wavefront.py`. Its uniforms come from the
Owen-scrambled Sobol sampler (`sampler="sobol"`, keyed by pixel id and
sample index) or, as the JAX package's default `sampler="random"` draws
them, from threefry keyed by the caller's `key` (`render/threefry.py`,
bit for bit `jax.random`). One call of `render_sample` traces one sample
per pixel:

  * vertex 0 is peeled: camera rays, closest hit, sky for misses, then
    shading of the hit lanes (sorted to a hit prefix when compaction is on),
    NEE with a shadow ray, AOV capture and a BSDF bounce;
  * middle vertices (1..max_bounces-1) and the final vertex (NEE only)
    first re-sort the path state by (direction octant, origin Morton code)
    with dead lanes last, then trace and shade the live prefix (the
    lockstep tier keeps the lanes in order and traces all of them);
  * radiance returns in pixel order through the carried pixel id `pid`.

Every per-lane quantity is computed as in the JAX package, operation for
operation, and every result is keyed by `pid`, so images agree per pixel
with the Sobol sampler whatever the lane order. The random sampler draws
its uniforms per LANE, as the JAX package does, so the lane order decides
which pixel takes which number: the sorts here are stable, as XLA's CPU
sort is in practice (`lax.sort` promises no order among equal keys), and
lanes whose sort keys tie keep their order. Where the JAX package selects
among static prefix lengths on the device (`lax.switch`), this port reads
the live count to the host with `.item()` and slices the prefix — the
reference GPU renderer reads its queue counters back the same way.

Traversal, as `config.traversal` names it (`resolve_traversal`), in
three tiers:

  * the kernel tier — "auto", "pallas" and "pallas_hbm": `ops.traverse.
    closest_hit` / `occluded`, which launch the CUDA kernels (K1/K2) for
    tensors on the card and run their plain torch walks for tensors on the
    CPU. `two_phase="auto"` or `"on"` traces the bounce rays' closest hits
    through the two-phase path (`ops.traverse_items.
    twophase_closest_with_fallback`: instance entries, per-instance BLAS
    walks by K3, classic retrace of truncated rays), and `RFW_TP_SHADOW=1`
    their shadow rays through its any-hit twin; primaries and vertex-0
    shadows stay on the classic kernel. `RFW_DENSE_ITEMS=1` turns on the
    dense items tier inside it. On the card the treelets are read from
    global memory for both Pallas names;
  * the packet tier — "packet": `render.packet` (tiles sharing one stack);
  * the lockstep tier — "lockstep", and "packet" when no tile width
    divides R: `render.intersect.bvh_closest_hit` / `bvh_occluded`, the
    per-ray walk of the binary arenas (the oracle tier).

The name also sets the lane order, as in the JAX package: the
pixel-block swizzle, the bounce sort and the compaction use the tile
width, which is PALLAS_LANES (1,024) for "pallas" and "pallas_hbm" when R
is a multiple of it and the first of (config.lanes, 512, 256, 128, 64,
32) that divides R otherwise; "lockstep" keeps lanes in pixel order, with
no swizzle, no sort and no compaction. Two-phase runs for "auto", and for
the Pallas names at R a multiple of PALLAS_LANES; at other R the JAX
package traces the Pallas names with its packet tier, and the port keeps
them on the kernels in that tier's lane order with two-phase off. Under
the random sampler the lane order decides which pixel draws which
numbers, so each name renders the same image as the JAX package's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rfw_tpu_torch.accel.lbvh import morton_codes_c
from rfw_tpu_torch.ops.traverse import closest_hit, occluded, prepare_scene
from rfw_tpu_torch.ops.traverse_items import (
    twophase_closest_with_fallback,
    twophase_occluded_with_fallback,
)
from rfw_tpu_torch.render import disney
from rfw_tpu_torch.render.atlas import TextureAtlas, sample_bilinear
from rfw_tpu_torch.render.disney import (
    Vec3C, _luminance_c, v3_add, v3_cross, v3_dot, v3_mul, v3_neg,
    v3_normalize, v3_scale, v3_stack, v3_sub, v3_where,
)
from rfw_tpu_torch.render.intersect import Hit, T_MAX, bvh_closest_hit, bvh_occluded
from rfw_tpu_torch.render.packet import (
    packet_closest_hit, packet_occluded, prepare_packet_scene,
)
from rfw_tpu_torch.render import threefry
from rfw_tpu_torch.render.lights_pack import DeviceLights
from rfw_tpu_torch.render.sampler import sample_slot

PI = 3.14159265358979
#: the values of RenderConfig.traversal
TRAVERSALS = ("auto", "lockstep", "packet", "pallas", "pallas_hbm")
#: tile width of the kernel tier ("pallas", "pallas_hbm"): rfw_tpu's
#: LANES8, 8 x 128 rays
PALLAS_LANES = 1024

#: padded light-table row cap for the per-point potential-weighted pick;
#: above it the global power CDF picks. Read at import as rfw_tpu reads it
#: (RFW_POTENTIAL_MAX=0: the power CDF always)
POTENTIAL_MAX = int(os.environ.get("RFW_POTENTIAL_MAX", "16"))
#: the bounce sort's keys (`sort_key`): direction octant major (the
#: default), origin Morton code major, origin major with an octant
#: tiebreak, and the previous hit's instance major
SORT_KEYS = ("octmorton", "morton", "mortonoct", "instance")
#: the bounce sort's key, read at import as rfw_tpu reads it; RFW_SORT_INST=1
#: is the legacy alias for "instance"
SORT_KEY = os.environ.get(
    "RFW_SORT_KEY",
    "instance" if os.environ.get("RFW_SORT_INST", "0") == "1" else "octmorton")
#: a dead lane's sort key: above every live lane's under every key
#: ("mortonoct" reaches 2^31 - 1), so the live lanes form the prefix that
#: compaction traces
DEAD_KEY = 1 << 31


def _block_swizzle(width: int, height: int, lanes: int, device=None):
    """Permutation mapping swizzled ray order -> linear pixel index, so
    each run of `lanes` rays covers a coherent (BY x BX) pixel block.
    Returns (px, py, inv_perm) or None when dimensions don't block-align."""
    for bx in (32, 64, 128, 16):
        by = lanes // bx
        if by and lanes % bx == 0 and width % bx == 0 and height % by == 0:
            break
    else:
        return None
    n = width * height
    s = torch.arange(n, dtype=torch.int32, device=device)
    nbx = width // bx
    block, off = s // lanes, s % lanes
    iby, ibx = off // bx, off % bx
    gby, gbx = block // nbx, block % nbx
    px = gbx * bx + ibx
    py = gby * by + iby
    lin = py * width + px
    inv = torch.argsort(lin).to(torch.int32)
    return px, py, inv


def _fetch_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for an (N,C) table and (R,) int indices. (The JAX package
    turns mid-size tables into a one-hot matmul at HIGHEST precision, which
    gives the same values.)"""
    return table[idx.long()]


@dataclass(frozen=True)
class RenderConfig:
    """Integrator settings, with the JAX package's fields and defaults:
    sampler "random" (threefry, needs `key`) or "sobol" (needs
    `sample_index`), two_phase "auto"/"on"/"off", traversal one of
    TRAVERSALS."""

    max_bounces: int = 3
    clamp: float = 10.0
    sky_intensity: float = 0.0  # constant sky radiance multiplier
    shadow_eps: float = 1e-3
    aovs: bool = True
    ao_aov: bool = False  # ambient-occlusion AOV: one cosine-hemisphere
    #   occlusion probe per first hit
    ao_radius: float = 0.5
    traversal: str = "auto"  # "auto" | "pallas" | "pallas_hbm" (the
    #   kernels at any R: on CUDA tensors the kernels, on CPU tensors their
    #   plain walks) | "packet" (tiles of `lanes` rays sharing a stack) |
    #   "lockstep" (one stack per ray, binary arenas, lanes in pixel order)
    lanes: int = 256  # ray tile width of "auto" and "packet" (and of the
    #   Pallas names where R is no multiple of PALLAS_LANES): pixel-block
    #   swizzle, packet tiles and prefix grain
    pixel_center: bool = False  # deterministic pixel-center primaries
    sampler: str = "random"  # "random" (threefry, per-lane uniforms from
    #   `key`) | "sobol" (Owen-scrambled Sobol keyed by pixel and
    #   sample_index)
    tex_mask: int = 15  # bitmask of texture-map kinds present in the
    #   material set (1=diffuse 2=normal 4=metallic-roughness 8=emissive);
    #   tex_kinds_mask() computes it
    trilinear: bool = False  # two-mip blend (2 quad gathers vs 1)
    mat_features: int = 15  # bitmask of BSDF lobes present (disney.FEAT_*);
    #   mat_feature_mask() computes it
    sort_secondary: bool = True  # re-sort bounce rays by (direction
    #   octant, origin Morton code), dead lanes last
    two_phase: str = "auto"  # "auto" | "on" | "off": in the kernel tier,
    #   bounce rays' closest hits go through the two-phase path
    #   (instance entries, per-instance BLAS walks, classic retrace of
    #   truncated rays); "off" traces every ray with the classic kernel
    has_area_lights: bool = True  # the scene has area lights (else the
    #   NEE<->BSDF MIS machinery is skipped)
    compaction: str = "auto"  # "auto" | "off": bounce vertices run on the
    #   live prefix at the smallest of a few lengths >= the live count
    #   (with the bounce sort, outside the lockstep tier); RFW_COMPACTION=0
    #   turns it off as "off" does
    tp_K: int = 6  # two-phase: instance entries kept per ray
    tp_items_per_ray: float = 1.25  # two-phase: item buffer slots per ray
    #   (items beyond it are dropped and their rays retraced)


class SampleResult(NamedTuple):
    radiance: torch.Tensor  # (R,3)
    albedo: torch.Tensor  # (R,3) first-hit albedo
    normal: torch.Tensor  # (R,3) first-hit shading normal
    depth: torch.Tensor  # (R,) first-hit t
    position: torch.Tensor  # (R,3) first-hit world pos
    ao: torch.Tensor  # (R,) ambient occlusion (1 = open)


# ------------------------------------------------------------------ camera
def camera_rays_c(
    view: torch.Tensor, width: int, height: int, pixel_ids=None, jitter=None,
    key=None,
) -> Tuple[Vec3C, Vec3C]:
    """Primary rays from the (24,) camera vector: dir = normalize(p1 +
    r*right + s*up - origin), origin jittered on a 9-bladed lens aperture
    when lens_size > 0. `jitter` = ((R,2) pixel jitter, (R,2) lens
    uniforms); without it both are drawn from the threefry `key`, as the
    JAX package draws them. Returns (origin, dir) as Vec3C."""
    if jitter is None:
        if key is None:
            raise ValueError("camera_rays_c needs jitter uniforms or a key")
        k1, k2 = threefry.split(key)
        n = width * height
        jitter = (threefry.uniform(k1, (n, 2), device=view.device),
                  threefry.uniform(k2, (n, 2), device=view.device))
    pos = view[0:3]
    right = view[3:6]
    up = view[6:9]
    p1 = view[9:12]
    lens_size = view[15]
    inv_w = view[17]
    inv_h = view[18]

    n = width * height
    if pixel_ids is None:
        ar = torch.arange(n, dtype=torch.int32, device=view.device)
        px, py = ar % width, ar // width
    else:
        px, py = pixel_ids
    jit_uv, lens_uv = jitter
    r = (px.to(torch.float32) + jit_uv[:, 0]) * inv_w
    s = (py.to(torch.float32) + jit_uv[:, 1]) * inv_h

    # 9-bladed aperture: pick a blade wedge, then sample the triangle
    # spanned by its two blade directions with the fold trick
    b9 = lens_uv[:, 0] * 9.0
    blade = torch.floor(b9)
    r2 = b9 - blade
    r3 = lens_uv[:, 1]
    fold = (r2 + r3) > 1.0
    r2 = torch.where(fold, 1.0 - r2, r2)
    r3 = torch.where(fold, 1.0 - r3, r3)
    a1 = blade * (PI / 4.5)
    a2 = (blade + 1.0) * (PI / 4.5)
    xr = (torch.sin(a1) * r2 + torch.sin(a2) * r3) * lens_size
    yr = (torch.cos(a1) * r2 + torch.cos(a2) * r3) * lens_size
    rn = right / torch.clamp(torch.sqrt(torch.sum(right * right)), min=1e-12)
    un = up / torch.clamp(torch.sqrt(torch.sum(up * up)), min=1e-12)
    o = tuple(pos[j] + xr * rn[j] + yr * un[j] for j in range(3))
    d = tuple(p1[j] + r * right[j] + s * up[j] - o[j] for j in range(3))
    return o, v3_normalize(d)


def camera_rays(
    view: torch.Tensor, width: int, height: int, key=None, pixel_ids=None, jitter=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R,3) wrapper over camera_rays_c, with rfw_tpu's argument order
    (the threefry `key` third): (origins, directions)."""
    o, d = camera_rays_c(view, width, height, pixel_ids, jitter, key)
    return v3_stack(o), v3_stack(d)


# ------------------------------------------------------------------ lights
def _light_potentials(lights: DeviceLights, p: Vec3C,
                      ns: Optional[Vec3C]) -> list:
    """Per-point unshadowed contribution estimate for every padded light
    row: a list of L (R,) tensors, scored as one (L, R) computation. Area
    rows anchor at the triangle centroid (the anchor the emissive-hit MIS
    reconstruction rebuilds); the surface cosine sharpens delta rows only."""
    np_, nsp, nd = lights.n_point[0], lights.n_spot[0], lights.n_dir[0]
    total = np_ + nsp + nd + lights.n_area[0]
    table = lights.light_table  # (L, 20)
    L = table.shape[0]
    idx = torch.arange(L, device=table.device)
    is_point = (idx < np_)[:, None]                    # (L, 1)
    is_spot = (~is_point) & (idx < np_ + nsp)[:, None]
    is_dir = (~is_point) & (~is_spot) & (idx < np_ + nsp + nd)[:, None]
    is_area = (idx >= np_ + nsp + nd)[:, None]

    def col(j):
        return table[:, j:j + 1]  # (L, 1)

    lum_en = 0.2126 * col(6) + 0.7152 * col(7) + 0.0722 * col(8)
    lum_rad = 0.2126 * col(12) + 0.7152 * col(13) + 0.0722 * col(14)
    cen = tuple(
        torch.where(is_area, (col(j) + col(3 + j) + col(6 + j)) / 3.0, col(j))
        for j in range(3))
    vec = tuple(cen[j] - p[j][None, :] for j in range(3))  # (L, R)
    d2 = torch.clamp(
        vec[0] * vec[0] + vec[1] * vec[1] + vec[2] * vec[2], min=1e-8)
    inv_d = 1.0 / torch.sqrt(d2)
    wi = tuple(vec[j] * inv_d for j in range(3))
    # linear spot falloff (matches _sample_light_c's radiance formula)
    cos_to = -(wi[0] * col(3) + wi[1] * col(4) + wi[2] * col(5))
    falloff = torch.clamp((cos_to - col(16))
                          / torch.clamp(col(15) - col(16), min=1e-6), 0.0, 1.0)
    # emitter-side cosine for area rows
    cos_l = torch.abs(wi[0] * col(9) + wi[1] * col(10) + wi[2] * col(11))
    q = torch.where(
        is_point, lum_en / d2,
        torch.where(
            is_spot, lum_en * falloff / d2,
            torch.where(is_dir, lum_en.expand_as(d2),
                        lum_rad * col(17) * cos_l / d2),
        ),
    )
    if ns is not None:
        wi_eff = tuple(
            torch.where(is_dir, -col(3 + j), wi[j]) for j in range(3))
        cos_s = torch.clamp(
            ns[0][None, :] * wi_eff[0] + ns[1][None, :] * wi_eff[1]
            + ns[2][None, :] * wi_eff[2], min=0.0)
        q = q * torch.where(is_area, 1.0, cos_s)
    q = torch.where((idx < total)[:, None], q, 0.0)
    return [q[i] for i in range(L)]


def _sample_light_c(
    lights: DeviceLights, p: Vec3C, u0: torch.Tensor, u1: torch.Tensor,
    u2: torch.Tensor, ns: Optional[Vec3C] = None,
):
    """Pick one light per lane and sample a point/direction toward it.

    Returns (wi, dist, radiance_over_pdf, is_delta, pdf_area_solidangle,
    pick_norm), as `rfw_tpu.render.wavefront._sample_light_c`:
    radiance_over_pdf includes 1/pick_prob; pdf_area_solidangle is the
    solid-angle NEE pdf (area lights, pick probability included);
    pick_norm is the potential normalization Z (0 on the power-CDF path)."""
    np_, ns_l, nd, na = (
        lights.n_point[0], lights.n_spot[0], lights.n_dir[0], lights.n_area[0]
    )
    total = np_ + ns_l + nd + na
    R = p[0].shape[0]
    use_potential = lights.light_table.shape[0] <= POTENTIAL_MAX
    if use_potential:
        qs = _light_potentials(lights, p, ns)
        z = qs[0]
        for q_i in qs[1:]:
            z = z + q_i
        n_f = torch.clamp(total.to(torch.float32), min=1.0)
        # defensive 50/50 blend with uniform
        inv_z = torch.where(z > 0, 0.5 / torch.clamp(z, min=1e-12), 0.0)
        half_u = 0.5 / n_f
        probs = [
            torch.where(i < total, q_i * inv_z + half_u, 0.0)
            for i, q_i in enumerate(qs)
        ]
        # running-sum CDF walk over the row list (summation order kept)
        cdf_total = probs[0]
        for pr in probs[1:]:
            cdf_total = cdf_total + pr
        target = u0 * cdf_total
        run = torch.zeros_like(target)
        count = torch.zeros(R, dtype=torch.int32, device=target.device)
        for pr in probs:
            run = run + pr
            count = count + (target > run).to(torch.int32)
        pick = torch.minimum(count, torch.clamp(total - 1, min=0)).to(torch.int32)
        pick_pr = torch.zeros_like(target)
        for i, pr in enumerate(probs):
            pick_pr = torch.where(pick == i, pr, pick_pr)
        pick_p = torch.clamp(
            pick_pr / torch.clamp(cdf_total, min=1e-12), min=1e-12)
        pick_norm = z
    else:
        # power-proportional pick via the precomputed global cdf
        pick = torch.minimum(
            torch.searchsorted(lights.pick_cdf, u0, right=True).to(torch.int32),
            torch.clamp(total - 1, min=0),
        )
        pick_norm = torch.zeros(R, dtype=torch.float32, device=u0.device)

    row = _fetch_rows(lights.light_table, pick)  # (R,20)
    if not use_potential:
        pick_p = torch.clamp(row[:, 18], min=1e-12)
    r_pos = (row[:, 0], row[:, 1], row[:, 2])   # pos | v0
    r_dir = (row[:, 3], row[:, 4], row[:, 5])   # dir | v1
    r_en = (row[:, 6], row[:, 7], row[:, 8])    # energy | v2

    is_point = pick < np_
    is_spot = (~is_point) & (pick < np_ + ns_l)
    is_dir = (~is_point) & (~is_spot) & (pick < np_ + ns_l + nd)
    is_area = (~is_point) & (~is_spot) & (~is_dir)

    # ---- point -----------------------------------------------------------
    p_vec = v3_sub(r_pos, p)
    p_d2 = torch.clamp(v3_dot(p_vec, p_vec), min=1e-8)
    p_dist = torch.sqrt(p_d2)
    p_wi = v3_scale(p_vec, 1.0 / p_dist)
    p_rad = v3_scale(r_en, 1.0 / p_d2)

    # ---- spot: linear cone falloff ---------------------------------------
    cos_to = -v3_dot(p_wi, r_dir)
    ci = row[:, 15]
    co = row[:, 16]
    falloff = torch.clamp((cos_to - co) / torch.clamp(ci - co, min=1e-6), 0.0, 1.0)
    s_rad = v3_scale(r_en, falloff / p_d2)

    # ---- directional -----------------------------------------------------
    d_wi = v3_neg(r_dir)
    d_rad = r_en

    # ---- area ------------------------------------------------------------
    su = torch.sqrt(torch.clamp(u1, min=0.0))
    b0 = 1.0 - su
    b1 = u2 * su
    b2 = 1.0 - b0 - b1
    a_pt = tuple(
        r_pos[j] * b0 + r_dir[j] * b1 + r_en[j] * b2 for j in range(3))
    a_vec = v3_sub(a_pt, p)
    a_d2 = torch.clamp(v3_dot(a_vec, a_vec), min=1e-8)
    a_dist = torch.sqrt(a_d2)
    a_wi = v3_scale(a_vec, 1.0 / a_dist)
    # two-sided emitters: |cos|
    n_a = (row[:, 9], row[:, 10], row[:, 11])
    cos_l = torch.abs(v3_dot(a_wi, n_a))
    a_pdf_sa = a_d2 / torch.clamp(cos_l * row[:, 17], min=1e-8)
    a_rad = v3_scale((row[:, 12], row[:, 13], row[:, 14]),
                     1.0 / torch.clamp(a_pdf_sa, min=1e-8))

    wi = v3_where(is_point, p_wi,
                  v3_where(is_spot, p_wi, v3_where(is_dir, d_wi, a_wi)))
    dist = torch.where(
        is_point | is_spot, p_dist, torch.where(is_dir, T_MAX * 0.5, a_dist))
    rad_sel = v3_where(is_point, p_rad,
                       v3_where(is_spot, s_rad,
                                v3_where(is_dir, d_rad, a_rad)))
    none = total == 0
    scale = torch.where(none, 0.0, 1.0 / pick_p)
    rad_over_pdf = v3_scale(rad_sel, scale)
    is_delta = is_point | is_spot | is_dir
    pdf_sa = torch.where(is_area, a_pdf_sa * pick_p, 0.0)
    return wi, dist, rad_over_pdf, is_delta, pdf_sa, pick_norm


# ---------------------------------------------------------------- materials
def tex_kinds_mask(tex_table) -> int:
    """RenderConfig.tex_mask for a materials tex table (N,6): which map
    kinds any material binds."""
    t = np.asarray(tex_table.cpu() if isinstance(tex_table, torch.Tensor)
                   else tex_table)
    if t.size == 0:
        return 0
    return int((1 * (t[:, 0] >= 0).any()) | (2 * (t[:, 1] >= 0).any())
               | (4 * (t[:, 2] >= 0).any()) | (8 * (t[:, 3] >= 0).any()))


def mat_feature_mask(mats) -> int:
    """RenderConfig.mat_features for DeviceMaterials: which BSDF lobes any
    material drives (params columns 1=subsurface, 6=sheen, 8=clearcoat,
    10=transmission)."""
    pr = mats.params
    pr = np.asarray(pr.cpu() if isinstance(pr, torch.Tensor) else pr)
    if pr.size == 0:
        return 0
    return int((disney.FEAT_TRANSMISSION * (pr[:, 10] > 0).any())
               | (disney.FEAT_CLEARCOAT * (pr[:, 8] > 0).any())
               | (disney.FEAT_SUBSURFACE * (pr[:, 1] > 0).any())
               | (disney.FEAT_SHEEN * (pr[:, 6] > 0).any()))


def _fetch_material_c(
    mats, atlas: TextureAtlas, mat_id, uv_c, lod, entering,
    tex_mask: int = 15, trilinear: bool = False,
):
    """Gather material params + textures for hit points. uv_c is a (u, v)
    pair of (R,) tensors; colors are Vec3C.

    Returns (params, emission_rgb, normal_map tangent-space, untextured
    emission, absorption_rgb). The whole material record — floats, texture
    ids as exact f32 ints and, per bound texture kind, its atlas metadata
    (off0 split hi/lo 12 bits, w0, h0, mip_count, srgb) — resolves in one
    row gather, as in the JAX package."""
    cols = [mats.color, mats.params, mats.absorption[:, :3],
            mats.tex.to(torch.float32)]
    meta_base = {}
    if atlas.meta is not None:
        am = atlas.meta
        nb = 29
        for k in range(4):
            if not (tex_mask >> k) & 1:
                continue  # masked kind: never sampled, skip its columns
            mk = am[torch.clamp(mats.tex[:, k], min=0).long()]  # (M,8)
            cols.append(torch.stack([
                (mk[:, 0] >> 12).to(torch.float32),
                (mk[:, 0] & 4095).to(torch.float32),
                mk[:, 1].to(torch.float32),
                mk[:, 2].to(torch.float32),
                mk[:, 3].to(torch.float32),
                mk[:, 4].to(torch.float32),
            ], dim=1))
            meta_base[k] = nb
            nb += 6
    blk = _fetch_rows(torch.cat(cols, dim=1), mat_id)
    color = (blk[:, 0], blk[:, 1], blk[:, 2])
    params = blk[:, 4:20]
    absorption = (blk[:, 20], blk[:, 21], blk[:, 22])
    tex = torch.round(blk[:, 23:29]).to(torch.int32)

    def _i32(x):
        return torch.round(x).to(torch.int32)

    def _meta_row(k):
        if k not in meta_base:
            return None
        b = meta_base[k]
        off0 = (_i32(blk[:, b]) << 12) | _i32(blk[:, b + 1])
        return (off0, _i32(blk[:, b + 2]), _i32(blk[:, b + 3]),
                _i32(blk[:, b + 4]), blk[:, b + 5] > 0.5)

    R = mat_id.shape[0]
    ones = torch.ones(R, dtype=torch.float32, device=blk.device)
    zeros = torch.zeros(R, dtype=torch.float32, device=blk.device)
    if tex_mask & 1:
        diff = sample_bilinear(atlas, tex[:, 0], uv_c, lod, trilinear,
                               meta_row=_meta_row(0))
        base_color = tuple(color[j] * diff[:, j] for j in range(3))
    else:
        base_color = color

    if tex_mask & 4:
        mr = sample_bilinear(atlas, tex[:, 2], uv_c, lod, trilinear,
                             meta_row=_meta_row(2))
        has_mr = tex[:, 2] >= 0
        metallic = torch.where(has_mr, params[:, 0] * mr[:, 2], params[:, 0])
        roughness = torch.where(has_mr, params[:, 3] * mr[:, 1], params[:, 3])
    else:
        metallic = params[:, 0]
        roughness = params[:, 3]

    if tex_mask & 2:
        nrm_tex = sample_bilinear(atlas, tex[:, 1], uv_c, lod, trilinear,
                                  meta_row=_meta_row(1))
        has_n = tex[:, 1] >= 0
        n_ts = tuple(
            torch.where(has_n, nrm_tex[:, j] * 2.0 - 1.0,
                        ones if j == 2 else zeros)
            for j in range(3))
    else:
        n_ts = (zeros, zeros, ones)

    # emission: color channels > 1 mark emissive
    is_emissive = torch.maximum(torch.maximum(color[0], color[1]), color[2]) > 1.0
    # untextured emission — what area-light extraction registered
    emission_base = tuple(
        torch.where(is_emissive, color[j], 0.0) for j in range(3))
    if tex_mask & 8:
        emis_tex = sample_bilinear(atlas, tex[:, 3], uv_c, lod, trilinear,
                                   meta_row=_meta_row(3))
        emission = tuple(
            torch.where(is_emissive, color[j] * emis_tex[:, j], 0.0)
            for j in range(3))
    else:
        emission = emission_base

    # transmission lobe side: 1/ior entering the medium, ior leaving
    eta = torch.where(params[:, 11] > 1e-3, params[:, 11], 1.5)
    eta_rel = torch.where(entering, 1.0 / eta, eta)
    p = disney.MatParams(
        base_color=base_color,
        metallic=metallic,
        roughness=torch.clamp(roughness, 0.02, 1.0),
        specular_f=params[:, 2],
        specular_tint=params[:, 4],
        sheen=params[:, 6],
        sheen_tint=params[:, 7],
        clearcoat=params[:, 8],
        clearcoat_gloss=params[:, 9],
        subsurface=params[:, 1],
        anisotropic=params[:, 5],
        transmission=params[:, 10],
        eta_rel=eta_rel,
    )
    return p, emission, n_ts, emission_base, absorption


# -------------------------------------------------------------- integrator
def _mat3_apply(m: torch.Tensor, base: int, v: Vec3C) -> Vec3C:
    """Row-major 3x3 from columns [base:base+9] of an (R,K) fetch, applied
    to a component vector."""
    return (
        m[:, base + 0] * v[0] + m[:, base + 1] * v[1] + m[:, base + 2] * v[2],
        m[:, base + 3] * v[0] + m[:, base + 4] * v[1] + m[:, base + 5] * v[2],
        m[:, base + 6] * v[0] + m[:, base + 7] * v[1] + m[:, base + 8] * v[2],
    )


def _inst_table(scene) -> torch.Tensor:
    """(I,21) per-instance [normal matrix (9) | 3x3 (9) | translation (3)]."""
    n_inst = scene.inst_matrix.shape[0]
    return torch.cat(
        [scene.inst_normal.reshape(n_inst, 9),
         scene.inst_matrix[:, :3, :3].reshape(n_inst, 9),
         scene.inst_matrix[:, :3, 3]], dim=1)


def _shading_basis_c(scene, hit: Hit, ray_d: Vec3C,
                     inst_table: Optional[torch.Tensor] = None) -> dict:
    """Interpolate shading attributes at hits from the baked (T,32)
    tri_shade record (one gather) and the hit instance's matrices."""
    prim = torch.clamp(hit.prim, min=0).long()
    inst = torch.clamp(hit.inst, min=0)
    w = 1.0 - hit.u - hit.v
    rec = scene.tri_shade[prim]  # (R,32)
    ns_obj = tuple(
        w * rec[:, j] + hit.u * rec[:, 3 + j] + hit.v * rec[:, 6 + j]
        for j in range(3))
    uv = tuple(
        w * rec[:, 9 + j] + hit.u * rec[:, 11 + j] + hit.v * rec[:, 13 + j]
        for j in range(2))
    tan_obj = (rec[:, 15], rec[:, 16], rec[:, 17])
    handed = rec[:, 18]
    e1_obj = (rec[:, 19], rec[:, 20], rec[:, 21])
    e2_obj = (rec[:, 22], rec[:, 23], rec[:, 24])
    lodf = rec[:, 25]
    centroid_obj = (rec[:, 26], rec[:, 27], rec[:, 28])
    mat_id = rec[:, 29].to(torch.int32)  # exact f32 ints (pack.py)
    light_id = rec[:, 30].to(torch.int32)

    if inst_table is None:
        inst_table = _inst_table(scene)
    m = _fetch_rows(inst_table, inst)  # (R,21)
    ns = v3_normalize(_mat3_apply(m, 0, ns_obj))
    e1w = _mat3_apply(m, 9, e1_obj)
    e2w = _mat3_apply(m, 9, e2_obj)
    ng_raw = v3_cross(e1w, e2w)
    area2 = torch.sqrt(torch.clamp(v3_dot(ng_raw, ng_raw), min=0.0))
    ng = v3_scale(ng_raw, 1.0 / torch.clamp(area2, min=1e-12))
    flip = v3_dot(ng, ray_d) > 0
    ng = v3_where(flip, v3_neg(ng), ng)
    ns = v3_where(v3_dot(ns, ng) < 0, v3_neg(ns), ns)

    tan = _mat3_apply(m, 9, tan_obj)
    tan = v3_sub(tan, v3_scale(ns, v3_dot(tan, ns)))
    tlen = torch.sqrt(torch.clamp(v3_dot(tan, tan), min=0.0))
    t_fallback, _ = disney.build_tangent_frame_c(ns)
    tan = v3_where(tlen > 1e-6,
                   v3_scale(tan, 1.0 / torch.clamp(tlen, min=1e-12)), t_fallback)
    bitan = v3_scale(v3_cross(ns, tan), handed)
    centroid_w = v3_add(_mat3_apply(m, 9, centroid_obj),
                        (m[:, 18], m[:, 19], m[:, 20]))
    return dict(ns=ns, ng=ng, uv=uv, tan=tan, bitan=bitan,
                world_area=0.5 * area2, entering=~flip, lodf=lodf,
                centroid_w=centroid_w, mat_id=mat_id, light_id=light_id)


class _PathState(NamedTuple):
    """Per-lane path state carried between vertices; `pid` maps each lane
    to its pixel. Every 3-vector is a Vec3C."""

    radiance: Vec3C
    throughput: Vec3C
    alive: torch.Tensor
    spec_or_first: torch.Tensor
    prev_bsdf_pdf: torch.Tensor
    sort_hint: torch.Tensor  # previous bounce's hit instance (-1 first)
    ray_o: Vec3C
    ray_d: Vec3C
    pid: torch.Tensor  # pixel linear index of this lane
    pick_norm: torch.Tensor  # previous vertex's light-potential
    #   normalization Z (0 on the power-CDF path)


def _tmap(fn, *trees):
    """Apply fn leaf-wise over tensors nested in tuples / NamedTuples /
    dicts of the same structure."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: _tmap(fn, *[t[k] for t in trees]) for k in t0}
    vals = [_tmap(fn, *xs) for xs in zip(*trees)]
    return type(t0)(*vals) if hasattr(t0, "_fields") else tuple(vals)


def sort_key(ray_o: Vec3C, ray_d: Vec3C, scene_mn: torch.Tensor, scene_mx: torch.Tensor,
             alive=None, hint=None, key=None) -> torch.Tensor:
    """The bounce sort's (R,) int64 key under `key` (default SORT_KEY), as
    rfw_tpu's `_sort_state` builds it from the direction octant (0..7) and
    the origin's 30-bit Morton code `cell` in the scene box:

      octmorton   octant * 2^27 + (cell >> 5)
      morton      cell
      mortonoct   ((cell >> 8) << 9) | (octant << 6) | ((cell >> 2) & 63)
      instance    (clip(hint, -1, 254) + 1) * 2^22 + octant * 2^19
                  + (cell >> 11)

    `hint` is each lane's previous hit instance (-1 for none; None: all
    -1). DEAD_KEY (last) where `alive` is False: unlike rfw_tpu, whose dead
    key 2^30 lies below "mortonoct"'s keys for origins in the upper half of
    the box along x, every key keeps the live lanes first. Lanes take the
    order of a stable sort by it."""
    key = SORT_KEY if key is None else key
    octant = (
        (ray_d[0] >= 0).to(torch.int64)
        + 2 * (ray_d[1] >= 0).to(torch.int64)
        + 4 * (ray_d[2] >= 0).to(torch.int64)
    )
    cell = morton_codes_c(ray_o, scene_mn, scene_mx)
    if key == "octmorton":
        skey = octant * (1 << 27) + (cell >> 5)
    elif key == "morton":
        skey = cell
    elif key == "mortonoct":
        skey = ((cell >> 8) << 9) | (octant << 6) | ((cell >> 2) & 63)
    elif key == "instance":
        h = torch.full_like(cell, -1) if hint is None else hint.to(torch.int64)
        skey = (torch.clamp(h, -1, 254) + 1) * (1 << 22) + octant * (1 << 19) + (cell >> 11)
    else:
        raise ValueError(f"sort key {key!r} not in {SORT_KEYS}")
    return skey if alive is None else torch.where(alive, skey, DEAD_KEY)


def _prefix_sizes(R: int, g: int, max_bounces: int = 1) -> list:
    """Live-prefix lengths for bounce-vertex compaction: multiples of the
    tile width g, ascending, last == R. Deep-bounce configs (>= 3) add two
    sub-floor rungs unless RFW_DEEP_LADDER=0 (read at each call). Small
    ray counts get a single full-length entry."""
    if R < 4 * g or R < 16384:
        return [R]
    fracs = (0.1875, 0.375, 0.5625, 1.0)
    if max_bounces >= 3 and os.environ.get("RFW_DEEP_LADDER", "1") == "1":
        fracs = (0.046875, 0.09375) + fracs
    out = []
    for f in fracs:
        p = min(R, -(-int(R * f) // g) * g)
        if p not in out:
            out.append(p)
    return out


def _pick_prefix(sizes: list, live: int) -> int:
    """The smallest prefix length in `sizes` that covers `live` lanes."""
    return sizes[sum(int(live > p) for p in sizes[:-1])]


class Tier(NamedTuple):
    """How a render traces its rays (`resolve_traversal`)."""

    trace: str  # "kernel" (ops.traverse) | "packet" | "lockstep"
    lanes: int  # tile width: pixel-block swizzle and prefix grain (0: none)
    two_phase: bool  # bounce rays may take the two-phase path


def resolve_traversal(config: RenderConfig, R: int) -> Tier:
    """The tier that traces a render of R rays, as `rfw_tpu`'s
    render_sample resolves `config.traversal`, with the lane order of
    `rfw_tpu`'s tier of that name:

      * "pallas" / "pallas_hbm" with R a multiple of PALLAS_LANES: the
        kernels, tiles of PALLAS_LANES, two-phase as `config.two_phase`;
      * "pallas" / "pallas_hbm" otherwise: the kernels in the lane order
        of `rfw_tpu`'s packet branch, which these names take there: tiles
        of the first of (config.lanes, 512, 256, 128, 64, 32) that divides
        R (0: none), two-phase off;
      * "auto": the kernels, tiles of that first divisor, two-phase as
        `config.two_phase`;
      * "packet": the packet tier, tiles of that first divisor, or the
        lockstep tier where none divides R;
      * "lockstep": the lockstep tier, no tiles.
    """
    mode = config.traversal
    if mode not in TRAVERSALS:
        raise ValueError(f"traversal={mode!r}: expected one of {TRAVERSALS}")
    pallas = mode in ("pallas", "pallas_hbm")
    if pallas and R % PALLAS_LANES == 0:
        return Tier("kernel", PALLAS_LANES, True)
    if mode == "lockstep":
        return Tier("lockstep", 0, False)
    lanes = next((l for l in (config.lanes, 512, 256, 128, 64, 32) if R % l == 0), 0)
    if mode == "auto":
        return Tier("kernel", lanes, True)
    if pallas:
        return Tier("kernel", lanes, False)
    return Tier("packet", lanes, False) if lanes else Tier("lockstep", 0, False)


def _tracers(scene, config: RenderConfig, tier: Tier):
    """(closest, occluded, bounce closest, bounce occluded) trace functions
    of (ray_o, ray_d, t_limit) for a tier. Where the tier allows it, the
    kernels trace bounce rays' closest hits through the two-phase path when
    `two_phase` is "auto" or "on", and their shadow rays too with
    RFW_TP_SHADOW=1."""
    lanes = tier.lanes
    if tier.trace == "lockstep":
        def closest(o, d, tl):
            return bvh_closest_hit(scene, o, d, tl)

        def occl(o, d, tl):
            return bvh_occluded(scene, o, d, tl)

        return closest, occl, closest, occl
    if tier.trace == "packet":
        pps = prepare_packet_scene(scene)

        def closest(o, d, tl):
            return packet_closest_hit(pps, o, d, tl, lanes=lanes)

        def occl(o, d, tl):
            return packet_occluded(pps, o, d, tl, lanes=lanes)

        return closest, occl, closest, occl
    ps = prepare_scene(scene)

    def closest(o, d, tl):
        return closest_hit(ps, o, d, tl)

    def occl(o, d, tl):
        return occluded(ps, o, d, tl)

    bounce, occl_bounce = closest, occl
    if tier.two_phase and config.two_phase in ("auto", "on"):
        def bounce(o, d, tl):
            return twophase_closest_with_fallback(
                ps, o, d, tl, K=config.tp_K, items_per_ray=config.tp_items_per_ray)

        if os.environ.get("RFW_TP_SHADOW", "0") == "1":
            def occl_bounce(o, d, tl):
                return twophase_occluded_with_fallback(
                    ps, o, d, tl, K=config.tp_K, items_per_ray=config.tp_items_per_ray)
    return closest, occl, bounce, occl_bounce


def render_sample(
    scene,  # TraceScene of tensors (rfw_tpu_torch.convert)
    mats,  # DeviceMaterials of tensors
    atlas: TextureAtlas,  # of tensors
    lights: DeviceLights,  # of tensors
    view: torch.Tensor,  # (24,) camera vector
    width: int,
    height: int,
    config: RenderConfig = RenderConfig(),
    sky_tex=None,  # (1,) atlas texture id; None = constant sky
    sample_index=None,  # progressive sample index (sobol), int or tensor
    key=None,  # threefry key ((2,) words, `threefry.PRNGKey`) for "random"
    row0=0,  # first film row of this call's strip (int or 0-d tensor)
) -> SampleResult:
    """Trace one sample per pixel; returns radiance + first-hit AOVs in
    pixel order. Counterpart of `rfw_tpu.render.wavefront.render_sample`,
    with `key` a keyword (the JAX function takes it positionally). As
    there, the Sobol sampler runs when `config.sampler == "sobol"` and a
    `sample_index` is given; otherwise the random sampler, which needs
    `key`.

    `row0` renders a film strip: the call covers rows [row0, row0 +
    height) of the frame whose view `view` is (camera NDC reads the
    frame's 1/height from it), so pixel ids, Sobol keys and camera rays
    are the full frame's and the outputs hold the strip's pixels in
    order. The random sampler draws per lane of the strip, as the JAX
    package's does."""
    use_sobol = config.sampler == "sobol" and sample_index is not None
    if not use_sobol and key is None:
        raise ValueError(
            f"sampler={config.sampler!r} without a sample_index draws from "
            "threefry and needs a key")
    if config.two_phase not in ("auto", "on", "off"):
        raise ValueError(f"two_phase={config.two_phase!r}")
    dev = view.device
    f32 = torch.float32
    R = width * height
    inst_table = _inst_table(scene)
    tier = resolve_traversal(config, R)
    tile_lanes = tier.lanes
    trace_closest, trace_occluded, trace_bounce, trace_occluded_bounce = _tracers(
        scene, config, tier)

    sw = _block_swizzle(width, height, tile_lanes, dev) if tile_lanes else None
    if sw is not None:
        px, py, _ = sw
        pixel_ids = (px, py)
        pid = (py * width + px).to(torch.int32)
    else:
        pixel_ids = None
        pid = torch.arange(R, dtype=torch.int32, device=dev)
    pid_base = 0  # the strip's first pixel id: lane pid - pid_base = output row
    if not (isinstance(row0, int) and row0 == 0):
        # the block swizzle ran on the strip's own width x height; offset
        # py so camera NDC, Sobol keys and pid are the full frame's
        if pixel_ids is None:
            px, py = pid % width, pid // width
        else:
            px, py = pixel_ids
        row0 = torch.as_tensor(row0, dtype=torch.int32, device=dev)
        pixel_ids = (px, py + row0)
        pid = (pixel_ids[1] * width + px).to(torch.int32)
        pid_base = row0.long() * width

    if not use_sobol:
        k_cam, k_loop = threefry.split(key)
    vertex_keys = {}

    def uniforms(slot, nu, pid_s, depth=0, sub=0):
        """(n, nu) uniforms: Sobol `slot` per pixel, or threefry per lane
        from fold_in(fold_in(k_loop, depth), sub) (the JAX package's `kd`
        of vertex `depth` and its use `sub`)."""
        if use_sobol:
            return sample_slot(sample_index, pid_s, slot, nu)
        if depth not in vertex_keys:
            vertex_keys[depth] = threefry.fold_in(k_loop, depth)
        return threefry.uniform(threefry.fold_in(vertex_keys[depth], sub),
                                (pid_s.shape[0], nu), device=dev)

    if config.pixel_center:
        ray_o, ray_d = camera_rays_c(
            view, width, height, pixel_ids,
            jitter=(torch.full((R, 2), 0.5, dtype=f32, device=dev),
                    torch.zeros((R, 2), dtype=f32, device=dev)),
        )
    elif use_sobol:
        ray_o, ray_d = camera_rays_c(
            view, width, height, pixel_ids,
            jitter=(uniforms(0, 2, pid), uniforms(1, 2, pid)))
    else:
        ray_o, ray_d = camera_rays_c(view, width, height, pixel_ids, key=k_cam)

    total_lights = (
        lights.n_point[0] + lights.n_spot[0] + lights.n_dir[0] + lights.n_area[0]
    )
    scene_mn = scene.tlas_min[0]
    scene_mx = scene.tlas_max[0]
    use_potential_pick = lights.light_table.shape[0] <= POTENTIAL_MAX

    # ------------------------------------------------------------ shading
    def _sky(dirs: Vec3C) -> Vec3C:
        """Sky radiance per ray: constant, or an equirectangular skybox."""
        n = dirs[0].shape[0]
        if sky_tex is not None:
            sky_u = torch.atan2(dirs[2], dirs[0]) / (2.0 * PI) + 0.5
            sky_v = torch.acos(torch.clamp(dirs[1], -1.0, 1.0)) / PI
            tex_ids = torch.as_tensor(sky_tex, device=dev).reshape(-1)[:1].expand(n)
            sky_rgb = sample_bilinear(atlas, tex_ids, (sky_u, sky_v),
                                      torch.zeros(n, dtype=f32, device=dev))
            return tuple(sky_rgb[:, j] * config.sky_intensity for j in range(3))
        const = torch.full((n,), config.sky_intensity, dtype=f32, device=dev)
        return (const, const, const)

    def shade_vertex(st: _PathState, hit: Hit, depth: int, first: bool,
                     last: bool, add_sky: bool = True):
        """One path vertex on an n-lane front. Returns (new state, aovs
        dict | None). add_sky=False when misses were credited already."""
        n = st.pid.shape[0]
        found = (hit.prim >= 0) & st.alive

        if add_sky:
            radiance = v3_where(
                st.alive & ~found,
                v3_add(st.radiance, v3_mul(st.throughput, _sky(st.ray_d))),
                st.radiance,
            )
        else:
            radiance = st.radiance

        # ---- shading point ----------------------------------------------
        basis = _shading_basis_c(scene, hit, st.ray_d, inst_table)
        pos = v3_add(st.ray_o, v3_scale(st.ray_d, hit.t))
        footprint = hit.t * view[16] * basis["lodf"] * 1024.0
        lod = torch.log2(torch.clamp(footprint, min=1e-6))
        params, emission, n_ts, emission_base, absorption = _fetch_material_c(
            mats, atlas, basis["mat_id"], basis["uv"], lod,
            basis["entering"], config.tex_mask, config.trilinear,
        )
        # Beer-Lambert: a backface hit on a transmissive material ends a
        # segment travelled inside the medium
        if config.mat_features & disney.FEAT_TRANSMISSION:
            inside_seg = found & ~basis["entering"] & (params.transmission > 0)
            atten = tuple(torch.exp(-absorption[j] * hit.t) for j in range(3))
            throughput0 = v3_where(inside_seg, v3_mul(st.throughput, atten),
                                   st.throughput)
        else:
            throughput0 = st.throughput
        ns = v3_normalize(tuple(
            n_ts[0] * basis["tan"][j] + n_ts[1] * basis["bitan"][j]
            + n_ts[2] * basis["ns"][j]
            for j in range(3)))

        # ---- AOVs (first hit only) ----------------------------------------
        aovs = None
        zero = torch.zeros(n, dtype=f32, device=dev)
        if first and not config.aovs:
            aovs = dict(
                albedo=(zero, zero, zero),
                normal=(zero, zero, zero),
                depth=torch.full((n,), T_MAX, dtype=f32, device=dev),
                position=(zero, zero, zero),
                ao=torch.ones(n, dtype=f32, device=dev),
            )
        elif first:
            aov_ao = torch.ones(n, dtype=f32, device=dev)
            if config.ao_aov:
                u_ao = uniforms(4, 3, st.pid, depth, 7)
                wi_ao = disney.to_world_c(
                    basis["tan"], basis["bitan"], basis["ns"],
                    disney._sample_cosine_c(u_ao[:, 0], u_ao[:, 1]),
                )
                occ_ao = trace_occluded(
                    v3_stack(v3_add(pos, v3_scale(basis["ng"], config.shadow_eps))),
                    v3_stack(wi_ao),
                    config.ao_radius,
                )
                aov_ao = torch.where(found & occ_ao, 0.0, aov_ao)
            base_c = params.base_c
            aovs = dict(
                albedo=tuple(torch.where(found, base_c[j], 0.0) for j in range(3)),
                normal=tuple(torch.where(found, ns[j], 0.0) for j in range(3)),
                depth=torch.where(found, hit.t, T_MAX),
                position=tuple(torch.where(found, pos[j], 0.0) for j in range(3)),
                ao=aov_ao,
            )

        # ---- emissive hits (MIS vs NEE) ---------------------------------
        is_emitter = torch.maximum(
            torch.maximum(emission[0], emission[1]), emission[2]) > 0.0
        if first or not config.has_area_lights:
            mis_w = torch.ones(n, dtype=f32, device=dev)
        else:
            cos_hit = torch.abs(v3_dot(basis["ng"], st.ray_d))
            # rebuild the hit emitter's pick probability at the previous
            # vertex (instance-exact: world_area is the hit instance's)
            lum_hit = _luminance_c(*emission_base)
            n_l = torch.clamp(lights.pick_n[0], min=1.0)
            if use_potential_pick:
                cvec = v3_sub(basis["centroid_w"], st.ray_o)
                c_d2 = torch.clamp(v3_dot(cvec, cvec), min=1e-8)
                cos_c = torch.abs(v3_dot(basis["ng"], cvec)) / torch.sqrt(c_d2)
                q_hit = lum_hit * basis["world_area"] * cos_c / c_d2
                hit_pick_p = torch.where(
                    st.pick_norm > 0,
                    0.5 * q_hit / torch.clamp(st.pick_norm, min=1e-12) + 0.5 / n_l,
                    1.0 / n_l,
                )
            else:
                w_hit = lum_hit * basis["world_area"] * PI
                hit_pick_p = torch.where(
                    lights.pick_w_total[0] > 0,
                    0.5 * w_hit / torch.clamp(lights.pick_w_total[0], min=1e-12)
                    + 0.5 / n_l,
                    1.0 / n_l,
                )
            pdf_nee_this = (hit.t * hit.t) / torch.clamp(
                cos_hit * basis["world_area"], min=1e-8) * hit_pick_p
            nee_exists = (basis["light_id"] >= 0) & (lights.n_area[0] > 0)
            mis_w = torch.where(
                st.spec_or_first | ~nee_exists,
                1.0,
                st.prev_bsdf_pdf
                / torch.clamp(st.prev_bsdf_pdf + pdf_nee_this, min=1e-12),
            )
        emit_mask = found & is_emitter
        radiance = v3_where(
            emit_mask,
            v3_add(radiance, v3_scale(v3_mul(throughput0, emission), mis_w)),
            radiance,
        )

        alive = found & ~is_emitter

        # ---- local frame -------------------------------------------------
        tan, bitan = basis["tan"], basis["bitan"]
        wo = disney.to_local_c(tan, bitan, ns, v3_neg(st.ray_d))

        # ---- NEE ---------------------------------------------------------
        u_l = uniforms(2 + depth * 3, 3, st.pid, depth, 1)
        (wi_l, dist_l, rad_over_pdf, is_delta, pdf_nee_sa,
         pick_norm) = _sample_light_c(lights, pos, u_l[:, 0], u_l[:, 1],
                                      u_l[:, 2], ns)
        wi_local = disney.to_local_c(tan, bitan, ns, wi_l)
        f_l = disney.disney_eval_c(params, wo, wi_local, config.mat_features)
        cos_l = torch.clamp(wi_local[2], min=0.0)
        can_light = alive & (total_lights > 0) & (cos_l > 0)
        shadow_o = v3_add(pos, v3_scale(basis["ng"], config.shadow_eps))
        # zero-contribution lanes get t_limit 0 and leave at once; bounce
        # vertices may take the two-phase any hit (RFW_TP_SHADOW=1)
        occ = (trace_occluded if first else trace_occluded_bounce)(
            v3_stack(shadow_o), v3_stack(wi_l),
            torch.where(can_light, dist_l - 2.0 * config.shadow_eps, 0.0))
        if config.has_area_lights:
            pdf_b_l = disney.disney_pdf_c(params, wo, wi_local,
                                          config.mat_features)
            mis_nee = torch.where(
                is_delta, 1.0,
                pdf_nee_sa / torch.clamp(pdf_nee_sa + pdf_b_l, min=1e-12))
        else:
            # delta-only lights: NEE is the sole strategy
            mis_nee = 1.0
        w_nee = cos_l * mis_nee
        contrib = tuple(
            torch.clamp(throughput0[j] * f_l[j] * w_nee * rad_over_pdf[j],
                        0.0, config.clamp)
            for j in range(3))
        radiance = v3_where(can_light & ~occ, v3_add(radiance, contrib), radiance)

        # ---- BSDF bounce (absent at the final vertex) ---------------------
        if last:
            return st._replace(
                radiance=radiance,
                throughput=throughput0,
                alive=torch.zeros_like(alive),
            ), aovs

        u_b = uniforms(3 + depth * 3, 3, st.pid, depth, 2)
        wi_b, f_b, pdf_b, delta_b = disney.disney_sample_c(
            params, wo, u_b[:, 0], u_b[:, 1], u_b[:, 2], config.mat_features)
        # transmission samples leave through the lower hemisphere: |cos|
        ok = alive & (pdf_b > 1e-9) & (torch.abs(wi_b[2]) > 1e-6)
        wi_world = disney.to_world_c(tan, bitan, ns, wi_b)
        bsdf_w = torch.abs(wi_b[2]) / torch.clamp(pdf_b, min=1e-9)
        throughput = v3_where(
            ok, v3_mul(throughput0, v3_scale(f_b, bsdf_w)), throughput0)
        # offset the continuation off the surface on the side it leaves
        side = torch.where(wi_b[2] >= 0, 1.0, -1.0)
        new_o = v3_where(
            ok, v3_add(pos, v3_scale(basis["ng"], config.shadow_eps * side)),
            st.ray_o)
        new_d = v3_where(ok, wi_world, st.ray_d)

        return st._replace(
            radiance=radiance,
            throughput=throughput,
            alive=ok,
            spec_or_first=(params.roughness < 0.05) | delta_b,
            prev_bsdf_pdf=pdf_b,
            sort_hint=torch.where(found, hit.inst, -1),
            ray_o=new_o,
            ray_d=new_d,
            pick_norm=pick_norm,
        ), aovs

    # ------------------------------------------------- bounce-vertex step
    # "lockstep" keeps lanes in pixel order: no sort, no compaction ("packet"
    # traced by the lockstep tier where no tile width divides R still sorts)
    do_sort = (config.sort_secondary and config.traversal != "lockstep"
               and config.max_bounces >= 1)
    # RFW_COMPACTION=0 (read at each call) traces every lane at every
    # vertex: no host read of a live count
    compact_on = (do_sort and config.compaction == "auto"
                  and os.environ.get("RFW_COMPACTION", "1") == "1")
    g = max(tile_lanes, 1)
    sizes = _prefix_sizes(R, g, config.max_bounces) if compact_on else [R]
    sizes0 = _prefix_sizes(R, g) if compact_on else [R]

    def _sort_state(st: _PathState) -> _PathState:
        """Re-sort lanes by SORT_KEY's key, dead last."""
        skey = sort_key(st.ray_o, st.ray_d, scene_mn, scene_mx, st.alive, st.sort_hint)
        perm = torch.sort(skey, stable=True).indices
        return _tmap(lambda a: a[perm], st)

    def _trace_and_shade(st: _PathState, depth: int, last: bool,
                         n: int) -> _PathState:
        """Trace + occlusion + shading on the first n lanes; the suffix
        (all dead) passes through untouched."""
        if n == R:
            pre, suf = st, None
        else:
            pre = _tmap(lambda a: a[:n], st)
            suf = _tmap(lambda a: a[n:], st)
        hit = trace_bounce(v3_stack(pre.ray_o), v3_stack(pre.ray_d),
                           torch.where(pre.alive, T_MAX, 0.0))
        new_pre, _ = shade_vertex(pre, hit, depth, first=False, last=last)
        if suf is None:
            return new_pre
        return _tmap(lambda a, b: torch.cat([a, b]), new_pre, suf)

    def bounce_vertex(st: _PathState, depth: int, last: bool) -> _PathState:
        if do_sort:
            st = _sort_state(st)
        if len(sizes) == 1:
            return _trace_and_shade(st, depth, last, sizes[0])
        # host read of the live count picks the prefix length
        live = int(st.alive.sum().item())
        return _trace_and_shade(st, depth, last, _pick_prefix(sizes, live))

    # ------------------------------------------------------- vertex 0
    hit0 = trace_closest(v3_stack(ray_o), v3_stack(ray_d), T_MAX)
    found0 = hit0.prim >= 0
    sky0 = _sky(ray_d)
    rad0 = tuple(torch.where(found0, 0.0, sky0[j]) for j in range(3))
    v0_last = config.max_bounces == 0

    def _mk_state(rad, alive, o, d, pp, n):
        one = torch.ones(n, dtype=f32, device=dev)
        return _PathState(
            radiance=rad,
            throughput=(one, one, one),
            alive=alive,
            spec_or_first=torch.ones(n, dtype=torch.bool, device=dev),
            prev_bsdf_pdf=torch.zeros(n, dtype=f32, device=dev),
            sort_hint=torch.full((n,), -1, dtype=torch.int32, device=dev),
            ray_o=o, ray_d=d, pid=pp,
            pick_norm=torch.zeros(n, dtype=f32, device=dev),
        )

    v0_compact = compact_on and len(sizes0) > 1
    if v0_compact:
        # shade only the hit lanes: sort by (hit?, prim block), then shade
        # the hit prefix at the smallest covering length
        key0 = torch.where(found0, hit0.prim >> 4, 1 << 30)
        perm = torch.sort(key0, stable=True).indices
        hit0, rad0, ray_o, ray_d, pid = _tmap(
            lambda a: a[perm], (hit0, rad0, ray_o, ray_d, pid))
        st = _mk_state(rad0, hit0.prim >= 0, ray_o, ray_d, pid, R)
        n0 = _pick_prefix(sizes0, int(found0.sum().item()))
        if n0 == R:
            st, aovs = shade_vertex(st, hit0, 0, first=True, last=v0_last,
                                    add_sky=False)
        else:
            pre, suf = _tmap(lambda a: a[:n0], st), _tmap(lambda a: a[n0:], st)
            new_pre, aovs = shade_vertex(pre, _tmap(lambda a: a[:n0], hit0), 0,
                                         first=True, last=v0_last, add_sky=False)
            st = _tmap(lambda a, b: torch.cat([a, b]), new_pre, suf)
            z = torch.zeros(R - n0, dtype=f32, device=dev)
            aov_tail = dict(
                albedo=(z, z, z), normal=(z, z, z),
                depth=torch.full((R - n0,), T_MAX, dtype=f32, device=dev),
                position=(z, z, z), ao=torch.ones(R - n0, dtype=f32, device=dev))
            aovs = _tmap(lambda a, b: torch.cat([a, b]), aovs, aov_tail)
    else:
        st = _mk_state(rad0, found0, ray_o, ray_d, pid, R)
        st, aovs = shade_vertex(st, hit0, 0, first=True, last=v0_last,
                                add_sky=False)
    pid0 = st.pid.long()  # lane -> pixel map of the vertex-0 order (AOVs)

    # ---------------------------------------------- middle + final vertices
    for depth in range(1, config.max_bounces):
        st = bounce_vertex(st, depth, last=False)
    if config.max_bounces >= 1:
        st = bounce_vertex(st, config.max_bounces, last=True)

    # ------------------------------------------------------------- output
    def to_pixels(a: torch.Tensor, lane_pid: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(a)
        out[lane_pid - pid_base] = a
        return out

    radiance = torch.clamp(to_pixels(v3_stack(st.radiance), st.pid.long()), min=0.0)
    if not config.aovs:
        # AOV outputs are constants: no reorder needed
        return SampleResult(
            radiance=radiance,
            albedo=v3_stack(aovs["albedo"]),
            normal=v3_stack(aovs["normal"]),
            depth=aovs["depth"],
            position=v3_stack(aovs["position"]),
            ao=aovs["ao"],
        )
    return SampleResult(
        radiance=radiance,
        albedo=to_pixels(v3_stack(aovs["albedo"]), pid0),
        normal=to_pixels(v3_stack(aovs["normal"]), pid0),
        depth=to_pixels(aovs["depth"], pid0),
        position=to_pixels(v3_stack(aovs["position"]), pid0),
        ao=to_pixels(aovs["ao"], pid0),
    )
