"""Texture atlas: flat texel pool + gather-based sampling.

Counterpart of `rfw_tpu/render/atlas.py`. `pack_atlas` is the same host
numpy packing: all mips of all textures in one (N, 4) pool of packed RGBA8
"quad rows" (row (x, y) holds the wrapped 2x2 bilinear footprint
[t(x,y), t(x+1,y), t(x,y+1), t(x+1,y+1)]), with a per-(texture, mip)
offset/size table. `sample_bilinear` is the torch sampler. On the device
the pool is an int32 tensor holding the uint32 bit patterns (torch has few
uint32 operations); the channel unpack masks each byte, so the sign of the
int32 view never matters.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

MAX_MIPS = 16


class TextureAtlas(NamedTuple):
    texels: np.ndarray  # (N,4) uint32 packed RGBA8 quad rows (int32 bits
    #   once converted to a tensor)
    offset: np.ndarray  # (T, MAX_MIPS) i32
    width: np.ndarray  # (T, MAX_MIPS) i32
    height: np.ndarray  # (T, MAX_MIPS) i32
    mip_count: np.ndarray  # (T,) i32
    srgb: np.ndarray  # (T,) bool — decode gamma after gather
    meta: Optional[np.ndarray] = None  # (T,8) i32 packed per-texture row
    #   [off0, w0, h0, mip_count, srgb, 0, 0, 0]; per-mip offset/width/height
    #   derive arithmetically (POT textures with exact-halving mips). None
    #   when a packed chain violates the halving rule: sample_bilinear then
    #   reads the per-mip tables.


def pack_atlas(textures: Sequence, pad_to: int = 1) -> TextureAtlas:
    """textures: sequence of scene.materials.Texture (or None placeholders)."""
    chunks: List[np.ndarray] = []
    n_tex = max(len(textures), 1)
    offset = np.zeros((n_tex, MAX_MIPS), np.int32)
    width = np.ones((n_tex, MAX_MIPS), np.int32)
    height = np.ones((n_tex, MAX_MIPS), np.int32)
    mip_count = np.ones(n_tex, np.int32)
    srgb = np.zeros(n_tex, bool)
    cursor = 0
    for ti, tex in enumerate(textures):
        if tex is None:
            continue
        srgb[ti] = tex.srgb
        mip_count[ti] = min(len(tex.mips), MAX_MIPS)
        for mi, mip in enumerate(tex.mips[:MAX_MIPS]):
            h, w = mip.shape[:2]
            rgba = mip.astype(np.uint32)
            packed = (
                rgba[..., 0] | (rgba[..., 1] << 8) | (rgba[..., 2] << 16) | (rgba[..., 3] << 24)
            )  # (h, w)
            # bake the wrapped 2x2 bilinear footprint into each row
            px = np.roll(packed, -1, axis=1)
            py = np.roll(packed, -1, axis=0)
            pxy = np.roll(px, -1, axis=0)
            quad = np.stack([packed, px, py, pxy], axis=-1).reshape(-1, 4)
            chunks.append(quad)
            offset[ti, mi] = cursor
            width[ti, mi] = w
            height[ti, mi] = h
            cursor += quad.shape[0]
    if not chunks:
        chunks = [np.full((1, 4), 0xFFFFFFFF, np.uint32)]
        cursor = 1
    texels = np.concatenate(chunks).astype(np.uint32)
    if pad_to > 1 and texels.shape[0] % pad_to:
        texels = np.concatenate(
            [texels, np.zeros((pad_to - texels.shape[0] % pad_to, 4), np.uint32)]
        )
    # packed one-gather metadata row (see TextureAtlas.meta): valid only if
    # every recorded mip chain follows the exact-halving derivation
    meta: Optional[np.ndarray] = np.zeros((n_tex, 8), np.int32)
    meta[:, 0] = offset[:, 0]
    meta[:, 1] = width[:, 0]
    meta[:, 2] = height[:, 0]
    meta[:, 3] = mip_count
    meta[:, 4] = srgb.astype(np.int32)
    for ti in range(n_tex):
        acc = int(offset[ti, 0])
        for mi in range(int(mip_count[ti])):
            w_m = max(int(width[ti, 0]) >> mi, 1)
            h_m = max(int(height[ti, 0]) >> mi, 1)
            if (w_m != width[ti, mi] or h_m != height[ti, mi]
                    or acc != offset[ti, mi]):
                meta = None
                break
            acc += w_m * h_m
        if meta is None:
            break
    return TextureAtlas(texels, offset, width, height, mip_count, srgb, meta)


def _unpack_rgba(px: torch.Tensor) -> torch.Tensor:
    """(...,) int32 RGBA8 bit patterns -> (...,4) float in [0,1]."""
    r = (px & 0xFF).to(torch.float32)
    g = ((px >> 8) & 0xFF).to(torch.float32)
    b = ((px >> 16) & 0xFF).to(torch.float32)
    a = ((px >> 24) & 0xFF).to(torch.float32)
    return torch.stack([r, g, b, a], dim=-1) * (1.0 / 255.0)


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


def sample_bilinear(
    atlas: TextureAtlas,
    tex_id: torch.Tensor,  # (R,) i32; <0 allowed (returns white)
    uv,  # (R,2) f32 or a (u, v) tuple of (R,) tensors; wrapped
    lod: torch.Tensor,  # (R,) f32 — mip level
    trilinear: bool = False,
    meta_row=None,  # optional prefetched metadata columns
    #   (off0, w0, h0, mip_count, srgb) as (R,) int/bool tensors (the
    #   integrator delivers them with the material row)
) -> torch.Tensor:
    """Mip-mapped RGBA fetch. Returns (R,4) linear values.

    Default is bilinear at the nearest mip (one quad-row gather brings the
    whole 2x2 footprint); trilinear blends two mips."""
    uv_u, uv_v = (uv[0], uv[1]) if isinstance(uv, tuple) else (
        uv[..., 0], uv[..., 1])
    valid = tex_id >= 0
    t = torch.clamp(tex_id, min=0).long()
    if meta_row is not None or atlas.meta is not None:
        if meta_row is not None:
            off0, w0i, h0i, mipc, srgb_f = meta_row
        else:
            row = atlas.meta[t]  # (R,8)
            off0, w0i, h0i = row[..., 0], row[..., 1], row[..., 2]
            mipc = row[..., 3]
            srgb_f = row[..., 4] > 0

        def mip_owh(m):
            w = torch.clamp(w0i >> m, min=1)
            h = torch.clamp(h0i >> m, min=1)
            off = off0
            for k in range(MAX_MIPS - 1):
                wk = torch.clamp(w0i >> k, min=1)
                hk = torch.clamp(h0i >> k, min=1)
                off = off + torch.where(k < m, wk * hk, 0)
            return off, w, h
    else:
        mipc = atlas.mip_count[t]
        w0i = atlas.width[t, 0]
        srgb_f = atlas.srgb[t]

        def mip_owh(m):
            ml = m.long()
            return atlas.offset[t, ml], atlas.width[t, ml], atlas.height[t, ml]

    max_mip = (mipc - 1).to(torch.float32)
    # the integrator's footprint is in 1024-reference texels; rebase to
    # this texture's actual resolution
    w0 = torch.clamp(w0i.to(torch.float32), min=1.0)
    lod = lod + torch.log2(w0) - 10.0
    lod = torch.minimum(torch.clamp(lod, min=0.0), max_mip)
    if trilinear:
        m0 = torch.floor(lod).to(torch.int32)
        m1 = torch.minimum(m0 + 1, mipc - 1)
        frac = (lod - m0.to(torch.float32))[..., None]
    else:
        m0 = torch.round(lod).to(torch.int32)

    def fetch_mip(m):
        off, w, h = mip_owh(m)
        # wrap repeat
        u = uv_u - torch.floor(uv_u)
        v = uv_v - torch.floor(uv_v)
        x = u * w.to(torch.float32) - 0.5
        y = v * h.to(torch.float32) - 0.5
        x0 = torch.floor(x).to(torch.int32)
        y0 = torch.floor(y).to(torch.int32)
        fx = (x - x0.to(torch.float32))[..., None]
        fy = (y - y0.to(torch.float32))[..., None]

        xi = torch.remainder(x0, w)
        yi = torch.remainder(y0, h)
        quad = atlas.texels[(off + yi * w + xi).long()]  # (R,4) — one gather
        c00 = _unpack_rgba(quad[..., 0])
        c10 = _unpack_rgba(quad[..., 1])
        c01 = _unpack_rgba(quad[..., 2])
        c11 = _unpack_rgba(quad[..., 3])
        return (
            (c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy
        )

    if trilinear:
        c = fetch_mip(m0) * (1 - frac) + fetch_mip(m1) * frac
    else:
        c = fetch_mip(m0)
    rgb = torch.where(
        srgb_f[..., None], _srgb_to_linear(c[..., :3]), c[..., :3]
    )
    c = torch.cat([rgb, c[..., 3:4]], dim=-1)
    return torch.where(valid[..., None], c, torch.ones_like(c))
