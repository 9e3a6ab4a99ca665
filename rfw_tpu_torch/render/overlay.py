"""2D overlay compositor (host copy of `rfw_tpu/render/overlay.py`).

Replaces the reference's 2D render pass (backends/wgpu/src/d2.rs:61-310:
alpha-blended instanced triangles with per-mesh texture, drawn after the 3D
output). Host-side vectorized rasterizer: overlays are small (font quads,
HUD), so a numpy barycentric fill over triangle bounding boxes beats
shipping a raster pipeline to the device.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from rfw_tpu_torch.backend.structs import InstancesView2D, MeshView2D, TextureView


def rasterize_2d(
    meshes: Sequence[Tuple[MeshView2D, InstancesView2D]],
    textures: Dict[int, TextureView],
    camera_matrix: np.ndarray,  # (4,4) pixel->NDC (reference Camera2D matrix)
    width: int,
    height: int,
) -> np.ndarray:
    """Rasterize 2D meshes into an RGBA float32 (H,W,4) overlay buffer."""
    out = np.zeros((height, width, 4), np.float32)
    for mesh, instances in meshes:
        if mesh.num_vertices == 0 or instances.count == 0:
            continue
        tex = textures.get(mesh.texture_id)
        tex_img = tex.mips[0].astype(np.float32) / 255.0 if tex is not None else None
        for mat in instances.matrices:
            m = camera_matrix @ mat
            # to clip space (w assumed 1 for 2D)
            p = mesh.positions @ m[:3, :3].T + m[:3, 3]
            # NDC -> pixels
            xs = (p[:, 0] * 0.5 + 0.5) * width
            ys = (1.0 - (p[:, 1] * 0.5 + 0.5)) * height
            pts = np.stack([xs, ys], axis=-1)
            tris = pts.reshape(-1, 3, 2)
            uvs = mesh.uvs.reshape(-1, 3, 2)
            cols = mesh.colors.reshape(-1, 3, 4)
            for t in range(tris.shape[0]):
                _fill_triangle(out, tris[t], uvs[t], cols[t], tex_img)
    return out


def _fill_triangle(out, tri, uv, col, tex_img) -> None:
    h, w = out.shape[:2]
    mnx = max(int(np.floor(tri[:, 0].min())), 0)
    mxx = min(int(np.ceil(tri[:, 0].max())) + 1, w)
    mny = max(int(np.floor(tri[:, 1].min())), 0)
    mxy = min(int(np.ceil(tri[:, 1].max())) + 1, h)
    if mnx >= mxx or mny >= mxy:
        return
    xs, ys = np.meshgrid(
        np.arange(mnx, mxx, dtype=np.float32) + 0.5,
        np.arange(mny, mxy, dtype=np.float32) + 0.5,
    )
    # barycentric
    x0, y0 = tri[0]
    x1, y1 = tri[1]
    x2, y2 = tri[2]
    det = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    if abs(det) < 1e-9:
        return
    l0 = ((y1 - y2) * (xs - x2) + (x2 - x1) * (ys - y2)) / det
    l1 = ((y2 - y0) * (xs - x2) + (x0 - x2) * (ys - y2)) / det
    l2 = 1.0 - l0 - l1
    inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
    if not inside.any():
        return
    rgba = (
        l0[..., None] * col[0] + l1[..., None] * col[1] + l2[..., None] * col[2]
    )
    if tex_img is not None:
        u = l0 * uv[0, 0] + l1 * uv[1, 0] + l2 * uv[2, 0]
        v = l0 * uv[0, 1] + l1 * uv[1, 1] + l2 * uv[2, 1]
        th, tw = tex_img.shape[:2]
        ti = np.clip((v * th).astype(np.int32), 0, th - 1)
        tj = np.clip((u * tw).astype(np.int32), 0, tw - 1)
        rgba = rgba * tex_img[ti, tj]
    # alpha over
    sub = out[mny:mxy, mnx:mxx]
    a = rgba[..., 3:4] * inside[..., None]
    sub[..., :3] = sub[..., :3] * (1 - a) + rgba[..., :3] * a
    sub[..., 3:4] = np.maximum(sub[..., 3:4], a)


def composite_overlay(frame: np.ndarray, overlay: np.ndarray) -> np.ndarray:
    """Alpha-composite overlay (H,W,4 f32) over frame (H,W,4 u8).

    The overlay buffer is PREMULTIPLIED: _fill_triangle accumulates
    rgb' = rgb_prev*(1-a) + rgb*a, so its rgb already carries the alpha —
    source-over here adds it straight (multiplying by a again dimmed
    every semi-transparent overlay by a^2; caught by the oracle's
    independent rasterizer in test_overlay_parity)."""
    f = frame.astype(np.float32) / 255.0
    a = overlay[..., 3:4]
    f[..., :3] = f[..., :3] * (1 - a) + overlay[..., :3]
    return (np.clip(f, 0, 1) * 255).astype(np.uint8)
