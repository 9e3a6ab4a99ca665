"""FXAA post-pass (console/3.11-style) on the tonemapped frame: the torch
counterpart of `rfw_tpu/render/fxaa.py`.

Reference parity: backends/wgpu/shaders/deferred_fxaa.frag:1-73 — the
reference runs FXAA as a fullscreen pass on the LDR output. Here it is one
vectorized function over the whole frame (edge-clamped neighborhood taps +
a direction-driven pair of bilinear samples) in torch ops, on whatever
device the frame lies on.

Operates on sRGB-encoded float RGB in [0,1] (FXAA is defined on
perceptually-encoded data; running it pre-encode blurs shadows)."""

from __future__ import annotations

import torch

_LUMA = (0.299, 0.587, 0.114)

_EDGE_THRESHOLD = 1.0 / 8.0
_EDGE_THRESHOLD_MIN = 1.0 / 24.0
_DIR_REDUCE_MUL = 1.0 / 8.0
_DIR_REDUCE_MIN = 1.0 / 128.0
_SPAN_MAX = 8.0


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    return rgb @ torch.tensor(_LUMA, dtype=torch.float32, device=rgb.device)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped neighbor fetch: img[(y+dy, x+dx)] with border clamp."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def _bilinear(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (H,W,3) at fractional pixel offsets per pixel."""
    h, w = img.shape[0], img.shape[1]
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    ay = (fy - y0)[..., None]
    ax = (fx - x0)[..., None]
    y0 = torch.clamp(y0.to(torch.int32), 0, h - 1)
    x0 = torch.clamp(x0.to(torch.int32), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    flat = img.reshape(-1, img.shape[-1])

    def tap(y, x):
        return flat[(y * w + x).reshape(-1).long()].reshape(img.shape)

    return (tap(y0, x0) * (1 - ax) * (1 - ay) + tap(y0, x1) * ax * (1 - ay)
            + tap(y1, x0) * (1 - ax) * ay + tap(y1, x1) * ax * ay)


def fxaa(rgb: torch.Tensor) -> torch.Tensor:
    """(H,W,3) sRGB-encoded float frame -> antialiased frame, same shape."""
    h, w = rgb.shape[0], rgb.shape[1]
    luma = _luma(rgb)  # (H,W)

    l_m = luma
    l_nw = _shift(luma, -1, -1)
    l_ne = _shift(luma, -1, 1)
    l_sw = _shift(luma, 1, -1)
    l_se = _shift(luma, 1, 1)

    l_min = torch.minimum(l_m, torch.minimum(torch.minimum(l_nw, l_ne),
                                             torch.minimum(l_sw, l_se)))
    l_max = torch.maximum(l_m, torch.maximum(torch.maximum(l_nw, l_ne),
                                             torch.maximum(l_sw, l_se)))
    contrast = l_max - l_min
    skip = contrast < torch.clamp(l_max * _EDGE_THRESHOLD, min=_EDGE_THRESHOLD_MIN)

    # edge direction from the diagonal luma cross
    dir_x = -((l_nw + l_ne) - (l_sw + l_se))
    dir_y = (l_nw + l_sw) - (l_ne + l_se)
    dir_reduce = torch.clamp((l_nw + l_ne + l_sw + l_se) * 0.25 * _DIR_REDUCE_MUL,
                             min=_DIR_REDUCE_MIN)
    rcp = 1.0 / (torch.minimum(dir_x.abs(), dir_y.abs()) + dir_reduce)
    dir_x = torch.clamp(dir_x * rcp, -_SPAN_MAX, _SPAN_MAX)
    dir_y = torch.clamp(dir_y * rcp, -_SPAN_MAX, _SPAN_MAX)

    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=rgb.device),
                            torch.arange(w, dtype=torch.float32, device=rgb.device),
                            indexing="ij")

    a0 = _bilinear(rgb, gy + dir_y * (1.0 / 3.0 - 0.5), gx + dir_x * (1.0 / 3.0 - 0.5))
    a1 = _bilinear(rgb, gy + dir_y * (2.0 / 3.0 - 0.5), gx + dir_x * (2.0 / 3.0 - 0.5))
    rgb_a = 0.5 * (a0 + a1)
    b0 = _bilinear(rgb, gy - dir_y * 0.5, gx - dir_x * 0.5)
    b1 = _bilinear(rgb, gy + dir_y * 0.5, gx + dir_x * 0.5)
    rgb_b = rgb_a * 0.5 + 0.25 * (b0 + b1)

    l_b = _luma(rgb_b)
    use_a = (l_b < l_min) | (l_b > l_max)
    out = torch.where(use_a[..., None], rgb_a, rgb_b)
    return torch.where(skip[..., None], rgb, out)
