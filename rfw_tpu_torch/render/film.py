"""Progressive film accumulation + tonemapping (counterpart of
`rfw_tpu/render/film.py`, without the FXAA post-pass).

The film is a device-resident (H*W,3) float32 accumulator; `add_sample`
adds one sample in place (the JAX version donates its buffer to the same
effect); `tonemap` produces uint8 RGBA.
"""

from __future__ import annotations

import torch


def new_film(width: int, height: int, device="cuda") -> torch.Tensor:
    """A zeroed (H*W,3) float32 accumulator on `device` (the card unless
    the caller names another)."""
    return torch.zeros((width * height, 3), dtype=torch.float32, device=device)


def add_sample(accum: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """accum += sample, in place; returns accum."""
    return accum.add_(sample)


def _aces(x: torch.Tensor) -> torch.Tensor:
    """ACES filmic approximation (Narkowicz)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tonemap(
    accum: torch.Tensor,
    spp,
    width: int,
    height: int,
    exposure: float = 1.0,
    mode: str = "aces",
) -> torch.Tensor:
    """(H*W,3) accumulator -> (H,W,4) uint8 sRGB frame."""
    c = accum / max(float(spp), 1.0) * exposure
    if mode == "aces":
        c = _aces(c)
    elif mode == "reinhard":
        c = c / (1.0 + c)
    else:  # clamp
        c = torch.clamp(c, 0.0, 1.0)
    # sRGB encode
    c = torch.where(c <= 0.0031308, 12.92 * c,
                    1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
    c = torch.clamp(c, 0.0, 1.0)
    rgb = (c * 255.0 + 0.5).to(torch.uint8).reshape(height, width, 3)
    alpha = torch.full((height, width, 1), 255, dtype=torch.uint8, device=accum.device)
    return torch.cat([rgb, alpha], dim=-1)
