"""Morton codes for the bounce-ray sort key (the part of
`rfw_tpu/accel/lbvh.py` the renderer uses).

torch has few uint32 operations, so the codes are computed in int64; every
intermediate stays below 2**32 and the results equal the uint32 ones.
"""

from __future__ import annotations

import torch


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (standard Morton magic)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes_c(c, scene_min: torch.Tensor, scene_max: torch.Tensor) -> torch.Tensor:
    """Component-form Morton codes: c is an (x, y, z) tuple of (n,) float32
    tensors; returns (n,) int64 30-bit codes."""
    extent = torch.clamp(scene_max - scene_min, min=1e-9)
    q = [
        torch.clamp((c[j] - scene_min[j]) / extent[j] * 1024.0, 0.0, 1023.0
                    ).to(torch.int64)
        for j in range(3)
    ]
    return (_expand_bits(q[0]) << 2) | (_expand_bits(q[1]) << 1) | _expand_bits(q[2])
