"""Low-discrepancy sampling: Owen-scrambled Sobol (0,2)-sequence.

Bit-exact counterpart of `rfw_tpu/render/sampler.py`. Every logical 2-D
sample slot (pixel jitter, lens, light pick, BSDF, ...) uses the first two
Sobol dimensions with an Owen scramble (Laine-Karras hash) seeded by
hash(pixel, slot).

torch has few uint32 operations, so the hashing runs on int64 tensors that
hold values in [0, 2**32): every multiply, add and shift is followed by a
mask to the low 32 bits. An int64 product of two 32-bit values may wrap,
but its low 32 bits are still those of the uint32 product.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_SCALE = 1.0 / 4294967296.0


def _u32(x) -> torch.Tensor:
    """Any integer tensor (or Python int) -> int64 holding its uint32 bits."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x)
    return x.to(torch.int64) & M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """Finalizer-style integer hash (xxhash/murmur-like avalanche)."""
    x = x & M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & M32
    x = x ^ (x >> 16)
    return x


def _reverse_bits(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def _laine_karras(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras hash: a random Owen permutation of the bit tree."""
    x = (x + seed) & M32
    x = x ^ ((x * 0x6C50B47C) & M32)
    x = x ^ ((x * 0xB82F1E52) & M32)
    x = x ^ ((x * 0xC7AFE638) & M32)
    x = x ^ ((x * 0x8D22F6E6) & M32)
    return x


def _owen_scramble(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return _reverse_bits(_laine_karras(_reverse_bits(x), seed))


def _sobol_dim1(index: torch.Tensor) -> torch.Tensor:
    """Second Sobol dimension via its generator matrix (the first is van der
    Corput = bit reversal)."""
    result = torch.zeros_like(index)
    v = 1 << 31
    for j in range(32):
        bit = (index >> j) & 1
        result = torch.where(bit == 1, result ^ v, result)
        v = v ^ (v >> 1)
    return result


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * _SCALE


def sobol2d(index: torch.Tensor, scramble_seed: torch.Tensor):
    """Owen-scrambled (0,2)-sequence point for `index` (uint32 values).

    index/scramble_seed broadcast; returns (u0, u1) float32 in [0,1]."""
    index = _u32(index)
    scramble_seed = _u32(scramble_seed)
    # scramble the index itself (decorrelates pixels without losing the
    # (0,2) stratification property), then the two outputs independently
    idx = _owen_scramble(index, _hash_u32(scramble_seed))
    d0 = _reverse_bits(idx)
    d1 = _sobol_dim1(idx)
    d0 = _owen_scramble(d0, _hash_u32(scramble_seed ^ 0x68BC21EB))
    d1 = _owen_scramble(d1, _hash_u32(scramble_seed ^ 0x02E5BE93))
    return _to_unit(d0), _to_unit(d1)


def sample_slot(
    sample_index,  # int, () or (R,) integer tensor — progressive spp index
    pixel_id: torch.Tensor,  # (R,) int32
    slot: int,  # logical dimension-pair id
    n: int = 2,  # 2 or 3 uniforms
) -> torch.Tensor:
    """(R, n) low-discrepancy uniforms for one use-site ("slot")."""
    pid = _u32(pixel_id)
    slot_u = ((int(slot) & M32) * 0x85EBCA6B) & M32
    seed = _hash_u32((pid * 0x9E3779B9 + slot_u) & M32)
    index = torch.broadcast_to(_u32(sample_index).to(pid.device), pid.shape)
    u0, u1 = sobol2d(index, seed)
    if n == 2:
        return torch.stack([u0, u1], dim=-1)
    # third uniform from a scrambled vdC of a re-hashed seed (padding dim)
    idx = _owen_scramble(index, _hash_u32(seed ^ 0x94D049BB))
    u2 = _to_unit(_reverse_bits(idx))
    return torch.stack([u0, u1, u2], dim=-1)
