"""Threefry-2x32 random numbers with `jax.random`'s semantics, in torch.

The JAX package's default sampler (`RenderConfig.sampler="random"`) draws
its uniforms with `jax.random`: `PRNGKey`, `split`, `fold_in` and
`uniform(key, shape)` in float32, under JAX's default threefry
implementation with `jax_threefry_partitionable=True` (the default since
JAX 0.5) and 64-bit types off. The machine with the card has no JAX, so
this module carries those semantics itself, bit for bit:

  * a key is a (2,) int64 tensor holding the two uint32 words of JAX's raw
    key (`key_from_numpy` carries a JAX key across);
  * `PRNGKey(seed)` = (0, seed mod 2**32);
  * `threefry2x32` is the 20-round Threefry-2x32 hash (rotations
    13 15 26 6 / 17 29 16 24, key schedule with 0x1BD11BDA);
  * `split(key, n)` hashes the counter pairs (0, i), i < n: key i is the
    hash's two output words;
  * `fold_in(key, d)` hashes the single pair (0, d) and returns its words;
  * `uniform(key, shape)` hashes (hi, lo) of each element's flat index and
    takes the XOR of the two words; the top 23 bits become the mantissa of
    a float in [1, 2), minus 1.

The words are kept in int64 and masked to 32 bits after every add and
shift (torch's uint32 has few operators), so the CPU and the card compute
the same bits. The ops run eagerly, about a hundred elementwise launches a
call.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 of the counter words (x1, x2) (int64 tensors of
    uint32 values, broadcast together) under the key words (k1, k2)
    (ints). Returns the two output words as int64 tensors."""
    k1, k2 = int(k1) & _MASK, int(k2) & _MASK
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def _words(key):
    """The two uint32 words of a key (tensor, numpy array or pair)."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    a, b = (int(w) for w in np.asarray(key).reshape(2))
    return a & _MASK, b & _MASK


def key_from_numpy(key) -> torch.Tensor:
    """A JAX raw key (uint32[2], e.g. `np.asarray(jax.random.PRNGKey(s))`)
    as the port's key."""
    return torch.tensor(_words(key), dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with 64-bit types off: (0, seed mod 2**32)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def split(key, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: (num, 2) keys."""
    lo = torch.arange(num, dtype=torch.int64)
    b1, b2 = threefry2x32(*_words(key), torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=1)


def fold_in(key, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for a data word in [0, 2**32)."""
    d = torch.tensor([int(data) & _MASK], dtype=torch.int64)
    b1, b2 = threefry2x32(*_words(key), torch.zeros_like(d), d)
    return torch.cat([b1, b2])


def random_bits(key, shape, device=None) -> torch.Tensor:
    """`jax.random.bits(key, shape)` for 32-bit words: int64 tensor of
    uint32 values on `device` (the CPU by default)."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(*_words(key), idx >> 32, idx & _MASK)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key, shape, device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` (float32 in [0, 1)) on `device`."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return torch.clamp(bits.to(torch.int32).view(torch.float32) - 1.0, min=0.0)
