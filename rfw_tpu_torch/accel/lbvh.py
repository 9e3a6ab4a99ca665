"""On-device LBVH builder and Morton codes: counterpart of
`rfw_tpu/accel/lbvh.py`. The Morton codes key the bounce-ray sort and the
device TLAS build; `build_lbvh_device` builds a binary BVH from boxes with
no sequential step (Morton sort, Karras 2012 radix tree, node boxes by
range min/max queries), on the device of its inputs.

torch has few uint32 operations, so codes and key arithmetic are computed
in int64; every intermediate stays below 2**32 and the results equal the
uint32 ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (standard Morton magic)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(centroids: torch.Tensor, scene_min: torch.Tensor,
                 scene_max: torch.Tensor) -> torch.Tensor:
    """(n,3) centroids -> (n,) int64 30-bit Morton codes."""
    return morton_codes_c(
        (centroids[:, 0], centroids[:, 1], centroids[:, 2]),
        scene_min, scene_max)


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


class DeviceBvh(NamedTuple):
    """Device-side flat BVH (the schema of accel.bvh_cpu.BvhNodes)."""

    node_min: torch.Tensor  # (N,3) f32
    node_max: torch.Tensor  # (N,3) f32
    node_left: torch.Tensor  # (N,) i32
    node_right: torch.Tensor  # (N,) i32
    node_count: torch.Tensor  # (N,) i32
    prim_order: torch.Tensor  # (P,) i32


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Count of leading zeros of 32-bit values held in int64 (32 for 0)."""
    n = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for shift in (16, 8, 4, 2, 1):
        y = x >> shift
        big = y != 0
        n = torch.where(big, n, n + shift)
        x = torch.where(big, y, x)
    # here x is 0 or 1; an input of 0 leaves x == 0
    return torch.where(x == 0, 32, n)


def build_lbvh_device(aabb_min: torch.Tensor, aabb_max: torch.Tensor) -> DeviceBvh:
    """Build an LBVH from per-primitive AABBs on their device: Morton codes
    of the centroids, a stable sort (as `jnp.argsort`), the Karras binary
    radix tree (every internal node found independently from the common
    prefixes of adjacent keys, with fixed trip counts) and node boxes by a
    sparse table of range min/max. Counterpart of
    `rfw_tpu.accel.lbvh.build_lbvh_device`, bit for bit: internal nodes
    occupy [0, n-2], leaf j sits at (n-1) + j with node_left = j, and
    prim_order is the Morton sort permutation; duplicate codes are broken
    by sorted index.

    One departure: the sparse table has floor(log2 n) + 1 levels, so the
    root's range of n boxes finds its level when n is a power of two.
    `rfw_tpu` builds floor(log2(n - 1)) + 1 levels, and at a power of two
    its root box (the out-of-range level clamped to the last one) covers
    only the first half of the boxes; every other array, and the root box
    at any other n, is the same."""
    n = aabb_min.shape[0]
    dev = aabb_min.device
    i32, i64 = torch.int32, torch.int64
    if n == 0:
        z3 = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        zi = torch.zeros(1, dtype=i32, device=dev)
        return DeviceBvh(z3, z3.clone(), zi, zi.clone(), zi.clone(),
                         torch.zeros(0, dtype=i32, device=dev))
    if n == 1:
        return DeviceBvh(
            aabb_min[:1], aabb_max[:1],
            torch.zeros(1, dtype=i32, device=dev), torch.zeros(1, dtype=i32, device=dev),
            torch.ones(1, dtype=i32, device=dev), torch.zeros(1, dtype=i32, device=dev),
        )

    centroids = 0.5 * (aabb_min + aabb_max)
    codes = morton_codes(centroids, aabb_min.amin(dim=0), aabb_max.amax(dim=0))
    order = torch.sort(codes, stable=True).indices
    sorted_codes = codes[order]

    def delta(i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
        """Common-prefix length of keys (code, index) at i, j; -1 out of range."""
        valid = (j >= 0) & (j < n)
        jc = j.clamp(0, n - 1)
        ci, cj = sorted_codes[i], sorted_codes[jc]
        d = torch.where(ci == cj, 32 + _clz32(i ^ jc), _clz32(ci ^ cj))
        return torch.where(valid, d, -1)

    i = torch.arange(n - 1, dtype=i64, device=dev)

    # --- Karras: direction and the far end of each node's range
    d = torch.where(delta(i, i + 1) > delta(i, i - 1), 1, -1)
    delta_min = delta(i, i - d)

    # exponential upper bound for the range length: the first power of two
    # lmax >= 2 whose key lies outside the range (31 doublings cover n < 2^32)
    lmax = torch.full((n - 1,), 2, dtype=i64, device=dev)
    cont = delta(i, i + 2 * d) > delta_min
    for _ in range(31):
        lmax = torch.where(cont, lmax * 2, lmax)
        cont = cont & (delta(i, i + lmax * d) > delta_min)

    # binary search for the exact length
    ln = torch.zeros(n - 1, dtype=i64, device=dev)
    step = lmax
    for _ in range(33):
        step = torch.clamp(step // 2, min=1)
        ok = delta(i, i + (ln + step) * d) > delta_min
        ln = torch.where(ok, ln + step, ln)
    j = i + ln * d  # the other end of the range

    # --- split position
    delta_node = delta(i, j)
    s = torch.zeros(n - 1, dtype=i64, device=dev)
    step = ln
    for _ in range(33):
        step = (step + 1) // 2
        ok = delta(i, i + (s + step) * d) > delta_node
        s = torch.where((s + step < ln) & ok, s + step, s)
    gamma = i + s * d + torch.clamp(d, max=0)  # the left range ends at gamma

    left_range = torch.minimum(i, j)
    right_range = torch.maximum(i, j)
    leaf_base = n - 1
    node_left = torch.where(left_range == gamma, leaf_base + gamma, gamma)
    node_right = torch.where(right_range == gamma + 1, leaf_base + gamma + 1, gamma + 1)

    # --- boxes by a sparse table of range min/max
    leaf_min = aabb_min[order]
    leaf_max = aabb_max[order]
    levels = n.bit_length()
    tbl_min, tbl_max = [leaf_min], [leaf_max]
    for k in range(1, levels):
        half = 1 << (k - 1)
        pmin, pmax = tbl_min[-1], tbl_max[-1]
        # windowed combine; rows past the end repeat (harmless)
        tbl_min.append(torch.minimum(pmin, torch.cat([pmin[half:], pmin[-half:]])))
        tbl_max.append(torch.maximum(pmax, torch.cat([pmax[half:], pmax[-half:]])))
    tbl_min = torch.stack(tbl_min)  # (L, n, 3)
    tbl_max = torch.stack(tbl_max)

    length = right_range - left_range + 1
    k = torch.frexp(length.to(torch.float32)).exponent.to(i64) - 1  # floor(log2)
    second = right_range - (1 << k) + 1
    in_min = torch.minimum(tbl_min[k, left_range], tbl_min[k, second])
    in_max = torch.maximum(tbl_max[k, left_range], tbl_max[k, second])

    return DeviceBvh(
        torch.cat([in_min, leaf_min]),
        torch.cat([in_max, leaf_max]),
        torch.cat([node_left, torch.arange(n, dtype=i64, device=dev)]).to(i32),
        torch.cat([node_right, torch.zeros(n, dtype=i64, device=dev)]).to(i32),
        torch.cat([torch.zeros(n - 1, dtype=i32, device=dev),
                   torch.ones(n, dtype=i32, device=dev)]),
        order.to(i32),
    )
