"""Sobol sampler, Morton codes, pixel swizzle and prefix ladder: the port
against rfw_tpu. Tolerance: none — the integer hashing is bit-exact and so
are the float32 uniforms made from it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu.accel import lbvh as jlbvh
from rfw_tpu.render import sampler as jsampler
from rfw_tpu.render import wavefront as jwave
from rfw_tpu_torch.accel.lbvh import morton_codes_c
from rfw_tpu_torch.render import sampler
from rfw_tpu_torch.render import wavefront

INDICES = [0, 1, 7, 1023, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("sample_index", INDICES)
def test_sample_slot_bit_exact(n, sample_index):
    rng = np.random.default_rng(sample_index % 1000 + n)
    pid = rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    for slot in (0, 1, 2, 5, 3 + 7 * 3):
        ref = np.asarray(jsampler.sample_slot(jnp.uint32(sample_index), jnp.asarray(pid),
                                              slot, n))
        got = sampler.sample_slot(sample_index, torch.from_numpy(pid), slot, n).numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.array_equal(got, ref), (slot, np.abs(got - ref).max())


def test_sample_slot_per_lane_index():
    """A per-lane sample index (R,) hashes like the broadcast scalar."""
    rng = np.random.default_rng(2)
    pid = rng.integers(0, 1 << 20, 1000).astype(np.int32)
    idx = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jsampler.sample_slot(jnp.asarray(idx), jnp.asarray(pid), 4, 3))
    got = sampler.sample_slot(torch.from_numpy(idx.astype(np.int64)),
                              torch.from_numpy(pid), 4, 3).numpy()
    assert np.array_equal(got, ref)


def test_sobol2d_bit_exact():
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    seed = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    r0, r1 = jsampler.sobol2d(jnp.asarray(idx), jnp.asarray(seed))
    g0, g1 = sampler.sobol2d(torch.from_numpy(idx.astype(np.int64)),
                             torch.from_numpy(seed.astype(np.int64)))
    assert np.array_equal(g0.numpy(), np.asarray(r0))
    assert np.array_equal(g1.numpy(), np.asarray(r1))


def test_morton_codes_bit_exact():
    rng = np.random.default_rng(4)
    c = rng.uniform(-12, 12, (3, 4000)).astype(np.float32)
    mn = np.array([-10, -11, -9], np.float32)
    mx = np.array([10, 9, 11], np.float32)
    ref = np.asarray(jlbvh.morton_codes_c(tuple(jnp.asarray(x) for x in c),
                                          jnp.asarray(mn), jnp.asarray(mx)))
    got = morton_codes_c(tuple(torch.from_numpy(x) for x in c),
                         torch.from_numpy(mn), torch.from_numpy(mx)).numpy()
    assert np.array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("wh,lanes", [((32, 32), 256), ((64, 48), 1024),
                                      ((48, 40), 256), ((1920, 1080), 256)])
def test_block_swizzle(wh, lanes):
    ref = jwave._block_swizzle(*wh, lanes)
    got = wavefront._block_swizzle(*wh, lanes)
    if ref is None:
        assert got is None
        return
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("R,g,mb", [(1024, 256, 1), (36864, 256, 1), (2073600, 256, 1),
                                    (2073600, 256, 3), (65536, 1024, 4)])
def test_prefix_sizes(R, g, mb):
    assert wavefront._prefix_sizes(R, g, mb) == jwave._prefix_sizes(R, g, mb)
