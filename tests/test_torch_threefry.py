"""The port's threefry (`rfw_tpu_torch/render/threefry.py`) against
`jax.random` as installed (default threefry implementation,
`jax_threefry_partitionable=True`, 64-bit types off).

Tolerance: none — keys, split keys, folded keys, raw bits and float32
uniforms identical (dtype, shape, values) for the seeds 0, 42 and
2**32-1, fold_in data up to 2**32-1, and shapes (0,), (1, 2) and
(4097, 3).
"""

import jax
import numpy as np
import pytest
import torch

from rfw_tpu_torch.render import threefry as tf

SEEDS = [0, 42, 2**32 - 1]
SHAPES = [(0,), (1, 2), (4097, 3)]


def _same(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    if ref.dtype == np.uint32:  # the port keeps uint32 words in int64
        assert got.dtype == np.int64 and ((got >= 0) & (got < 2**32)).all()
        got = got.astype(np.uint32)
    assert ref.dtype == got.dtype and ref.shape == got.shape
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    jk, k = jax.random.PRNGKey(seed), tf.PRNGKey(seed)
    _same(jk, k)
    _same(jk, tf.key_from_numpy(np.asarray(jk)))
    for n in (2, 3, 1):
        _same(jax.random.split(jk, n), tf.split(k, n))
    for d in (0, 1, 7, 2**31 - 1, 2**31, 2**32 - 1):
        _same(jax.random.fold_in(jk, d), tf.fold_in(k, d))
    # keys chain: fold_in of a split key, split of a folded one
    _same(jax.random.fold_in(jax.random.split(jk)[1], 5), tf.fold_in(tf.split(k)[1], 5))
    _same(jax.random.split(jax.random.fold_in(jk, 9))[0], tf.split(tf.fold_in(k, 9))[0])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_uniform_and_bits(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 2**32 - 1)
    k = tf.fold_in(tf.PRNGKey(seed), 2**32 - 1)
    _same(jax.random.uniform(jk, shape), tf.uniform(k, shape))
    _same(jax.random.bits(jk, shape), tf.random_bits(k, shape))
    u = tf.uniform(k, shape)
    assert ((u >= 0) & (u < 1)).all()


def test_render_keys_match_the_backend_stream():
    """The keys TorchBackend.render derives (PRNGKey(42), fold_in by the
    sample count) and render_sample splits (camera, loop, fold_in per
    vertex and use) match TpuBackend's and the JAX render_sample's."""
    jk, k = jax.random.PRNGKey(42), tf.PRNGKey(42)
    for s in (0, 1, 1000):
        jks, ks = jax.random.fold_in(jk, s), tf.fold_in(k, s)
        (jc, jl), (c, lp) = jax.random.split(jks), tf.split(ks)
        _same(jc, c)
        for depth in (0, 3):
            for sub in (1, 2, 7):
                _same(jax.random.fold_in(jax.random.fold_in(jl, depth), sub),
                      tf.fold_in(tf.fold_in(lp, depth), sub))


def test_uniform_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 12 (d) makes this "
                    "check on the card")
    k = tf.fold_in(tf.PRNGKey(42), 3)
    got = tf.uniform(k, (4097, 3), device="cuda").cpu()
    assert torch.equal(got, tf.uniform(k, (4097, 3)))
