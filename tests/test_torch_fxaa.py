"""The port's FXAA post-pass and `tonemap(fxaa=True)` against rfw_tpu's on
the same seeded inputs.

Tolerances: a flat image passes through within 1e-6 (as
tests/test_fxaa.py holds the reference); the staircase and a seeded random
image agree with the JAX pass to a max abs difference of 1e-5 (float32
rounding of the luma dot products and bilinear weights); tonemapped uint8
frames agree within 1 on at least 99.9% of pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu.render.film import tonemap as jtonemap
from rfw_tpu.render.fxaa import fxaa as jfxaa
from rfw_tpu_torch.render.film import tonemap
from rfw_tpu_torch.render.fxaa import fxaa


def _staircase(h=64, w=64):
    """The hard diagonal edge with 4-pixel stairsteps of tests/test_fxaa.py."""
    img = np.zeros((h, w, 3), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    img[(xs // 4) * 4 > ys * 1.0] = 1.0
    return img


def _random(h=48, w=40, seed=3):
    return np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)


def _both(img):
    ref = np.asarray(jfxaa(jnp.asarray(img)))
    got = fxaa(torch.from_numpy(img)).numpy()
    assert got.shape == img.shape and got.dtype == np.float32
    return ref, got


def test_flat_image_unchanged():
    flat = np.full((32, 32, 3), 0.4, np.float32)
    ref, got = _both(flat)
    np.testing.assert_allclose(got, flat, atol=1e-6)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("make", [_staircase, _random], ids=["staircase", "random"])
def test_fxaa_matches_jax(make):
    img = make()
    ref, got = _both(img)
    assert np.abs(got - ref).max() <= 1e-5
    # the pass changed something: edges were blended
    assert np.abs(got - img).max() > 0.05


def test_staircase_smoothed():
    img = _staircase()
    _, out = _both(img)
    hard_in = (np.abs(np.diff(img[..., 0], axis=1)) > 0.9).sum()
    hard_out = (np.abs(np.diff(out[..., 0], axis=1)) > 0.9).sum()
    assert hard_out < hard_in * 0.8, (hard_in, hard_out)


@pytest.mark.parametrize("mode", ["aces", "reinhard", "clamp"])
def test_tonemap_fxaa_matches_jax(mode):
    h, w, spp = 40, 56, 3
    rng = np.random.default_rng(11)
    accum = rng.gamma(0.6, 1.5, (h * w, 3)).astype(np.float32) * spp
    accum[: h * w // 2] += 6.0  # a hard edge in accumulated light
    ref = np.asarray(jtonemap(jnp.asarray(accum), jnp.float32(spp), w, h, mode=mode,
                              fxaa=True))
    got = tonemap(torch.from_numpy(accum), spp, w, h, mode=mode, fxaa=True).numpy()
    assert got.shape == (h, w, 4) and got.dtype == np.uint8
    assert (got[..., 3] == 255).all()
    diff = np.abs(ref.astype(np.int32) - got.astype(np.int32)).max(axis=-1)
    assert (diff <= 1).mean() >= 0.999
    plain = tonemap(torch.from_numpy(accum), spp, w, h, mode=mode).numpy()
    assert not np.array_equal(plain, got)
