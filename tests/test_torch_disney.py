"""Disney BSDF: the port's eval/pdf/sample against rfw_tpu's, on the same
seeded parameters, directions and uniforms, for every feature mask.
Tolerance: rtol 1e-5, atol 1e-6 (float32; the two evaluate the same
formulas in the same order, with transcendental functions from different
libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu.render import disney as jd
from rfw_tpu_torch.render import disney as td

N = 4096
RTOL, ATOL = 1e-5, 1e-6
MASKS = [0, td.FEAT_TRANSMISSION, td.FEAT_CLEARCOAT, td.FEAT_SUBSURFACE,
         td.FEAT_SHEEN, td.FEAT_ALL]


def _unit(rng, n, upper=True):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    if upper:
        v[:, 2] = np.abs(v[:, 2]) + 0.05
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def make_inputs():
    rng = np.random.default_rng(11)
    f = lambda lo=0.0, hi=1.0: rng.uniform(lo, hi, N).astype(np.float32)  # noqa: E731
    params = dict(
        base=rng.uniform(0, 1, (N, 3)).astype(np.float32),
        metallic=np.where(rng.random(N) < 0.3, 1.0, f()).astype(np.float32),
        roughness=f(0.02, 1.0), specular_f=f(), specular_tint=f(), sheen=f(),
        sheen_tint=f(), clearcoat=f(), clearcoat_gloss=f(), subsurface=f(),
        anisotropic=f(), transmission=np.where(rng.random(N) < 0.5, f(), 0.0).astype(np.float32),
        eta_rel=np.where(rng.random(N) < 0.5, 1 / 1.5, 1.5).astype(np.float32),
    )
    wo = _unit(rng, N)
    wi = _unit(rng, N, upper=False)  # some below the horizon
    u = rng.random((N, 3)).astype(np.float32)
    return params, wo, wi, u


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


def _mat(mod, params, conv, tuple_base):
    base = params["base"]
    bc = tuple(conv(base[:, j]) for j in range(3)) if tuple_base else conv(base)
    return mod.MatParams(
        base_color=bc, **{k: conv(v) for k, v in params.items() if k != "base"})


def _jax(params):
    return _mat(jd, params, jnp.asarray, tuple_base=True)


def _torch(params):
    return _mat(td, params, torch.from_numpy, tuple_base=True)


def _c(a, conv):
    return tuple(conv(np.ascontiguousarray(a[:, j])) for j in range(3))


def _close(got, ref):
    got = np.stack([g.numpy() for g in got], -1) if isinstance(got, tuple) else got.numpy()
    ref = np.stack([np.asarray(r) for r in ref], -1) if isinstance(ref, tuple) else np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("features", MASKS)
def test_eval(inputs, features):
    params, wo, wi, _ = inputs
    ref = jd.disney_eval_c(_jax(params), _c(wo, jnp.asarray), _c(wi, jnp.asarray), features)
    got = td.disney_eval_c(_torch(params), _c(wo, torch.from_numpy),
                           _c(wi, torch.from_numpy), features)
    _close(got, ref)


@pytest.mark.parametrize("features", MASKS)
def test_pdf(inputs, features):
    params, wo, wi, _ = inputs
    ref = jd.disney_pdf_c(_jax(params), _c(wo, jnp.asarray), _c(wi, jnp.asarray), features)
    got = td.disney_pdf_c(_torch(params), _c(wo, torch.from_numpy),
                          _c(wi, torch.from_numpy), features)
    _close(got, ref)


@pytest.mark.parametrize("features", MASKS)
def test_sample(inputs, features):
    """The sampled direction and lobe match rfw_tpu's. A reflective
    sample's f and pdf are eval/pdf at that direction (held against rfw_tpu
    by test_eval/test_pdf), but there they sit on the lobe's peak, where one
    ulp of wi moves them by up to ~1e-2 relative: they are held to the
    port's own eval/pdf exactly, while the delta (transmission) lanes' f and
    pdf are held to rfw_tpu at RTOL/ATOL, and so is, at rtol 2e-4, the path
    weight f*|cos|/pdf that the integrator applies, whose peak factors
    cancel."""
    params, wo, _, u = inputs
    uj = [jnp.asarray(np.ascontiguousarray(u[:, k])) for k in range(3)]
    ut = [torch.from_numpy(np.ascontiguousarray(u[:, k])) for k in range(3)]
    p_t, wo_t = _torch(params), _c(wo, torch.from_numpy)
    rwi, rf, rpdf, rdelta = jd.disney_sample_c(_jax(params), _c(wo, jnp.asarray), *uj, features)
    gwi, gf, gpdf, gdelta = td.disney_sample_c(p_t, wo_t, *ut, features)
    delta = gdelta.numpy()
    assert np.array_equal(delta, np.asarray(rdelta))
    got_wi = np.stack([g.numpy() for g in gwi], -1)
    ref_wi = np.stack([np.asarray(r) for r in rwi], -1)
    np.testing.assert_allclose(got_wi, ref_wi, rtol=RTOL, atol=1e-5)  # unit vectors

    got_f = np.stack([g.numpy() for g in gf], -1)
    ref_f = np.stack([np.asarray(r) for r in rf], -1)
    got_pdf, ref_pdf = gpdf.numpy(), np.asarray(rpdf)
    own_f = np.stack([g.numpy() for g in td.disney_eval_c(p_t, wo_t, gwi, features)], -1)
    own_pdf = td.disney_pdf_c(p_t, wo_t, gwi, features).numpy()
    assert np.array_equal(got_f[~delta], own_f[~delta])
    assert np.array_equal(got_pdf[~delta], own_pdf[~delta])
    np.testing.assert_allclose(got_f[delta], ref_f[delta], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_pdf[delta], ref_pdf[delta], rtol=RTOL, atol=ATOL)

    def weight(f, wi, pdf):
        return f * np.abs(wi[:, 2:3]) / np.maximum(pdf, 1e-9)[:, None]

    np.testing.assert_allclose(weight(got_f, got_wi, got_pdf),
                               weight(ref_f, ref_wi, ref_pdf), rtol=2e-4, atol=ATOL)


def test_tangent_frame_and_transforms(inputs):
    _, wo, wi, _ = inputs
    n_j, n_t = _c(wo, jnp.asarray), _c(wo, torch.from_numpy)
    tj, bj = jd.build_tangent_frame_c(n_j)
    tt, bt = td.build_tangent_frame_c(n_t)
    _close(tt, tj)
    _close(bt, bj)
    v_j, v_t = _c(wi, jnp.asarray), _c(wi, torch.from_numpy)
    _close(td.to_local_c(tt, bt, n_t, v_t), jd.to_local_c(tj, bj, n_j, v_j))
    _close(td.to_world_c(tt, bt, n_t, v_t), jd.to_world_c(tj, bj, n_j, v_j))
