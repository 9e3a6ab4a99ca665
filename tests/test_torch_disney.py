"""Disney BSDF: the port's eval/pdf/sample against rfw_tpu's, on the same
seeded parameters, directions and uniforms, for every feature mask.
Tolerance: rtol 1e-5, atol 1e-6 (float32; the two evaluate the same
formulas in the same order, with transcendental functions from different
libraries).

On CPU tensors the public functions are their plain versions, bit for bit,
and launch nothing. On the card they launch csrc/disney.cu's two kernels,
which give the plain versions' bits (`test_kernels_match_plain_on_card`,
skipped without a card). Where the card is, run it without this
directory's conftest, which imports JAX (this module imports JAX only in
the fixture of the tests that compare with rfw_tpu):
`python -m pytest --noconftest tests/test_torch_disney.py -k on_card`.
"""

import numpy as np
import pytest
import torch

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


def make_inputs(n=N, seed=11):
    rng = np.random.default_rng(seed)
    f = lambda lo=0.0, hi=1.0: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    params = dict(
        base=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        metallic=np.where(rng.random(n) < 0.3, 1.0, f()).astype(np.float32),
        roughness=f(0.02, 1.0), specular_f=f(), specular_tint=f(), sheen=f(),
        sheen_tint=f(), clearcoat=f(), clearcoat_gloss=f(), subsurface=f(),
        anisotropic=f(), transmission=np.where(rng.random(n) < 0.5, f(), 0.0).astype(np.float32),
        eta_rel=np.where(rng.random(n) < 0.5, 1 / 1.5, 1.5).astype(np.float32),
    )
    wo = _unit(rng, n)
    wi = _unit(rng, n, upper=False)  # some below the horizon
    u = rng.random((n, 3)).astype(np.float32)
    return params, wo, wi, u


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, rfw_tpu's disney module)."""
    import jax.numpy as jnp
    from rfw_tpu.render import disney as jd
    return jnp, jd


def _mat(mod, params, conv, tuple_base):
    base = params["base"]
    bc = tuple(conv(base[:, j]) for j in range(3)) if tuple_base else conv(base)
    return mod.MatParams(
        base_color=bc, **{k: conv(v) for k, v in params.items() if k != "base"})


def _jax(params):
    import jax.numpy as jnp
    from rfw_tpu.render import disney as jd
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
def test_eval(inputs, jx, features):
    jnp, jd = jx
    params, wo, wi, _ = inputs
    ref = jd.disney_eval_c(_jax(params), _c(wo, jnp.asarray), _c(wi, jnp.asarray), features)
    got = td.disney_eval_c(_torch(params), _c(wo, torch.from_numpy),
                           _c(wi, torch.from_numpy), features)
    _close(got, ref)


@pytest.mark.parametrize("features", MASKS)
def test_pdf(inputs, jx, features):
    jnp, jd = jx
    params, wo, wi, _ = inputs
    ref = jd.disney_pdf_c(_jax(params), _c(wo, jnp.asarray), _c(wi, jnp.asarray), features)
    got = td.disney_pdf_c(_torch(params), _c(wo, torch.from_numpy),
                          _c(wi, torch.from_numpy), features)
    _close(got, ref)


@pytest.mark.parametrize("features", MASKS)
def test_sample(inputs, jx, features):
    """The sampled direction and lobe match rfw_tpu's. A reflective
    sample's f and pdf are eval/pdf at that direction (held against rfw_tpu
    by test_eval/test_pdf), but there they sit on the lobe's peak, where one
    ulp of wi moves them by up to ~1e-2 relative: they are held to the
    port's own eval/pdf exactly, while the delta (transmission) lanes' f and
    pdf are held to rfw_tpu at RTOL/ATOL, and so is, at rtol 2e-4, the path
    weight f*|cos|/pdf that the integrator applies, whose peak factors
    cancel."""
    jnp, jd = jx
    params, wo, _, u = inputs
    uj = [jnp.asarray(np.ascontiguousarray(u[:, k])) for k in range(3)]
    ut = [torch.from_numpy(np.ascontiguousarray(u[:, k])) for k in range(3)]
    p_t, wo_t = _torch(params), _c(wo, torch.from_numpy)
    rwi, rf, rpdf, rdelta = jd.disney_sample_c(_jax(params), _c(wo, jnp.asarray), *uj,
                                               features)
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


def test_tangent_frame_and_transforms(inputs, jx):
    jnp, jd = jx
    _, wo, wi, _ = inputs
    n_j, n_t = _c(wo, jnp.asarray), _c(wo, torch.from_numpy)
    tj, bj = jd.build_tangent_frame_c(n_j)
    tt, bt = td.build_tangent_frame_c(n_t)
    _close(tt, tj)
    _close(bt, bj)
    v_j, v_t = _c(wi, jnp.asarray), _c(wi, torch.from_numpy)
    _close(td.to_local_c(tt, bt, n_t, v_t), jd.to_local_c(tj, bj, n_j, v_j))
    _close(td.to_world_c(tt, bt, n_t, v_t), jd.to_world_c(tj, bj, n_j, v_j))


# ----------------------------------------------- the kernels and their plain path
ALL_MASKS = range(td.FEAT_ALL + 1)
CARD_LANES = 4096
CARD_PREFIXES = (0, 1, 31, 4097)
#: MatParams fields in the columns of one gathered block, as
#: wavefront._fetch_material_c's material row hands them out
_COLS = ("metallic", "roughness", "specular_f", "specular_tint", "sheen", "sheen_tint",
         "clearcoat", "clearcoat_gloss", "subsurface", "anisotropic", "transmission",
         "eta_rel")


def _edge_lanes(params, wo, wi, u):
    """Overwrite the first lanes, in place, with the edges of each lobe: wo.z
    at and around the 1e-6 horizon, wi.z at it, roughness 0, metallic 1, full
    transmission under total internal reflection, refracting and at eta_rel
    1, wi = -wo, the sharpest clearcoat, full subsurface, a black base and
    the uniforms' ends. Returns the number of lanes set."""
    grazing = np.float32([0.995, 0.0, 0.0998])
    edges = [
        dict(wo=[0.8, 0.6, 0.0]),
        dict(wo=[0.6, 0.8, 1e-7]),
        dict(wo=[0.6, 0.8, np.float32(1e-6)]),
        dict(wo=[0.6, 0.8, 2e-6]),
        dict(wi=[0.6, 0.8, np.float32(1e-6)]),
        dict(roughness=0.0),
        dict(roughness=0.0, metallic=1.0),
        dict(metallic=1.0),
        dict(transmission=1.0, metallic=0.0, eta_rel=1.5, roughness=0.0, wo=grazing),
        dict(transmission=1.0, metallic=0.0, eta_rel=1.5, wo=grazing),
        dict(transmission=1.0, metallic=0.0, eta_rel=1 / 1.5),
        dict(transmission=1.0, metallic=0.0, eta_rel=1.0),
        dict(wi="-wo"),
        dict(clearcoat=1.0, clearcoat_gloss=1.0),
        dict(clearcoat=1.0, clearcoat_gloss=0.0, roughness=1.0),
        dict(subsurface=1.0),
        dict(base=[0.0, 0.0, 0.0]),
        dict(u=[0.0, 0.0, 0.0]),
        dict(u=[1 - 2**-24] * 3),
    ]
    for i, e in enumerate(edges):
        for k, v in e.items():
            if k == "wo":
                wo[i] = v
            elif k == "wi":
                wi[i] = -wo[i] if v == "-wo" else v
            elif k == "u":
                u[i] = v
            else:
                params[k][i] = v
    return len(edges)


def strided_inputs(n, device, seed=5):
    """n lanes of random materials, directions and uniforms, the edge lanes
    first, laid out as the main path hands them over: each material plane
    a strided column view of one gathered (n, 16) block, wo, wi and the
    uniforms columns of (n, 3) tensors."""
    params, wo, wi, u = make_inputs(n, seed)
    _edge_lanes(params, wo, wi, u)
    blk = np.zeros((n, 16), np.float32)
    blk[:, :3] = params["base"]
    for j, k in enumerate(_COLS):
        blk[:, 4 + j] = params[k]
    blk = torch.from_numpy(blk).to(device)
    p = td.MatParams(base_color=(blk[:, 0], blk[:, 1], blk[:, 2]),
                     **{k: blk[:, 4 + j] for j, k in enumerate(_COLS)})
    wo_t, wi_t, u_t = (torch.from_numpy(a).to(device) for a in (wo, wi, u))
    return p, td.v3_split(wo_t), td.v3_split(wi_t), td.v3_split(u_t)


def _prefix(x, m):
    """The first m lanes of a plane, a Vec3C or MatParams: views, strides kept."""
    if isinstance(x, torch.Tensor):
        return x[:m]
    parts = [_prefix(v, m) for v in x]
    return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)


def _bits_equal(got, ref, what):
    """Bit for bit; on a difference, the lanes that differ and the largest
    distance in ulps."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    if ref.dtype == torch.bool:
        assert torch.equal(got, ref), what
        return
    g, r = got.view(torch.int32), ref.view(torch.int32)
    if torch.equal(g, r):
        return
    diff = (g.to(torch.int64) - r.to(torch.int64)).abs()
    bad = torch.nonzero(diff).flatten()
    raise AssertionError(f"{what}: {bad.numel()} of {g.numel()} lanes differ, at most "
                         f"{int(diff.max())} ulps; lanes {bad[:8].tolist()}: "
                         f"{got[bad[:8]].tolist()} against {ref[bad[:8]].tolist()}")


def _check_against_plain(p, wo, wi, u, mask, launches_each):
    """The public functions against the plain versions on the same tensors,
    bit for bit; each call adds `launches_each` to disney.LAUNCHES."""
    ref_f = td.disney_eval_plain_c(p, wo, wi, mask)
    ref_pdf = td.disney_pdf_plain_c(p, wo, wi, mask)
    ref_s = td.disney_sample_plain_c(p, wo, *u, mask)

    def counted(fn):
        before = td.LAUNCHES
        out = fn()
        assert td.LAUNCHES == before + launches_each, (mask, td.LAUNCHES - before)
        return out

    for with_pdf in (True, False):
        f, pdf = counted(lambda: td.disney_eval_pdf_c(p, wo, wi, mask, with_pdf))
        for j in range(3):
            _bits_equal(f[j], ref_f[j], f"eval_pdf f[{j}], mask {mask}")
        if with_pdf:
            _bits_equal(pdf, ref_pdf, f"eval_pdf pdf, mask {mask}")
        else:
            assert pdf is None
    f = counted(lambda: td.disney_eval_c(p, wo, wi, mask))
    for j in range(3):
        _bits_equal(f[j], ref_f[j], f"eval f[{j}], mask {mask}")
    _bits_equal(counted(lambda: td.disney_pdf_c(p, wo, wi, mask)), ref_pdf,
                f"pdf, mask {mask}")
    wi_s, f_s, pdf_s, delta = counted(lambda: td.disney_sample_c(p, wo, *u, mask))
    for j in range(3):
        _bits_equal(wi_s[j], ref_s[0][j], f"sample wi[{j}], mask {mask}")
        _bits_equal(f_s[j], ref_s[1][j], f"sample f[{j}], mask {mask}")
    _bits_equal(pdf_s, ref_s[2], f"sample pdf, mask {mask}")
    _bits_equal(delta, ref_s[3], f"sample is_delta, mask {mask}")


@pytest.mark.parametrize("mask", ALL_MASKS)
def test_cpu_tensors_take_the_plain_path(mask):
    """CPU tensors: the plain versions' bits, strided views and all, and no
    launch, on prefixes of 0, 1, 31 and 64 lanes; disney_eval_pdf_c is
    (eval, pdf), or (eval, None) without the pdf."""
    full = strided_inputs(64, "cpu")
    for m in (0, 1, 31, 64):
        _check_against_plain(*_prefix(full, m), mask, 0)


def test_kernels_match_plain_on_card():
    """Both kernels against the plain versions on the card, for every
    feature mask, on prefixes of 0, 1, 31 and 4,097 lanes and on all of
    them (the edge lanes first): bit for bit, one launch a call (none for
    an empty prefix)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode; run "
                    "`python -m pytest --noconftest tests/test_torch_disney.py -k on_card` "
                    "on the card")
    full = strided_inputs(CARD_LANES + 32, "cuda")
    for mask in ALL_MASKS:
        for m in (*CARD_PREFIXES, CARD_LANES + 32):
            _check_against_plain(*_prefix(full, m), mask, int(m > 0))
