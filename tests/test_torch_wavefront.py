"""The whole slice: the port's render_sample against rfw_tpu's on the same
packed arenas (packed by rfw_tpu, converted with rfw_tpu_torch.convert).

The JAX reference runs render_sample(traversal="packet", two_phase="off",
sampler="sobol") on the CPU; the port runs its plain traversal on the CPU.
The Sobol uniforms are bit-identical, so paths agree lane for lane up to
float32 rounding. Tolerances: at least 99% of pixels within atol 1e-3 +
rtol 1e-3 on every channel, mean radiance within 1e-3 relative; the
first-hit AOVs within 1e-4 (albedo, normal) and 1e-4 relative (depth,
position) on 99% of pixels; tonemapped uint8 frames within 1 on 99% of
pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch.convert import from_numpy_scene
from rfw_tpu_torch.render import film
from rfw_tpu_torch.render import wavefront as tw

W = H = 32
SAMPLE = 3


@pytest.fixture(scope="module")
def scene():
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        sc, mats, lights, atlas, camera = _torch_scene.build("rfw_tpu", seed=1)
    finally:
        mp.undo()
    return sc, mats, lights, atlas, camera


def _cfg_kwargs(mats, max_bounces, aovs=True):
    return dict(max_bounces=max_bounces, clamp=20.0, sky_intensity=0.35,
                sampler="sobol", two_phase="off", aovs=aovs,
                tex_mask=tw.tex_kinds_mask(mats.tex),
                mat_features=tw.mat_feature_mask(mats), has_area_lights=True)


def _jax_render(scene, kw, width=W, height=H):
    from rfw_tpu.render.atlas import atlas_to_device
    from rfw_tpu.render.lights_pack import DeviceLights
    from rfw_tpu.render.pack import TraceScene
    from rfw_tpu.render.wavefront import RenderConfig, render_sample

    sc, mats, lights, atlas, camera = scene
    view = camera.get_view(width, height).as_array()
    r = render_sample(
        TraceScene(*[jnp.asarray(x) for x in sc]), jax.device_put(mats),
        atlas_to_device(atlas), DeviceLights(*[jnp.asarray(x) for x in lights]),
        jnp.asarray(view), jax.random.PRNGKey(0), width, height,
        RenderConfig(traversal="packet", **kw), sample_index=jnp.uint32(SAMPLE))
    return {k: np.asarray(getattr(r, k)) for k in r._fields}


def _port_render(scene, kw, width=W, height=H, sample_index=SAMPLE, **extra):
    sc, mats, lights, atlas, camera = scene
    s, m, li, a = from_numpy_scene(sc, mats, lights, atlas, device="cpu")
    view = torch.from_numpy(camera.get_view(width, height).as_array())
    r = tw.render_sample(s, m, a, li, view, width, height,
                         tw.RenderConfig(**kw, **extra), sample_index=sample_index)
    return {k: getattr(r, k).numpy() for k in r._fields}


@pytest.fixture(scope="module", params=[1, 2], ids=lambda b: f"bounces{b}")
def renders(request, scene):
    kw = _cfg_kwargs(scene[1], request.param)
    return _jax_render(scene, kw), _port_render(scene, kw)


def _frac_close(a, b, atol, rtol):
    ok = np.abs(a - b) <= atol + rtol * np.abs(b)
    return ok.reshape(ok.shape[0], -1).all(axis=1).mean()


def test_radiance_matches_jax(renders):
    ref, got = renders
    assert got["radiance"].shape == (W * H, 3)
    assert np.isfinite(got["radiance"]).all()
    assert _frac_close(got["radiance"], ref["radiance"], 1e-3, 1e-3) >= 0.99
    m_ref, m_got = ref["radiance"].mean(), got["radiance"].mean()
    assert m_ref > 0
    assert abs(m_got - m_ref) <= 1e-3 * m_ref


@pytest.mark.parametrize("aov,atol,rtol", [("albedo", 1e-4, 0.0), ("normal", 1e-4, 0.0),
                                           ("depth", 0.0, 1e-4), ("position", 1e-4, 1e-4),
                                           ("ao", 0.0, 0.0)])
def test_aovs_match_jax(renders, aov, atol, rtol):
    ref, got = renders
    assert _frac_close(got[aov], ref[aov], atol, rtol) >= 0.99


def test_tonemap_matches_jax(renders):
    from rfw_tpu.render.film import tonemap as jtonemap

    ref, got = renders
    a = np.asarray(jtonemap(jnp.asarray(ref["radiance"] * 4), jnp.float32(4), W, H))
    b = film.tonemap(torch.from_numpy(got["radiance"] * 4), 4, W, H).numpy()
    assert b.shape == (H, W, 4) and b.dtype == np.uint8
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(axis=-1)
    assert (diff <= 1).mean() >= 0.99


def test_film_accumulates_in_place():
    acc = film.new_film(4, 2, device="cpu")
    s = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    out = film.add_sample(acc, s)
    out = film.add_sample(acc, s)
    assert out is acc and torch.equal(acc, 2 * s)


def test_compaction_and_sort_do_not_change_pixels(scene):
    """At 128x128 the bounce vertex runs on a compacted live prefix (the
    host-read live count picks the length); with compaction off, and with
    the bounce sort off too, every pixel must come out the same (per-lane
    math is identical, lanes differ only in order)."""
    kw = _cfg_kwargs(scene[1], 1, aovs=False)
    assert len(tw._prefix_sizes(128 * 128, 256)) > 1
    base = _port_render(scene, kw, 128, 128, sample_index=1)["radiance"]
    for extra in (dict(compaction="off"), dict(compaction="off", sort_secondary=False)):
        other = _port_render(scene, kw, 128, 128, sample_index=1, **extra)["radiance"]
        np.testing.assert_allclose(other, base, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad,exc", [(dict(sampler="random"), NotImplementedError),
                                     (dict(two_phase="maybe"), ValueError),
                                     (dict(traversal="pallas"), ValueError)])
def test_unported_options_raise(scene, bad, exc):
    kw = {**_cfg_kwargs(scene[1], 1), **bad}
    with pytest.raises(exc):
        _port_render(scene, kw)


@pytest.mark.parametrize("two_phase,tp_shadow", [("auto", "0"), ("on", "0"), ("on", "1")],
                         ids=["auto", "on", "on-tp_shadow"])
def test_two_phase_render_matches_jax(renders, scene, request, monkeypatch, two_phase,
                                      tp_shadow):
    """The two-phase path (its plain versions on the CPU) renders what
    rfw_tpu's classic render does, at the radiance tolerances above, with
    bounce shadows classic or two-phase (RFW_TP_SHADOW); and the same
    pixels as the port's own two_phase="off" render to float32 rounding.
    The two-phase contract is exact, so the classic render is its
    reference (rfw_tpu cannot run its two-phase kernels inside
    render_sample on a CPU)."""
    from rfw_tpu_torch.ops import traverse_items as ti

    ref, off = renders
    kw = {**_cfg_kwargs(scene[1], request.node.callspec.params["renders"]),
          "two_phase": two_phase}
    calls = []
    orig = ti.twophase_closest_fused

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(ti, "twophase_closest_fused", counted)
    monkeypatch.setenv("RFW_TP_SHADOW", tp_shadow)
    got = _port_render(scene, kw)
    assert calls  # the bounce vertices went through the two-phase path
    assert np.isfinite(got["radiance"]).all()
    assert _frac_close(got["radiance"], ref["radiance"], 1e-3, 1e-3) >= 0.99
    m_ref, m_got = ref["radiance"].mean(), got["radiance"].mean()
    assert abs(m_got - m_ref) <= 1e-3 * m_ref
    np.testing.assert_allclose(got["radiance"], off["radiance"], rtol=1e-5, atol=1e-6)


def _light_table_lights(n_point):
    """Packed lights: n_point seeded point lights, a sun and three seeded
    area lights."""
    from rfw_tpu_torch.backend.lights import (
        AreaLightsView, DirectionalLightsView, PointLightsView, SpotLightsView,
    )
    from rfw_tpu_torch.render.lights_pack import pack_lights

    rng = np.random.default_rng(n_point)
    point = PointLightsView(position=rng.uniform(-4, 4, (n_point, 3)).astype(np.float32),
                            energy=rng.uniform(1, 20, (n_point, 3)).astype(np.float32),
                            changed=np.ones(n_point, bool))
    v = rng.uniform(-2, 2, (3, 3, 3)).astype(np.float32)
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    cr = np.cross(e1, e2)
    ar = 0.5 * np.linalg.norm(cr, axis=-1)
    area = AreaLightsView(
        position=v.mean(1), normal=cr / np.linalg.norm(cr, axis=-1, keepdims=True),
        energy=np.ones((3, 3), np.float32), radiance=np.full((3, 3), 4.0, np.float32),
        area=ar.astype(np.float32), v0=v[:, 0], v1=v[:, 1], v2=v[:, 2],
        inst_id=np.zeros(3, np.int32), mesh_id=np.zeros(3, np.int32),
        tri_id=np.arange(3, dtype=np.int32), changed=np.ones(3, bool))
    return pack_lights(point, SpotLightsView.empty(), DirectionalLightsView(
        direction=np.array([[0.3, -0.9, 0.3]], np.float32),
        energy=np.array([[1.0, 1.0, 1.0]], np.float32), changed=np.ones(1, bool)), area)


@pytest.mark.parametrize("n_point", [2, 20], ids=["potential_pick", "power_cdf_pick"])
def test_sample_light_matches_jax(n_point):
    """NEE light pick and sample: the per-point potential pick (<= 16 table
    rows) and the global power CDF (more rows). rtol 1e-5, atol 1e-6 on
    directions, distances and pdfs; radiance/pdf at rtol 1e-4 (it divides
    by the squared distance)."""
    from rfw_tpu.render import wavefront as jw
    from rfw_tpu.render.lights_pack import DeviceLights as JL

    lights = _light_table_lights(n_point)
    rng = np.random.default_rng(5)
    n = 2048
    p = rng.uniform(-3, 3, (3, n)).astype(np.float32)
    ns = rng.normal(size=(3, n)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=0, keepdims=True)
    u = rng.random((3, n)).astype(np.float32)
    jl = JL(*[jnp.asarray(x) for x in lights])
    tl = type(lights)(*[torch.from_numpy(np.asarray(x)) for x in lights])
    ref = jw._sample_light_c(jl, tuple(map(jnp.asarray, p)), *map(jnp.asarray, u),
                             tuple(map(jnp.asarray, ns)))
    got = tw._sample_light_c(tl, tuple(map(torch.from_numpy, p)), *map(torch.from_numpy, u),
                             tuple(map(torch.from_numpy, ns)))
    names = ("wi", "dist", "rad_over_pdf", "is_delta", "pdf_sa", "pick_norm")
    for name, r, g in zip(names, ref, got):
        r = np.stack([np.asarray(x) for x in r]) if isinstance(r, tuple) else np.asarray(r)
        g = np.stack([x.numpy() for x in g]) if isinstance(g, tuple) else g.numpy()
        if name == "is_delta":
            assert np.array_equal(g, r)
            continue
        rtol = 1e-4 if name == "rad_over_pdf" else 1e-5
        np.testing.assert_allclose(g, r, rtol=rtol, atol=1e-6, err_msg=name)


def test_entry_points_default_to_cuda(scene):
    """new_film and from_numpy_scene put their tensors on the card unless
    the caller names a device: on a machine without one they raise rather
    than fall back to the CPU."""
    from rfw_tpu_torch.convert import from_numpy_scene as convert

    if torch.cuda.is_available():
        assert film.new_film(4, 2).device.type == "cuda"
        assert convert(*scene[:4])[0].tri_v0.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        film.new_film(4, 2)
    with pytest.raises((RuntimeError, AssertionError)):
        convert(*scene[:4])
