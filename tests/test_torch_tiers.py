"""The traversal tiers of `RenderConfig.traversal` against rfw_tpu's tiers of
the same name, on the CPU.

  * `render_sample` under "lockstep" and "packet", with the Sobol and the
    random sampler, against rfw_tpu's same tier; "pallas" (the kernel tier,
    its plain walks on the CPU) against rfw_tpu's "packet" at lanes=1024,
    the lane order of rfw_tpu's Pallas tiers, and against rfw_tpu's
    "pallas" at an R no multiple of 1,024, which rfw_tpu traces with its
    packet tier. Tolerances are
    `tests/test_torch_wavefront.py`'s: at least 99% of pixels within
    1e-3 + 1e-3·|ref| on every channel, mean radiance within 1e-3
    relative. Under the random sampler the lane order decides which pixel
    draws which numbers, so these cases also hold each tier's ray order
    (swizzle, sort, compaction) to rfw_tpu's;
  * the tiers' traversal calls (`bvh_closest_hit` / `bvh_occluded`,
    `packet_closest_hit` / `packet_occluded`) on seeded rays against
    rfw_tpu's: occlusion flags and t exact, prim, inst, u, v equal where
    the closest t is unique (no other hit within 1e-6 relative; the
    brute-force oracle finds the second hit);
  * `resolve_traversal`: which tier, tile width and two-phase permission
    each name gives; the Pallas names stay on the kernels at any R.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch.convert import from_numpy_scene
from rfw_tpu_torch.render import intersect as ti
from rfw_tpu_torch.render import packet as tp
from rfw_tpu_torch.render import threefry
from rfw_tpu_torch.render import wavefront as tw

W = H = 32
SAMPLE = 3
R = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with _torch_scene.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def scene():
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        return _torch_scene.build("rfw_tpu", seed=1)
    finally:
        mp.undo()


def _frac_close(a, b, atol=1e-3, rtol=1e-3):
    ok = np.abs(a - b) <= atol + rtol * np.abs(b)
    return ok.reshape(ok.shape[0], -1).all(axis=1).mean()


def _kw(mats, sampler):
    return dict(max_bounces=1, clamp=20.0, sky_intensity=0.35, sampler=sampler,
                two_phase="off", tex_mask=tw.tex_kinds_mask(mats.tex),
                mat_features=tw.mat_feature_mask(mats), has_area_lights=True)


def _jax_radiance(scene, kw, w=W, h=H):
    from rfw_tpu.render.atlas import atlas_to_device
    from rfw_tpu.render.lights_pack import DeviceLights
    from rfw_tpu.render.pack import TraceScene
    from rfw_tpu.render.wavefront import RenderConfig, render_sample

    sc, mats, lights, atlas, camera = scene
    sobol = kw["sampler"] == "sobol"
    r = render_sample(
        TraceScene(*[jnp.asarray(x) for x in sc]), jax.device_put(mats),
        atlas_to_device(atlas), DeviceLights(*[jnp.asarray(x) for x in lights]),
        jnp.asarray(camera.get_view(w, h).as_array()),
        jax.random.fold_in(jax.random.PRNGKey(42), 3), w, h, RenderConfig(**kw),
        sample_index=jnp.uint32(SAMPLE) if sobol else None)
    return np.asarray(r.radiance)


def _port_radiance(scene, kw, w=W, h=H):
    sc, mats, lights, atlas, camera = scene
    s, m, li, a = from_numpy_scene(sc, mats, lights, atlas, device="cpu")
    sobol = kw["sampler"] == "sobol"
    r = tw.render_sample(s, m, a, li, torch.from_numpy(camera.get_view(w, h).as_array()),
                         w, h, tw.RenderConfig(**kw),
                         key=threefry.fold_in(threefry.PRNGKey(42), 3),
                         sample_index=SAMPLE if sobol else None)
    return r.radiance.numpy()


@pytest.mark.parametrize("sampler", ["random", "sobol"])
@pytest.mark.parametrize("traversal", ["lockstep", "packet"])
def test_tier_renders_match_jax(scene, traversal, sampler):
    kw = {**_kw(scene[1], sampler), "traversal": traversal}
    ref, got = _jax_radiance(scene, kw), _port_radiance(scene, kw)
    assert got.shape == (W * H, 3) and np.isfinite(got).all()
    assert _frac_close(got, ref) >= 0.99
    assert ref.mean() > 0 and abs(got.mean() - ref.mean()) <= 1e-3 * ref.mean()


def test_pallas_tier_matches_jax_packet_1024(scene):
    """"pallas" on CPU tensors runs the kernels' plain walks in the lane
    order of rfw_tpu's Pallas tiers: rfw_tpu's packet tier at 1,024 lanes
    draws the same numbers per pixel."""
    kw = _kw(scene[1], "random")
    ref = _jax_radiance(scene, {**kw, "traversal": "packet", "lanes": 1024})
    got = _port_radiance(scene, {**kw, "traversal": "pallas"})
    assert _frac_close(got, ref) >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-3 * ref.mean()


def test_pallas_tier_off_grain_matches_jax(scene):
    """At R no multiple of 1,024 rfw_tpu traces "pallas" with its packet
    tier; the port keeps the kernels (their plain walks on the CPU) in
    that tier's lane order, so the random sampler's frame is rfw_tpu's."""
    w, h = 32, 24
    kw = {**_kw(scene[1], "random"), "traversal": "pallas"}
    ref, got = _jax_radiance(scene, kw, w, h), _port_radiance(scene, kw, w, h)
    assert got.shape == (w * h, 3) and np.isfinite(got).all()
    assert _frac_close(got, ref) >= 0.99
    assert abs(got.mean() - ref.mean()) <= 1e-3 * ref.mean()


@pytest.mark.parametrize("traversal,R_,tier", [
    ("auto", 1024, ("kernel", 256, True)), ("auto", 1000, ("kernel", 0, True)),
    ("pallas", 2048, ("kernel", 1024, True)), ("pallas_hbm", 2048, ("kernel", 1024, True)),
    ("pallas", 1536, ("kernel", 256, False)), ("packet", 1536, ("packet", 256, False)),
    ("packet", 1280, ("packet", 256, False)), ("pallas", 1280 * 3, ("kernel", 256, False)),
    ("pallas_hbm", 1000, ("kernel", 0, False)), ("packet", 1000, ("lockstep", 0, False)),
    ("lockstep", 1024, ("lockstep", 0, False))])
def test_resolve_traversal(traversal, R_, tier):
    cfg = tw.RenderConfig(traversal=traversal)
    assert tw.resolve_traversal(cfg, R_) == tier


def test_unknown_traversal_raises():
    with pytest.raises(ValueError, match="traversal"):
        tw.resolve_traversal(tw.RenderConfig(traversal="bogus"), 1024)


@pytest.fixture(scope="module")
def rays():
    from rfw_tpu.render.pack import TraceScene as JScene

    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        sc, mats, lights, atlas, _ = _torch_scene.build("rfw_tpu", seed=2)
    finally:
        mp.undo()
    o, d = _torch_scene.probe_rays(R, seed=8)
    tl = np.random.default_rng(1).uniform(1.0, 12.0, R).astype(np.float32)
    tscene = from_numpy_scene(sc, mats, lights, atlas, "cpu")[0]
    return dict(jscene=JScene(*[jnp.asarray(x) for x in sc]), scene=tscene,
                o=o, d=d, tl=tl, unique=_torch_scene.unique_closest(sc, o, d))


def _check_hits(got, ref, unique):
    t, jt = got.t.numpy(), np.asarray(ref.t)
    assert np.array_equal(t, jt)
    hm = got.prim.numpy() >= 0
    assert np.array_equal(hm, np.asarray(ref.prim) >= 0) and hm.sum() > R // 4
    uq = hm & unique
    assert uq.sum() > 0.9 * hm.sum()
    for a, b in zip(got[1:], ref[1:]):
        assert np.array_equal(a.numpy()[uq], np.asarray(b)[uq])


@pytest.mark.parametrize("lanes", [256, 64])
def test_packet_calls_match_jax(rays, lanes):
    from rfw_tpu.render import packet as jp

    ps, jps = tp.prepare_packet_scene(rays["scene"]), jp.prepare_packet_scene(rays["jscene"])
    o, d, tl = rays["o"], rays["d"], rays["tl"]
    got = tp.packet_closest_hit(ps, torch.from_numpy(o), torch.from_numpy(d), lanes=lanes)
    ref = jp.packet_closest_hit(jps, jnp.asarray(o), jnp.asarray(d), lanes=lanes)
    _check_hits(got, ref, rays["unique"])
    occ = tp.packet_occluded(ps, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tl), lanes=lanes).numpy()
    jocc = np.asarray(jp.packet_occluded(jps, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(tl), lanes=lanes))
    assert np.array_equal(occ, jocc) and 0 < occ.sum() < R


def test_lockstep_calls_match_jax(rays):
    from rfw_tpu.render import intersect as ji

    o, d, tl = rays["o"], rays["d"], rays["tl"]
    got = ti.bvh_closest_hit(rays["scene"], torch.from_numpy(o), torch.from_numpy(d))
    ref = jax.jit(ji.bvh_closest_hit)(rays["jscene"], jnp.asarray(o), jnp.asarray(d))
    _check_hits(got, ref, rays["unique"])
    occ = ti.bvh_occluded(rays["scene"], torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(tl)).numpy()
    jocc = np.asarray(jax.jit(ji.bvh_occluded)(rays["jscene"], jnp.asarray(o),
                                               jnp.asarray(d), jnp.asarray(tl)))
    assert np.array_equal(occ, jocc) and 0 < occ.sum() < R
