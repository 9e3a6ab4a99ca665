"""The names of `rfw_tpu` that the port adds under the same import paths,
against `rfw_tpu`'s on the same seeded inputs, on the CPU:

  * the package exports: `render` (TraceScene, pack_trace_scene,
    bvh_closest_hit, bvh_occluded, brute_force_closest), `accel` (BvhNodes,
    build_bvh_sah, build_lbvh_device) and `ops` (PallasScene,
    prepare_pallas_scene, pallas_closest_hit, pallas_occluded,
    pallas_tlas_entries). `pallas_closest_hit` and `pallas_occluded` with
    `interpret=True` run the plain versions and are held against
    `rfw_tpu`'s in Pallas interpret mode under
    `tests/test_torch_traverse.py`'s tolerances: hit masks and occlusion
    flags exact, t within 3e-5 relative (the Pallas kernel's refined
    reciprocal), prim and inst equal where the closest t is unique;
    `pallas_tlas_entries` against `rfw_tpu`'s dense scan of the same
    contract under `tests/test_torch_twophase.py`'s entry tolerance;
  * RFW_TWO_PHASE, read by `render_sample` at each call, overriding
    `RenderConfig.two_phase`: "1" on, anything else off. Both packages'
    bounce rays take the route the variable names (rfw_tpu's traced
    render, its Pallas calls stubbed, and the port's render);
  * the (R,3) wrappers `disney._refract` (the Snell, eta = 1 and total
    internal reflection cases of `tests/test_refraction.py`, rtol 1e-5 /
    atol 1e-6) and `disney._sample_cosine`, `wavefront._sample_light`,
    `_fetch_material` and `_shading_basis` (`tests/test_torch_wavefront.py`'s
    tolerances: rtol 1e-5, atol 1e-6; radiance over pdf at rtol 1e-4);
  * `BvhNodes.sah_cost` and its two constants (equal), and
    `refit_device.apply_dynamic_jit()` / `instance_motion_jit()`, which
    return the eager updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch.convert import from_numpy_scene

ATOL, RTOL = 1e-6, 1e-5
R = 1024  # one Pallas program of rays


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with _torch_scene.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def setup():
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        parts = _torch_scene.build("rfw_tpu", seed=2)
    finally:
        mp.undo()
    scene, mats, lights, atlas, camera = parts
    t = from_numpy_scene(scene, mats, lights, atlas, "cpu")
    o, d = _torch_scene.probe_rays(R, seed=8)
    return dict(parts=parts, t=t, o=o, d=d, unique=_torch_scene.unique_closest(scene, o, d))


def _close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


# ------------------------------------------------------------ package names
def test_package_exports_are_the_modules_names():
    import rfw_tpu_torch.accel as accel
    import rfw_tpu_torch.ops as ops
    import rfw_tpu_torch.render as render
    from rfw_tpu_torch.accel import bvh_cpu, lbvh
    from rfw_tpu_torch.ops import traverse, traverse_entries
    from rfw_tpu_torch.render import intersect, pack

    for mod, names in ((render, ("TraceScene", "pack_trace_scene", "bvh_closest_hit",
                                 "bvh_occluded", "brute_force_closest")),
                       (accel, ("BvhNodes", "build_bvh_sah", "build_lbvh_device")),
                       (ops, ("PallasScene", "prepare_pallas_scene", "pallas_closest_hit",
                              "pallas_occluded", "pallas_tlas_entries",
                              "pallas_twophase_closest_hit"))):
        for name in names:
            home = next(m for m in (pack, intersect, bvh_cpu, lbvh, traverse, traverse_entries,
                                    ops.traverse_items) if hasattr(m, name))
            assert getattr(mod, name) is getattr(home, name), name
    assert ops.PallasScene is traverse.PreparedScene


def test_render_exports_match_reference(setup):
    """pack_trace_scene packs rfw_tpu's arenas; the lockstep walks and the
    brute-force oracle find rfw_tpu's hits."""
    import rfw_tpu.models as jmodels
    import rfw_tpu.render as jr
    import rfw_tpu_torch.models as tmodels
    from rfw_tpu_torch.render import (
        TraceScene, brute_force_closest, bvh_closest_hit, bvh_occluded, pack_trace_scene,
    )

    assert TraceScene._fields == jr.TraceScene._fields
    inst = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    inst[1, :3, 3] = (1.5, 0.2, -0.4)
    got = pack_trace_scene([(0, tmodels.sphere(quality=1), None)], [(0, inst)])
    ref = jr.pack_trace_scene([(0, jmodels.sphere(quality=1), None)], [(0, inst)])
    for f in TraceScene._fields:
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f

    scene = setup["parts"][0]
    o, d = setup["o"], setup["d"]
    jscene = jr.TraceScene(*[jnp.asarray(x) for x in scene])
    h = bvh_closest_hit(setup["t"][0], torch.from_numpy(o), torch.from_numpy(d))
    jh = jr.bvh_closest_hit(jscene, jnp.asarray(o), jnp.asarray(d))
    assert np.array_equal(h.t.numpy(), np.asarray(jh.t))
    uq = setup["unique"]
    assert uq.sum() > R // 4
    assert np.array_equal(h.prim.numpy()[uq], np.asarray(jh.prim)[uq])
    occ = bvh_occluded(setup["t"][0], torch.from_numpy(o), torch.from_numpy(d), 6.0)
    assert np.array_equal(occ.numpy(), np.asarray(jr.bvh_occluded(
        jscene, jnp.asarray(o), jnp.asarray(d), 6.0)))

    v0, e1, e2, _ = _torch_scene.world_triangles(scene)
    o, d = o[:128], d[:128]  # (rays, triangles) arrays
    got = brute_force_closest(*(torch.from_numpy(x) for x in (o, d, v0, e1, e2)))
    ref = jr.brute_force_closest(*(jnp.asarray(x) for x in (o, d, v0, e1, e2)))
    # tests/test_torch_traverse.py's oracle tolerances: t at rtol 1e-5 plus
    # atol 2e-6, u and v at atol 1e-4
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    hit = got[1].numpy() >= 0
    _close(got[0].numpy()[hit], np.asarray(ref[0])[hit], atol=2e-6)
    for g, r in zip(got[2:], ref[2:]):
        _close(g.numpy()[hit], np.asarray(r)[hit], rtol=0, atol=1e-4)


def test_accel_exports_match_reference():
    """build_bvh_sah (the numpy builder) builds rfw_tpu's tree, whose
    sah_cost is rfw_tpu's; build_lbvh_device builds rfw_tpu's LBVH at a
    count that is no power of two (tests/test_torch_lbvh.py covers the
    rest)."""
    import rfw_tpu.accel as ja
    from rfw_tpu.accel import bvh_cpu as jb
    from rfw_tpu_torch.accel import BvhNodes, build_bvh_sah, build_lbvh_device, bvh_cpu

    assert (bvh_cpu.TRAVERSAL_COST, bvh_cpu.INTERSECT_COST) == (jb.TRAVERSAL_COST,
                                                                 jb.INTERSECT_COST)
    rng = np.random.default_rng(11)
    c = rng.uniform(-10, 10, (200, 3)).astype(np.float32)
    mn, mx = c - 0.3, c + rng.uniform(0.1, 1.0, (200, 3)).astype(np.float32)
    got = build_bvh_sah(mn, mx, use_native=False)
    ref = ja.build_bvh_sah(mn, mx, use_native=False)
    assert isinstance(got, BvhNodes)
    for f in ("node_min", "node_max", "node_left", "node_right", "node_count", "prim_order"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert got.sah_cost() == ref.sah_cost() and got.sah_cost() > 0

    n = 48
    lb = build_lbvh_device(torch.from_numpy(mn[:n]), torch.from_numpy(mx[:n]))
    jl = ja.build_lbvh_device(jnp.asarray(mn[:n]), jnp.asarray(mx[:n]))
    for f in lb._fields:
        assert np.array_equal(getattr(lb, f).numpy(), np.asarray(getattr(jl, f))), f


# ---------------------------------------------------------------- ops names
@pytest.fixture(scope="module")
def pallas(setup):
    from rfw_tpu.ops import pallas_closest_hit, pallas_occluded, prepare_pallas_scene
    from rfw_tpu.render.pack import TraceScene

    jps = prepare_pallas_scene(TraceScene(*[jnp.asarray(x) for x in setup["parts"][0]]))
    o, d = jnp.asarray(setup["o"]), jnp.asarray(setup["d"])
    return dict(hit=pallas_closest_hit(jps, o, d, interpret=True),
                occ=np.asarray(pallas_occluded(jps, o, d, 6.0, interpret=True)))


def test_pallas_names_match_reference_interpret(setup, pallas):
    from rfw_tpu_torch.ops import (
        PallasScene, pallas_closest_hit, pallas_occluded, prepare_pallas_scene,
    )
    from rfw_tpu_torch.ops import traverse as tr

    ps = prepare_pallas_scene(setup["t"][0])
    assert isinstance(ps, PallasScene)
    ref_ps = tr.prepare_scene(setup["t"][0])
    for f in PallasScene._fields:
        a, b = getattr(ps, f), getattr(ref_ps, f)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f
    o, d = torch.from_numpy(setup["o"]), torch.from_numpy(setup["d"])

    h = pallas_closest_hit(ps, o, d, interpret=True)
    jh = pallas["hit"]
    hm = h.prim.numpy() >= 0
    assert np.array_equal(hm, np.asarray(jh.prim) >= 0) and hm.sum() > R // 4
    _close(h.t.numpy()[hm], np.asarray(jh.t)[hm], rtol=3e-5, atol=0)
    uq = hm & setup["unique"]
    assert np.array_equal(h.prim.numpy()[uq], np.asarray(jh.prim)[uq])
    assert np.array_equal(h.inst.numpy()[uq], np.asarray(jh.inst)[uq])
    # on CPU tensors the wrapper's kernel route runs the same plain walk;
    # tri_hbm changes nothing
    for got in (pallas_closest_hit(ps, o, d), pallas_closest_hit(ps, o, d, tri_hbm=True)):
        assert all(torch.equal(a, b) for a, b in zip(got, h))
    hs, stats = pallas_closest_hit(ps, o, d, interpret=True, stats=True)
    assert all(torch.equal(a, b) for a, b in zip(hs, h))
    assert stats.nodes.shape == (R,) and bool((stats.nodes > 0).all())

    occ = pallas_occluded(ps, o, d, 6.0, interpret=True)
    assert occ.dtype == torch.bool and np.array_equal(occ.numpy(), pallas["occ"])
    assert torch.equal(pallas_occluded(ps, o, d, 6.0, tri_hbm=True), occ)


def test_pallas_tlas_entries_matches_reference(setup):
    """pallas_tlas_entries (the tree walk's plain version) against
    rfw_tpu's dense scan of the same contract, `render.twophase.
    dense_tlas_entries`, under tests/test_torch_twophase.py's entry
    tolerance (its Pallas interpret run, which that file makes, takes half
    a minute); the kernel route on CPU tensors gives the same lists."""
    from rfw_tpu.render.twophase import dense_tlas_entries
    from rfw_tpu_torch.ops import pallas_tlas_entries, prepare_pallas_scene
    from test_torch_twophase import _assert_entries_match

    ps = prepare_pallas_scene(setup["t"][0])
    scene = setup["parts"][0]
    o, d = torch.from_numpy(setup["o"]), torch.from_numpy(setup["d"])
    e = pallas_tlas_entries(ps, o, d, 6.0, K=4, interpret=True)
    ref = dense_tlas_entries(jnp.asarray(scene.inst_aabb_min), jnp.asarray(scene.inst_aabb_max),
                             jnp.asarray(setup["o"]), jnp.asarray(setup["d"]), 6.0, K=4)
    assert int((e.inst >= 0).sum()) > R // 4
    _assert_entries_match(e.t_entry, e.inst, ref.t_entry, ref.inst, 1e-5)
    got = pallas_tlas_entries(ps, o, d, 6.0, K=4)
    assert torch.equal(got.t_entry, e.t_entry) and torch.equal(got.inst, e.inst)


# ------------------------------------------------------------- RFW_TWO_PHASE
W = H = 32  # one 1,024-ray tile: rfw_tpu's Pallas tier and its two-phase route


def _reference_route(parts, two_phase, monkeypatch) -> bool:
    """Whether rfw_tpu's render_sample ("pallas" tier) routes bounce rays
    through its two-phase call: its render is traced, not run, with the
    Pallas calls stubbed by misses of the right shapes."""
    import rfw_tpu.ops.traverse_items as jti
    from rfw_tpu.render import wavefront as jw
    from rfw_tpu.render.atlas import atlas_to_device
    from rfw_tpu.render.intersect import Hit
    from rfw_tpu.render.lights_pack import DeviceLights
    from rfw_tpu.render.pack import TraceScene

    seen = []

    def miss(ps, o, d, tl=None, **kw):
        n = o.shape[0]
        return Hit(jnp.full(n, 1e26, jnp.float32), jnp.full(n, -1, jnp.int32),
                   jnp.full(n, -1, jnp.int32), jnp.zeros(n), jnp.zeros(n))

    def twophase(*a, **kw):
        seen.append(1)
        return miss(*a)

    monkeypatch.setattr(jw, "pallas_closest_hit", miss)
    monkeypatch.setattr(jw, "pallas_occluded", lambda ps, o, *a, **k: jnp.zeros(o.shape[0], bool))
    monkeypatch.setattr(jti, "twophase_closest_with_fallback", twophase)
    sc, mats, lights, atlas, camera = parts
    cfg = jw.RenderConfig(max_bounces=1, sampler="sobol", traversal="pallas",
                          two_phase=two_phase, tex_mask=jw.tex_kinds_mask(mats.tex),
                          mat_features=jw.mat_feature_mask(mats))
    jw.render_sample.clear_cache()  # it reads the variable while traced
    try:
        jax.eval_shape(lambda: jw.render_sample(
            TraceScene(*[jnp.asarray(x) for x in sc]), jax.device_put(mats),
            atlas_to_device(atlas), DeviceLights(*[jnp.asarray(x) for x in lights]),
            jnp.asarray(camera.get_view(W, H).as_array()), jax.random.PRNGKey(0), W, H, cfg,
            sample_index=jnp.uint32(1)))
    finally:
        jw.render_sample.clear_cache()
    return bool(seen)


def _port_route(setup, two_phase, monkeypatch) -> bool:
    from rfw_tpu_torch.render import wavefront as tw

    seen = []
    orig = tw.twophase_closest_with_fallback

    def twophase(*a, **kw):
        seen.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tw, "twophase_closest_with_fallback", twophase)
    sc, mats, lights, atlas = setup["t"]
    mats_np, camera = setup["parts"][1], setup["parts"][4]
    cfg = tw.RenderConfig(max_bounces=1, sampler="sobol", traversal="pallas",
                          two_phase=two_phase, tex_mask=tw.tex_kinds_mask(mats_np.tex),
                          mat_features=tw.mat_feature_mask(mats_np))
    r = tw.render_sample(sc, mats, atlas, lights, torch.from_numpy(camera.get_view(W, H).as_array()),
                         W, H, cfg, sample_index=1)
    assert r.radiance.shape == (W * H, 3) and bool(torch.isfinite(r.radiance).all())
    return bool(seen)


@pytest.mark.parametrize("two_phase,env,route", [
    ("auto", None, True), ("off", "1", True), ("auto", "0", False), ("on", "yes", False)])
def test_two_phase_variable_picks_the_route(setup, monkeypatch, two_phase, env, route):
    if env is None:
        monkeypatch.delenv("RFW_TWO_PHASE", raising=False)
    else:
        monkeypatch.setenv("RFW_TWO_PHASE", env)
    assert _reference_route(setup["parts"], two_phase, monkeypatch) is route
    assert _port_route(setup, two_phase, monkeypatch) is route


# ------------------------------------------------------------- C3 wrappers
def _refract_cases():
    """tests/test_refraction.py's: Snell at 45 degrees into glass, eta = 1
    on 64 seeded front-facing pairs, and glass to air past the critical
    angle."""
    s = np.sin(np.deg2rad(45.0))
    snell = (np.array([[s, 0, np.cos(np.deg2rad(45.0))]], np.float32),
             np.array([[0, 0, 1]], np.float32), np.array([1 / 1.5], np.float32))
    rng = np.random.default_rng(1)
    wo = rng.normal(size=(64, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wo[:, 2] = np.abs(wo[:, 2]) + 0.05
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    h = rng.normal(size=(64, 3)).astype(np.float32)
    h[:, 2] = np.abs(h[:, 2]) + 1.0
    h /= np.linalg.norm(h, axis=-1, keepdims=True)
    keep = np.sum(wo * h, axis=-1) > 1e-3
    one = (wo[keep], h[keep], np.ones(int(keep.sum()), np.float32))
    c = np.sqrt(1 - (1 / 1.5) ** 2) * 0.9  # cos below the critical angle's
    tir = (np.array([[np.sqrt(1 - c * c), 0, c]], np.float32),
           np.array([[0, 0, 1]], np.float32), np.array([1.5], np.float32))
    return {"snell": snell, "eta_one": one, "tir": tir}


@pytest.mark.parametrize("case", ["snell", "eta_one", "tir"])
def test_refract_matches_reference(case):
    from rfw_tpu.render import disney as jd
    from rfw_tpu_torch.render import disney as td

    wo, h, eta = _refract_cases()[case]
    wi, tir = td._refract(*map(torch.from_numpy, (wo, h, eta)))
    rwi, rtir = jd._refract(*map(jnp.asarray, (wo, h, eta)))
    assert np.array_equal(tir.numpy(), np.asarray(rtir))
    _close(wi, rwi)
    if case == "snell":
        w = wi.numpy()[0]
        assert not tir[0] and w[2] < 0 and w[0] < 0
        np.testing.assert_allclose(np.hypot(w[0], w[1]), np.sin(np.deg2rad(45.0)) / 1.5,
                                   atol=1e-5)
    elif case == "eta_one":
        _close(wi, -wo, rtol=0, atol=1e-5)
        assert not tir.any()
    else:
        assert bool(tir.all())


def test_sample_cosine_matches_reference():
    from rfw_tpu.render import disney as jd
    from rfw_tpu_torch.render import disney as td

    u = np.random.default_rng(3).random((2, R)).astype(np.float32)
    got = td._sample_cosine(*map(torch.from_numpy, u))
    assert got.shape == (R, 3)
    assert torch.equal(got, td.v3_stack(td._sample_cosine_c(*map(torch.from_numpy, u))))
    _close(got, jd._sample_cosine(*map(jnp.asarray, u)))


def test_sample_light_matches_reference():
    from rfw_tpu.render import wavefront as jw
    from rfw_tpu.render.lights_pack import DeviceLights as JL
    from rfw_tpu_torch.render import wavefront as tw
    from test_torch_wavefront import _light_table_lights

    lights = _light_table_lights(4)
    rng = np.random.default_rng(6)
    p = rng.uniform(-3, 3, (R, 3)).astype(np.float32)
    ns = rng.normal(size=(R, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    u = rng.random((R, 3)).astype(np.float32)
    got = tw._sample_light(type(lights)(*[torch.from_numpy(np.asarray(x)) for x in lights]),
                           *map(torch.from_numpy, (p, u, ns)))
    ref = jw._sample_light(JL(*[jnp.asarray(x) for x in lights]), *map(jnp.asarray, (p, u, ns)))
    assert got[0].shape == (R, 3) and got[2].shape == (R, 3)
    for name, g, r in zip(("wi", "dist", "rad_over_pdf", "is_delta", "pdf_sa", "pick_norm"),
                          got, ref):
        if name == "is_delta":
            assert np.array_equal(g.numpy(), np.asarray(r))
        else:
            _close(g, r, rtol=1e-4 if name == "rad_over_pdf" else RTOL, msg=name)


def test_shading_basis_and_fetch_material_match_reference(setup):
    """At the lockstep walk's hits of the probe rays: the shading basis
    from each package's own hits (the walks agree bit for bit), then the
    material fetch at its uv and material ids."""
    from rfw_tpu.render import intersect as ji
    from rfw_tpu.render import wavefront as jw
    from rfw_tpu.render.atlas import atlas_to_device
    from rfw_tpu.render.pack import TraceScene as JScene
    from rfw_tpu_torch.render import intersect as ti
    from rfw_tpu_torch.render import wavefront as tw

    scene_np, mats_np, _, atlas_np, _ = setup["parts"]
    sc, mats, _, atlas = setup["t"]
    o, d = setup["o"], setup["d"]
    h = ti.bvh_closest_hit(sc, torch.from_numpy(o), torch.from_numpy(d))
    jscene = JScene(*[jnp.asarray(x) for x in scene_np])
    jh = ji.bvh_closest_hit(jscene, jnp.asarray(o), jnp.asarray(d))
    b = tw._shading_basis(sc, h, torch.from_numpy(d))
    rb = jw._shading_basis(jscene, jh, jnp.asarray(d))
    assert set(b) == set(rb)
    for k in ("ns", "ng", "tan", "bitan", "centroid_w"):
        assert b[k].shape == (R, 3), k
    assert b["uv"].shape == (R, 2)
    for k in b:
        _close(b[k], rb[k], atol=1e-5 if k == "centroid_w" else ATOL, msg=k)

    mat_id = b["mat_id"]
    lod = torch.zeros(R)
    for uv in (b["uv"], (b["uv"][:, 0], b["uv"][:, 1])):
        got = tw._fetch_material(mats, atlas, mat_id, uv, lod, b["entering"],
                                 tex_mask=tw.tex_kinds_mask(mats_np.tex))
        ref = jw._fetch_material(jax.device_put(mats_np), atlas_to_device(atlas_np),
                                 jnp.asarray(mat_id.numpy()), jnp.asarray(b["uv"].numpy()),
                                 jnp.asarray(lod.numpy()), jnp.asarray(b["entering"].numpy()),
                                 tex_mask=jw.tex_kinds_mask(mats_np.tex))
        assert got[0].base_color.shape == (R, 3)
        for f in got[0]._fields:
            _close(getattr(got[0], f), getattr(ref[0], f), msg=f)
        for name, g, r in zip(("emission", "n_ts", "emission_base", "absorption"),
                              got[1:], ref[1:]):
            assert g.shape == (R, 3)
            _close(g, r, msg=name)


def test_refit_jit_names_return_the_eager_updates():
    from rfw_tpu_torch.render import refit_device as rd

    assert rd.apply_dynamic_jit() is rd.apply_dynamic
    assert rd.instance_motion_jit() is rd.instance_motion_update
