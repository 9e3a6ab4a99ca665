"""Wide supernodes (RFW_WIDE_ARITY 16 and 32) in the port, against rfw_tpu
(the counterpart of `tests/test_arity.py`).

The supernode width is a pack-time knob (`render.pack.wide_depth`, set only
around the pack call here); the port's walks read it from the packed rows
(`ops.traverse.prepare_scene`), so 16- and 32-wide packs go through the
same plain walks (and, on a card, the kernels' 16- and 32-wide instances,
which `chip_smoke.py` phase 16 holds against these plain walks).

Tolerances (the arity-8 gates of `tests/test_torch_traverse.py` and
`tests/test_torch_items.py`):
  * packs: bit-identical to rfw_tpu's (numpy and native collapse alike);
  * hit masks and occlusion flags: exact;
  * t vs the brute-force oracle: rtol 1e-5 plus atol 2e-6;
  * t vs rfw_tpu's Pallas kernels in interpret mode: rtol 3e-5 (their
    approximate reciprocal);
  * prim and inst: equal where the closest t is unique (no second hit
    within 1e-6 relative), since exact-t ties may fall either way;
  * u, v: atol 1e-4 vs the oracle, 2e-3 vs the Pallas kernels;
  * a wide walk against the 8-wide one on the same arenas: hit masks
    equal, t within rtol 1e-6 (`tests/test_arity.py`'s bar);
  * render_sample against rfw_tpu's under "sobol": at least 99% of pixels
    within atol 1e-3 + rtol 1e-3 on every channel, the mean within 1e-3
    relative (`tests/test_torch_wavefront.py`'s);
  * frames of the backend's host routes: equal to the 8-wide pack's
    device routes' (uint8 NORMAL frames of pixel-centre rays).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch.convert import from_numpy_scene
from rfw_tpu_torch.ops import traverse as tr
from rfw_tpu_torch.ops import traverse_items as ti
from rfw_tpu_torch.render.intersect import brute_force_closest

R = 1024  # one Pallas program of rays
WIDE = (16, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with _torch_scene.one_torch_thread():
        yield


def _build(pkg: str, arity: int, native: bool = False, **kw):
    """_torch_scene.build through `pkg` with RFW_WIDE_ARITY set around it
    (numpy BVH and collapse unless `native`)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_WIDE_ARITY", str(arity))
    if native:
        mp.delenv("RFW_NO_NATIVE", raising=False)
    else:
        mp.setenv("RFW_NO_NATIVE", "1")
    try:
        return _torch_scene.build(pkg, **kw)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def rays():
    o, d = _torch_scene.probe_rays(R, seed=8)
    return o, d, torch.from_numpy(o), torch.from_numpy(d)


@pytest.fixture(scope="module")
def oracle(rays):
    """The brute-force closest hits on the seed-2 scene (the arenas'
    triangles do not depend on the width) and which of them are unique."""
    scene = _build("rfw_tpu", 8, seed=2)[0]
    _, _, ot, dt = rays
    v0, e1, e2, ids = (torch.from_numpy(x) for x in _torch_scene.world_triangles(scene))
    t, j, u, v = brute_force_closest(ot, dt, v0, e1, e2)
    prim = torch.where(j >= 0, ids[j.clamp(min=0).long()], -1)
    unique = torch.from_numpy(_torch_scene.unique_closest(scene, *rays[:2]))
    return dict(t=t, prim=prim, u=u, v=v, unique=unique)


def _prepared(scene, mats, lights, atlas):
    return tr.prepare_scene(from_numpy_scene(scene, mats, lights, atlas, "cpu")[0])


@pytest.fixture(scope="module")
def prepared():
    """{arity: (rfw_tpu's numpy pack, the port's PreparedScene of it)}, and
    under "parts" the pack's materials, lights and atlas."""
    out = {}
    for a in (8,) + WIDE:
        scene, mats, lights, atlas, _ = _build("rfw_tpu", a, seed=2)
        out[a] = (scene, _prepared(scene, mats, lights, atlas))
    out["parts"] = (mats, lights, atlas)
    return out


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("arity", WIDE)
def test_pack_matches_reference(arity, native):
    """The port packs a wide scene bit for bit as rfw_tpu does, with either
    collapse; its wide rows have the asked width."""
    ref = _build("rfw_tpu", arity, native, seed=3)[0]
    got = _build("rfw_tpu_torch", arity, native, seed=3)[0]
    assert got.blas8_code.shape[1] == arity and got.tlas8_code.shape[1] == arity
    assert got.blas8_box.shape[1] == 6 * arity
    _torch_scene.same(ref, got)


@pytest.mark.parametrize("depth", [4, 5])
def test_native_collapse_at_depth(depth, monkeypatch):
    """Depths 4 and 5 reach the native library (it returns rows) and come
    back bit-identical to the numpy collapse, for a BLAS and a TLAS."""
    from rfw_tpu_torch import native
    from rfw_tpu_torch.accel.bvh_cpu import build_bvh_sah
    from rfw_tpu_torch.render.pack import build_widen

    monkeypatch.setenv("RFW_NO_NATIVE", "1")
    rng = np.random.default_rng(depth)
    mn = rng.uniform(-5, 5, (700, 3)).astype(np.float32)
    mx = mn + rng.uniform(0.01, 0.5, (700, 3)).astype(np.float32)
    for tlas, leaf in ((False, 8), (True, 1)):
        bvh = build_bvh_sah(mn, mx, max_leaf=leaf)
        fast = native.build_widen_native(bvh, tlas, 64, depth)
        assert fast is not None and fast[1].shape[1] == 1 << depth
        slow = build_widen(bvh, tlas, 64, depth=depth)
        for a, b in zip(fast, slow):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_wide_depth_reads_the_knob(monkeypatch):
    from rfw_tpu_torch.render.pack import wide_depth

    for a, depth in ((8, 3), (16, 4), (32, 5)):
        monkeypatch.setenv("RFW_WIDE_ARITY", str(a))
        assert wide_depth() == depth
    monkeypatch.delenv("RFW_WIDE_ARITY")
    assert wide_depth() == 3
    monkeypatch.setenv("RFW_WIDE_ARITY", "12")
    with pytest.raises(AssertionError):
        wide_depth()


@pytest.mark.parametrize("arity", WIDE)
def test_prepared_layout_matches_pallas_scene(prepared, arity):
    """Rows of 8A int32, the same columns as the Pallas scene's; the dense
    tier's treelet tables name the same treelets at every width."""
    from rfw_tpu.ops import prepare_pallas_scene
    from rfw_tpu.render.pack import TraceScene

    scene, ps = prepared[arity]
    jps = prepare_pallas_scene(TraceScene(*[jnp.asarray(x) for x in scene]))
    assert ps.arity == arity and ps.nodes.shape[1] == 8 * arity
    assert np.asarray(jps.scene_t).shape[0] == 8 * arity
    assert np.array_equal(np.asarray(jps.scene_t).T[:ps.nodes.shape[0]], ps.nodes.numpy())
    ps8 = prepared[8][1]
    assert torch.equal(ps.tcount, ps8.tcount) and torch.equal(ps.tbox, ps8.tbox)


def test_prepare_scene_refuses_other_widths(prepared):
    scene = prepared[8][0]
    cut = scene._replace(blas8_box=scene.blas8_box[:, :24], blas8_code=scene.blas8_code[:, :4],
                         blas8_cnt=scene.blas8_cnt[:, :4], tlas8_box=scene.tlas8_box[:, :24],
                         tlas8_code=scene.tlas8_code[:, :4], tlas8_cnt=scene.tlas8_cnt[:, :4])
    with pytest.raises(ValueError, match="arity 4"):
        _prepared(cut, *prepared["parts"])
    mixed = prepared[16][0]._replace(tlas8_box=scene.tlas8_box, tlas8_code=scene.tlas8_code,
                                     tlas8_cnt=scene.tlas8_cnt)
    with pytest.raises(ValueError, match="TLAS 8"):
        _prepared(mixed, *prepared["parts"])


@pytest.mark.parametrize("arity", WIDE)
def test_plain_walks_match_pallas_and_oracle(prepared, rays, oracle, arity):
    """The plain closest hit and occlusion over a wide pack against
    rfw_tpu's Pallas kernels (interpret mode) on the same pack, the brute
    oracle and the port's 8-wide walk; no push finds the stack full."""
    from rfw_tpu.ops import pallas_closest_hit, pallas_occluded, prepare_pallas_scene
    from rfw_tpu.render.pack import TraceScene

    o, d, ot, dt = rays
    scene, ps = prepared[arity]
    h, st = tr.closest_hit(ps, ot, dt, stats=True)
    assert int(st.full) == 0 and int(st.nodes.sum()) > 0
    hm, rm = h.prim >= 0, oracle["prim"] >= 0
    assert torch.equal(hm, rm) and int(hm.sum()) > R // 4
    np.testing.assert_allclose(h.t[hm].numpy(), oracle["t"][hm].numpy(), rtol=1e-5, atol=2e-6)
    uq = hm & oracle["unique"]
    assert int(uq.sum()) > 0.9 * int(hm.sum())
    assert torch.equal(h.prim[uq], oracle["prim"][uq].to(torch.int32))
    np.testing.assert_allclose(h.u[uq].numpy(), oracle["u"][uq].numpy(), atol=1e-4)
    np.testing.assert_allclose(h.v[uq].numpy(), oracle["v"][uq].numpy(), atol=1e-4)

    h8 = tr.closest_hit(prepared[8][1], ot, dt)
    assert torch.equal(h8.prim >= 0, hm)
    np.testing.assert_allclose(h.t.numpy(), h8.t.numpy(), rtol=1e-6, atol=1e-6)

    jps = prepare_pallas_scene(TraceScene(*[jnp.asarray(x) for x in scene]))
    jh = pallas_closest_hit(jps, jnp.asarray(o), jnp.asarray(d), interpret=True)
    jm = np.asarray(jh.prim) >= 0
    assert np.array_equal(hm.numpy(), jm)
    np.testing.assert_allclose(h.t.numpy()[jm], np.asarray(jh.t)[jm], rtol=3e-5)
    uqn = uq.numpy()
    for name, tol in (("prim", None), ("inst", None), ("u", 2e-3), ("v", 2e-3)):
        a, b = getattr(h, name).numpy()[uqn], np.asarray(getattr(jh, name))[uqn]
        if tol is None:
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(a, b, atol=tol, err_msg=name)

    # occlusion within a finite limit: half the rays' limits lie short of
    # their closest hit
    lim = np.where(np.arange(R) % 2 == 0, 1e30, 0.5 * np.asarray(jh.t)).astype(np.float32)
    occ, ost = tr.occluded(ps, ot, dt, torch.from_numpy(lim), stats=True)
    assert int(ost.full) == 0
    jocc = np.asarray(pallas_occluded(jps, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lim),
                                      interpret=True))
    assert np.array_equal(occ.numpy(), jocc)
    assert torch.equal(occ, (oracle["prim"] >= 0) & (oracle["t"] < torch.from_numpy(lim)))
    assert torch.equal(occ, tr.occluded(prepared[8][1], ot, dt, torch.from_numpy(lim)))


def test_twophase_16_matches_classic_and_reference(prepared, rays, oracle, monkeypatch):
    """The plain two-phase closest hit at 16 (phase A by the TLAS entries
    walk, K4's plain version, over the 16-wide TLAS; phase B by the items
    walk, K3's) against the classic walk at 16 and rfw_tpu's
    twophase_closest_with_fallback (interpret mode) on the same pack."""
    from rfw_tpu.ops import prepare_pallas_scene
    from rfw_tpu.ops.traverse_items import twophase_closest_with_fallback as jcall
    from rfw_tpu.render.pack import TraceScene

    monkeypatch.setattr(ti, "DENSE_A_MAX_INST", 0)  # phase A by the tree walk
    o, d, ot, dt = rays
    scene, ps = prepared[16]
    _, trunc = ti.twophase_closest_fused(ps, ot, dt, K=2)
    assert int(trunc.sum()) > 0  # the fallback runs
    h = ti.twophase_closest_with_fallback(ps, ot, dt, K=2)
    classic = tr.closest_hit(ps, ot, dt)
    hm = h.prim >= 0
    assert torch.equal(hm, classic.prim >= 0)
    assert torch.equal(h.t, classic.t)
    uq = hm & oracle["unique"]
    assert torch.equal(h.prim[uq], classic.prim[uq]) and torch.equal(h.inst[uq], classic.inst[uq])

    jps = prepare_pallas_scene(TraceScene(*[jnp.asarray(x) for x in scene]))
    j = jcall(jps, jnp.asarray(o), jnp.asarray(d), interpret=True)
    assert np.array_equal(hm.numpy(), np.asarray(j.prim) >= 0)
    np.testing.assert_allclose(h.t.numpy()[hm.numpy()], np.asarray(j.t)[hm.numpy()], rtol=3e-5)
    assert np.array_equal(h.prim.numpy()[uq.numpy()], np.asarray(j.prim)[uq.numpy()])


def test_render_sample_16_matches_reference():
    """render_sample over a 16-wide pack, per pixel under "sobol" at 32x32,
    against rfw_tpu's over the same pack (its "packet" tier on the CPU)
    and against the port's own frame over the 8-wide pack."""
    import jax

    from rfw_tpu.render.atlas import atlas_to_device
    from rfw_tpu.render.lights_pack import DeviceLights
    from rfw_tpu.render.pack import TraceScene
    from rfw_tpu.render.wavefront import RenderConfig, render_sample
    from rfw_tpu_torch.render import wavefront as tw

    W = H = 32
    frames = {}
    for a in (8, 16):
        sc, mats, lights, atlas, camera = _build("rfw_tpu", a, seed=1)
        kw = dict(max_bounces=1, clamp=20.0, sky_intensity=0.35, sampler="sobol",
                  two_phase="off", aovs=False, tex_mask=tw.tex_kinds_mask(mats.tex),
                  mat_features=tw.mat_feature_mask(mats), has_area_lights=True)
        view = camera.get_view(W, H).as_array()
        s, m, li, at = from_numpy_scene(sc, mats, lights, atlas, device="cpu")
        assert tr.prepare_scene(s).arity == a
        frames[a] = tw.render_sample(s, m, at, li, torch.from_numpy(view), W, H,
                                     tw.RenderConfig(**kw), sample_index=3).radiance.numpy()
    ref = np.asarray(render_sample(
        TraceScene(*[jnp.asarray(x) for x in sc]), jax.device_put(mats), atlas_to_device(atlas),
        DeviceLights(*[jnp.asarray(x) for x in lights]), jnp.asarray(view),
        jax.random.PRNGKey(0), W, H, RenderConfig(traversal="packet", **kw),
        sample_index=jnp.uint32(3)).radiance)
    for got in (frames[16], frames[8]):
        assert np.isfinite(got).all() and got.shape == (W * H, 3)
        ok = np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref)
        assert ok.all(axis=1).mean() >= 0.99
        assert ref.mean() > 0 and abs(got.mean() - ref.mean()) <= 1e-3 * ref.mean()


# ---------------------------------------------------------------- the backend
def test_backend_wide_pack_keeps_host_motion_and_tlas(monkeypatch):
    """TorchBackend on a 16-wide pack: a motion sync takes the host repack
    (the TLAS refit plan is 8-wide), and with the card gate forced open the
    host route keeps the host TLAS collapse (the device builder is 8-wide);
    the frames equal the 8-wide pack's device routes'."""
    from tests import test_torch_device_motion as dm
    from rfw_tpu_torch.render import torch_backend as tb

    built = {"n": 0}
    real_build = tb.build_tlas8_device

    def counted(*a, **k):
        built["n"] += 1
        return real_build(*a, **k)

    monkeypatch.setattr(tb, "build_tlas8_device", counted)
    monkeypatch.setattr(tb, "_on_card", lambda device: True)
    rng = np.random.default_rng(3)
    start = [(float(x), float(y)) for x, y in rng.uniform(-3, 6, (64, 2))]
    moved = [(x + 0.3, y - 0.2) for x, y in start]
    frames = {}
    for a in (8, 16):
        monkeypatch.setenv("RFW_WIDE_ARITY", str(a))
        repacks = dm._count_repacks(monkeypatch)
        for device_motion in (True, False):
            be = dm._backend(True, device_motion=device_motion)
            dm._feed(be, dm._instances(start))
            dm._move(be, dm._instances(moved))
            assert be._scene_host.tlas8_code.shape[1] == a
            frames[a, device_motion] = dm._render(be)
            if a == 16:
                assert be._motion is None and be._dyn is None
                assert torch.equal(be._scene_dev.tlas8_code,
                                   torch.from_numpy(be._scene_host.tlas8_code))
        assert repacks["n"] == (2 if a == 16 else 1)  # the 8-wide device route: none
    assert built["n"] == 1  # the 8-wide host route's
    for key in ((16, True), (16, False), (8, False)):
        assert np.array_equal(frames[key], frames[8, True]), key


def test_backend_wide_pack_keeps_host_dynamics(monkeypatch):
    """A skin pose sync on a 16-wide pack takes the host repack (the refit
    plans are 8-wide); its frame is within 1 of the 8-wide device route's."""
    from rfw_tpu.backend.structs import SkinView
    from rfw_tpu.scene.camera import Camera3D
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings
    from tests import test_torch_dynamics_backend as dyn
    from tests.test_skinning import _quad_mesh, _rot_x

    mesh = _quad_mesh()
    cam = Camera3D(fov=60).look_at(np.array([0.5, 2.0, 0.6], np.float32),
                                   np.array([0.5, 0.0, -0.5], np.float32))
    frames = {}
    for a in (8, 16):
        monkeypatch.setenv("RFW_WIDE_ARITY", str(a))
        be = TorchBackend(32, 32, dyn._settings(TorchSettings), device="cpu")
        dyn._call(be, "set_3d_meshes", [(0, mesh)])
        rest = SkinView(joint_matrices=np.eye(4, dtype=np.float32)[None])
        dyn._call(be, "set_skins", [(0, rest)])
        dyn._call(be, "set_3d_instances", [(0, dyn._skin_instance(mesh))])
        be.synchronize()
        before = be._scene_host
        dyn._call(be, "set_skins", [(0, SkinView(joint_matrices=_rot_x(-90.0)[None]))])
        be.synchronize()
        if a == 16:
            assert be._dyn is None and be._scene_host is not before
            assert be._scene_host.blas8_code.shape[1] == 16
        else:
            dyn.assert_device_route(be, before)
        frames[a] = dyn._render(be, cam, w=32, h=32).astype(int)
    assert np.abs(frames[16] - frames[8]).max() <= 1
