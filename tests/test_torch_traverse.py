"""Two-level traversal: the port's prepared layout, its plain walk and (on
a card) its CUDA kernel, against rfw_tpu's Pallas kernel in interpret mode
and against the brute-force oracle.

Tolerances:
  * hit masks and occlusion flags: exact;
  * t vs the brute-force oracle: rtol 1e-5 plus atol 2e-6, a few float32
    ulps at the scene's coordinate magnitude (Woop affine vs
    Möller-Trumbore);
  * t vs the Pallas kernel: rtol 3e-5 — its t uses an approximate
    reciprocal refined by one Newton step, which in interpret mode is off by
    up to 1.5e-5 relative;
  * prim and inst: equal where t is unique (no other hit within 1e-6
    relative in the oracle), since exact-t ties may fall either way;
  * u, v: atol 1e-4 vs the oracle, atol 2e-3 vs the Pallas kernel (its t
    error times the ray's travel in unit-triangle coordinates);
  * the CUDA kernel vs the plain walk (both round every operation alike;
    the kernel writes its re-base and leaf test with unfused
    round-to-nearest intrinsics; its walk takes children nearest first):
    K2's flags identical; K1 with identical hit masks, t bit-identical
    where both hit (at most 1 in 10^5 rays may differ, within 1e-5
    relative: a box dropped at the rounding edge), and prim, inst, u, v
    bit-identical except on an exact-t tie with another triangle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch.convert import from_numpy_scene
from rfw_tpu_torch.ops import traverse as tr
from rfw_tpu_torch.render.intersect import brute_force_closest

R = 1024  # one Pallas program of rays


@pytest.fixture(scope="module")
def setup():
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        scene, mats, lights, atlas, _ = _torch_scene.build("rfw_tpu", seed=2)
    finally:
        mp.undo()
    tscene, _, _, _ = from_numpy_scene(scene, mats, lights, atlas, "cpu")
    ps = tr.prepare_scene(tscene)
    o, d = _torch_scene.probe_rays(R, seed=8)
    v0, e1, e2, ids = _torch_scene.world_triangles(scene)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    t_all = _all_hits(ot, dt, torch.from_numpy(v0), torch.from_numpy(e1), torch.from_numpy(e2))
    t_ref, j_ref, u_ref, v_ref = brute_force_closest(
        ot, dt, torch.from_numpy(v0), torch.from_numpy(e1), torch.from_numpy(e2))
    p_ref = torch.where(j_ref >= 0, torch.from_numpy(ids)[j_ref.clamp(min=0).long()], -1)
    # a ray's closest t is unique when no second hit lies within 1e-6 of it
    second = torch.sort(t_all, dim=1).values[:, 1]
    unique = (second - t_ref) > 1e-6 * t_ref
    return dict(scene=scene, ps=ps, o=ot, d=dt, t=t_ref, prim=p_ref, u=u_ref,
                v=v_ref, unique=unique)


def _all_hits(o, d, v0, e1, e2):
    """(R, T) t of every hit (inf where none): the oracle's tie detector."""
    pvec = torch.linalg.cross(d[:, None, :].expand(-1, v0.shape[0], -1),
                              e2[None].expand(o.shape[0], -1, -1), dim=-1)
    det = torch.sum(e1[None] * pvec, -1)
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o[:, None, :] - v0[None]
    u = torch.sum(tvec * pvec, -1) * inv
    q = torch.linalg.cross(tvec, e1[None].expand(o.shape[0], -1, -1), dim=-1)
    v = torch.sum(d[:, None, :] * q, -1) * inv
    t = torch.sum(e2[None] * q, -1) * inv
    hit = ok & (u >= -1e-7) & (v >= -1e-7) & (u + v <= 1 + 1e-7) & (t > 1e-5)
    return torch.where(hit, t, float("inf"))


@pytest.fixture(scope="module")
def pallas(setup):
    from rfw_tpu.ops import pallas_closest_hit, pallas_occluded, prepare_pallas_scene
    from rfw_tpu.render.pack import TraceScene

    jps = prepare_pallas_scene(TraceScene(*[jnp.asarray(x) for x in setup["scene"]]))
    o, d = jnp.asarray(setup["o"].numpy()), jnp.asarray(setup["d"].numpy())
    hit = pallas_closest_hit(jps, o, d, interpret=True)
    occ = pallas_occluded(jps, o, d, 1e30, interpret=True)
    return jps, hit, np.asarray(occ)


def test_prepared_layout_matches_pallas_scene(setup, pallas):
    """Node rows, Woop slots and instance rows hold exactly the Pallas
    kernel's (rows, lanes) transposed columns."""
    ps, jps = setup["ps"], pallas[0]
    S = ps.nodes.shape[0]
    assert np.array_equal(np.asarray(jps.scene_t).T[:S], ps.nodes.numpy())
    assert not np.asarray(jps.scene_t).T[S:].any()
    n_rows = ps.tris.shape[0]
    tri = np.asarray(jps.tri_t).reshape(64, -1, 16).transpose(1, 0, 2).reshape(-1, 16)
    assert np.array_equal(tri[:n_rows], ps.tris.numpy())
    inst = np.asarray(jps.inst_t).T
    assert np.array_equal(inst[:ps.insts.shape[0]], ps.insts.numpy())
    assert ps.tlas_root == jps.tlas_root and ps.n_inst == jps.n_inst
    assert np.array_equal(np.asarray(jps.root_t)[0, :ps.roots.shape[0]], ps.roots.numpy())
    # what the two-phase kernels read: world instance boxes (arena rows,
    # padding inverted) and each instance's treelet range
    assert np.array_equal(np.asarray(jps.inst_box_min), ps.inst_min.numpy())
    assert np.array_equal(np.asarray(jps.inst_box_max), ps.inst_max.numpy())
    assert np.array_equal(np.asarray(jps.tlo_t)[0, :ps.tlo.shape[0]], ps.tlo.numpy())
    assert np.array_equal(np.asarray(jps.thi_t)[0, :ps.thi.shape[0]], ps.thi.numpy())
    assert (ps.thi > ps.tlo).sum() == int((setup["scene"].inst_mesh >= 0).sum())


def test_plain_closest_vs_oracle(setup):
    h = tr.closest_hit(setup["ps"], setup["o"], setup["d"])
    hm, rm = h.prim >= 0, setup["prim"] >= 0
    assert torch.equal(hm, rm)
    assert int(hm.sum()) > R // 4
    both = hm & rm
    np.testing.assert_allclose(h.t[both].numpy(), setup["t"][both].numpy(),
                               rtol=1e-5, atol=2e-6)
    uq = both & setup["unique"]
    assert int(uq.sum()) > 0.9 * int(both.sum())
    assert torch.equal(h.prim[uq], setup["prim"][uq].to(torch.int32))
    np.testing.assert_allclose(h.u[uq].numpy(), setup["u"][uq].numpy(), atol=1e-4)
    np.testing.assert_allclose(h.v[uq].numpy(), setup["v"][uq].numpy(), atol=1e-4)
    assert (h.t[~hm] == 1e26).all() and (h.inst[~hm] == -1).all()


def test_plain_closest_vs_pallas_interpret(setup, pallas):
    _, jh, _ = pallas
    h = tr.closest_hit(setup["ps"], setup["o"], setup["d"])
    jm = np.asarray(jh.prim) >= 0
    hm = h.prim.numpy() >= 0
    assert np.array_equal(hm, jm)
    both = hm & jm
    np.testing.assert_allclose(h.t.numpy()[both], np.asarray(jh.t)[both], rtol=3e-5)
    uq = both & setup["unique"].numpy()
    assert np.array_equal(h.prim.numpy()[uq], np.asarray(jh.prim)[uq])
    assert np.array_equal(h.inst.numpy()[uq], np.asarray(jh.inst)[uq])
    np.testing.assert_allclose(h.u.numpy()[uq], np.asarray(jh.u)[uq], atol=2e-3)
    np.testing.assert_allclose(h.v.numpy()[uq], np.asarray(jh.v)[uq], atol=2e-3)


def test_plain_occluded(setup, pallas):
    occ = tr.occluded(setup["ps"], setup["o"], setup["d"], 1e30)
    assert torch.equal(occ, setup["prim"] >= 0)
    assert np.array_equal(occ.numpy(), pallas[2])


@pytest.mark.parametrize("scale", [0.25, 0.5, 0.999, 1.001])
def test_plain_occluded_t_limit(setup, scale):
    """Occlusion counts only hits inside (T_MIN, t_limit): a limit just past
    the closest hit occludes, any shorter one does not."""
    hit = setup["prim"] >= 0
    tl = torch.where(hit, setup["t"] * scale, 50.0)
    occ = tr.occluded(setup["ps"], setup["o"], setup["d"], tl)
    closest = tr.closest_hit(setup["ps"], setup["o"], setup["d"], tl)
    assert torch.equal(occ, closest.prim >= 0)
    if scale > 1:
        assert torch.equal(occ, hit)
    elif scale < 0.999:
        assert not occ.any()


def test_cuda_wrapper_rejects_other_devices(setup):
    """A tensor on neither the CPU nor a CUDA device raises: the wrapper
    never falls back to the plain walk."""
    o = setup["o"].to("meta")
    with pytest.raises(ValueError):
        tr.closest_hit(setup["ps"], o, o)
    with pytest.raises(ValueError):
        tr.occluded(setup["ps"], o, o, 1.0)


def test_kernel_matches_plain_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ps = tr.PreparedScene(*[x.cuda() if isinstance(x, torch.Tensor) else x
                            for x in setup["ps"]])
    o, d = setup["o"].cuda(), setup["d"].cuda()
    before = dict(tr.LAUNCHES)
    k = tr.closest_hit(ps, o, d)
    p = tr.closest_hit_plain(ps, o, d)
    km, pm = k.prim >= 0, p.prim >= 0
    assert torch.equal(km, pm)
    both = km & pm
    same_t = k.t.view(torch.int32) == p.t.view(torch.int32)
    diff = both & ~same_t
    assert int(diff.sum()) <= R // 100000
    rel = (k.t - p.t).abs() / p.t.abs()
    assert not bool(diff.any()) or float(rel[diff].max()) <= 1e-5
    tie = both & same_t & ((k.prim != p.prim) | (k.inst != p.inst))
    keep = ~tie & ~diff
    for a, b in zip(k, p):
        assert torch.equal(a[keep], b[keep])
    tl = torch.full((R,), 3.0, device="cuda")
    assert torch.equal(tr.occluded(ps, o, d, tl), tr.occluded_plain(ps, o, d, tl))
    assert tr.LAUNCHES["closest"] == before["closest"] + 1
    assert tr.LAUNCHES["occluded"] == before["occluded"] + 1
