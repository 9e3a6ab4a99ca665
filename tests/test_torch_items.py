"""Two-phase traversal, phase B and the whole call: the port's
twophase_closest_with_fallback / twophase_occluded_with_fallback (plain
versions of K3/K5/K6 and K4 on the CPU) against rfw_tpu's with its Pallas
kernels in interpret mode, and against the brute-force oracle; on a card,
each kernel against its plain version.

Routes: phase A by the dense scan or by the tree walk (DENSE_A_MAX_INST
forced to 0 in both packages), phase B by the walk alone or with the dense
items tier (DENSE_MAX_TRIS forced to 64 in both packages, so the one-treelet
quads take the dense tier and the two-treelet spheres the walk). K=2 makes
many rays truncate, so the fallback retrace runs.

Tolerances:
  * hit masks and occlusion flags: exact;
  * t vs the Pallas kernels: rtol 3e-5 (their approximate reciprocal
    refined by one Newton step is off by up to 1.5e-5 relative in
    interpret mode); vs the oracle: rtol 1e-5 plus atol 2e-6;
  * prim and inst: equal where t is unique (no other hit within 1e-6
    relative in the oracle); u, v: atol 2e-3 vs the Pallas kernels, 1e-4
    vs the oracle, where t is unique;
  * the two phase-B tiers against each other: identical; K5 and K6 against
    their plain versions: identical; K3, which takes children nearest first
    where the plain walk keeps the TPU's order, against its plain version:
    hit masks identical, t bit-identical (at most 1 in 10^5 live items may
    differ, within 1e-5 relative, where a box is dropped at the rounding
    edge: none at this size), prim/inst/u/v identical but on exact-t ties,
    empty slots identical in every output.
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

R = 512
K = 2
ROUTES = [("dense_scan", "walk"), ("dense_scan", "dense"), ("tree", "walk"), ("tree", "dense")]


@pytest.fixture(scope="module")
def setup():
    from rfw_tpu.ops import prepare_pallas_scene
    from rfw_tpu.render.pack import TraceScene as JScene

    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        scene, mats, lights, atlas, _ = _torch_scene.build("rfw_tpu", seed=4, n_inst=6)
    finally:
        mp.undo()
    tscene = from_numpy_scene(scene, mats, lights, atlas, "cpu")[0]
    o, d = _torch_scene.probe_rays(R, seed=11)
    rng = np.random.default_rng(5)
    tl = rng.uniform(4.0, 16.0, R).astype(np.float32)
    tl[::9] = 0.0  # dead lanes
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    v0, e1, e2, ids = (torch.from_numpy(x) for x in _torch_scene.world_triangles(scene))
    t_ref, j_ref, u_ref, v_ref = brute_force_closest(ot, dt, v0, e1, e2)
    # the closest hit overall is the closest within t_limit, if it is below it
    j_ref = torch.where(t_ref < torch.from_numpy(tl), j_ref, -1)
    prim_ref = torch.where(j_ref >= 0, ids[j_ref.clamp(min=0).long()], -1)
    t_all = _all_hits(ot, dt, v0, e1, e2)
    second = torch.sort(torch.where(t_all < torch.from_numpy(tl)[:, None], t_all,
                                    float("inf")), dim=1).values[:, 1]
    unique = (second - t_ref) > 1e-6 * t_ref
    return dict(scene=scene, jps=prepare_pallas_scene(JScene(*[jnp.asarray(x) for x in scene])),
                ps=tr.prepare_scene(tscene), o=o, d=d, tl=tl, ot=ot, dt=dt,
                tlt=torch.from_numpy(tl), t=t_ref, prim=prim_ref, u=u_ref, v=v_ref,
                unique=unique)


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


@pytest.fixture
def route(request, monkeypatch):
    """Force phase A's and phase B's route in both packages."""
    from rfw_tpu.ops import traverse_items as jti

    phase_a, phase_b = request.param
    if phase_a == "tree":
        monkeypatch.setattr(ti, "DENSE_A_MAX_INST", 0)
        monkeypatch.setattr(jti, "DENSE_A_MAX_INST", 0)
    if phase_b == "dense":
        monkeypatch.setattr(ti, "DENSE_MAX_TRIS", 64)
        monkeypatch.setattr(jti, "DENSE_MAX_TRIS", 64)
    return phase_b == "dense"


def _jax_kw(setup, dense):
    return dict(K=K, n_inst_static=setup["scene"].inst_matrix.shape[0], interpret=True,
                dense=dense)


@pytest.mark.parametrize("route", ROUTES, indirect=True, ids="-".join)
def test_closest_with_fallback_matches_jax_and_oracle(setup, route):
    from rfw_tpu.ops.traverse_items import twophase_closest_with_fallback as jcall

    _, trunc = ti.twophase_closest_fused(setup["ps"], setup["ot"], setup["dt"], setup["tlt"],
                                         K=K, dense=route)
    assert int(trunc.sum()) > R // 20  # the fallback runs
    h = ti.twophase_closest_with_fallback(setup["ps"], setup["ot"], setup["dt"], setup["tlt"],
                                          K=K, dense=route)
    j = jcall(setup["jps"], jnp.asarray(setup["o"]), jnp.asarray(setup["d"]),
              jnp.asarray(setup["tl"]), **_jax_kw(setup, route))
    hm = h.prim.numpy() >= 0
    assert np.array_equal(hm, np.asarray(j.prim) >= 0)
    assert np.array_equal(hm, setup["prim"].numpy() >= 0)
    assert hm.sum() > R // 4
    np.testing.assert_allclose(h.t.numpy()[hm], np.asarray(j.t)[hm], rtol=3e-5)
    np.testing.assert_allclose(h.t.numpy()[hm], setup["t"].numpy()[hm], rtol=1e-5, atol=2e-6)
    uq = hm & setup["unique"].numpy()
    assert uq.sum() > 0.9 * hm.sum()
    for name, tol in (("prim", None), ("inst", None), ("u", 2e-3), ("v", 2e-3)):
        a, b = getattr(h, name).numpy()[uq], np.asarray(getattr(j, name))[uq]
        if tol is None:
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(a, b, atol=tol, err_msg=name)
    assert np.array_equal(h.prim.numpy()[uq], setup["prim"].numpy()[uq])
    np.testing.assert_allclose(h.u.numpy()[uq], setup["u"].numpy()[uq], atol=1e-4)
    np.testing.assert_allclose(h.v.numpy()[uq], setup["v"].numpy()[uq], atol=1e-4)
    # dead lanes: misses at t 0
    assert (h.prim.numpy()[::9] == -1).all() and (h.t.numpy()[::9] == 0).all()


@pytest.mark.parametrize("route", ROUTES[1:3], indirect=True, ids="-".join)
def test_occluded_with_fallback_matches_jax(setup, route):
    from rfw_tpu.ops.traverse_items import twophase_occluded_with_fallback as jcall

    occ = ti.twophase_occluded_with_fallback(setup["ps"], setup["ot"], setup["dt"],
                                             setup["tlt"], K=K, dense=route)
    j = jcall(setup["jps"], jnp.asarray(setup["o"]), jnp.asarray(setup["d"]),
              jnp.asarray(setup["tl"]), **_jax_kw(setup, route))
    assert np.array_equal(occ.numpy(), np.asarray(j))
    assert torch.equal(occ, tr.occluded(setup["ps"], setup["ot"], setup["dt"], setup["tlt"]))
    assert 0 < int(occ.sum()) < R and not occ[::9].any()


@pytest.mark.parametrize("route", ROUTES[1:2], indirect=True, ids="-".join)
def test_fused_flags_match_jax(setup, route):
    """Without capacity drops (items_per_ray 4), the truncated and
    undecided flags are the reference's. A truncated flag compares the hit
    t with the last kept entry t, so it may differ where the two lie within
    the t tolerance of each other (a hit on a flat box's face)."""
    from rfw_tpu.ops.traverse_items import twophase_closest_fused as jclosest
    from rfw_tpu.ops.traverse_items import twophase_occluded_fused as joccluded

    args = (setup["ps"], setup["ot"], setup["dt"], setup["tlt"])
    jargs = (setup["jps"], jnp.asarray(setup["o"]), jnp.asarray(setup["d"]),
             jnp.asarray(setup["tl"]))
    h, trunc = ti.twophase_closest_fused(*args, K=K, items_per_ray=4.0, dense=route)
    _, jtrunc = jclosest(*jargs, items_per_ray=4.0, **_jax_kw(setup, route))
    ents = ti._phase_a(setup["ps"], *args[1:], K)
    near = (h.t - ents.t_entry[:, K - 1]).abs() <= 3e-5 * h.t.abs()
    differ = trunc.numpy() != np.asarray(jtrunc)
    assert not (differ & ~near.numpy()).any() and differ.sum() < trunc.sum() / 4
    occ, und = ti.twophase_occluded_fused(*args, K=K, items_per_ray=4.0, dense=route)
    jocc, jund = joccluded(*jargs, items_per_ray=4.0, **_jax_kw(setup, route))
    assert np.array_equal(occ.numpy(), np.asarray(jocc))
    assert np.array_equal(und.numpy(), np.asarray(jund)) and und.any()


@pytest.mark.parametrize("n", [0, 1])
def test_tiny_batches_match_classic(setup, n):
    """No rays, or one, go through both two-phase calls and give the
    classic walk's result."""
    ps, o, d, tl = setup["ps"], setup["ot"][:n], setup["dt"][:n], setup["tlt"][:n]
    h = ti.twophase_closest_with_fallback(ps, o, d, tl, K=K)
    for a, b in zip(h, tr.closest_hit(ps, o, d, tl)):
        assert a.shape == (n,) and torch.equal(a, b)
    occ = ti.twophase_occluded_with_fallback(ps, o, d, tl, K=K)
    assert torch.equal(occ, tr.occluded(ps, o, d, tl))


def _items(setup):
    """Every (ray, instance) item of the rays' full entry lists, instance
    sorted, as phase B receives them."""
    from rfw_tpu_torch.render.twophase import dense_tlas_entries

    ps, K_all = setup["ps"], 8
    ents = dense_tlas_entries(ps.inst_min, ps.inst_max, setup["ot"], setup["dt"],
                              setup["tlt"], K=K_all)
    citem, _ = ti.compact_entries(ents.inst, R * K_all)
    slot_item, slot_inst = ti.pack_compact(citem, ents.inst.reshape(-1), ps.n_inst)
    rid = (slot_item.clamp(min=0) // K_all).long()
    tl = torch.where(slot_item >= 0, setup["tlt"][rid], float("-inf"))
    return slot_inst, setup["ot"][rid].contiguous(), setup["dt"][rid].contiguous(), tl


def test_dense_tier_matches_walk(setup):
    """Each item's hit through the dense items tier (every treelet of its
    mesh) is its hit through the BLAS walk; empty items miss."""
    ps = setup["ps"]
    inst, o, d, tl = _items(setup)
    walk = ti.items_plain(ps, inst, o, d, tl, any_hit=False)
    dense = ti.dense_items_plain(ps, inst, o, d, tl, any_hit=False)
    assert torch.equal(walk.t, dense.t)
    hm = walk.prim >= 0
    assert torch.equal(hm, dense.prim >= 0) and hm.sum() > 0
    assert torch.equal(walk.inst, dense.inst)
    same = walk.prim == dense.prim
    assert same.float().mean() > 0.99  # exact-t ties between treelets may differ
    assert torch.equal(walk.u[same], dense.u[same]) and torch.equal(walk.v[same], dense.v[same])
    assert torch.equal(ti.items_plain(ps, inst, o, d, tl, any_hit=True),
                       ti.dense_items_plain(ps, inst, o, d, tl, any_hit=True))
    empty = inst < 0
    assert empty.any() and (walk.prim[empty] == -1).all() and (dense.inst[empty] == -1).all()


def _assert_nearest_gate(k, p, live):
    """K3's gate against the plain walk (see the module docstring)."""
    assert torch.equal(k.prim >= 0, p.prim >= 0)
    t_diff = (k.t.view(torch.int32) != p.t.view(torch.int32)) & live
    assert int(t_diff.sum()) <= int(live.sum()) // 100000
    assert bool(((k.t - p.t).abs() <= 1e-5 * p.t.abs())[t_diff].all())
    same_t = ~t_diff
    tie = same_t & ((k.prim != p.prim) | (k.inst != p.inst))
    for a, b in zip(k, p):
        assert torch.equal(a[same_t & ~tie], b[same_t & ~tie])
        assert torch.equal(a[~live], b[~live])


def test_items_kernels_match_plain_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode; chip_smoke.py "
                    "phases 7-8 (compare_items) make this check on the card")
    ps = tr.PreparedScene(*[x.cuda() if isinstance(x, torch.Tensor) else x
                            for x in setup["ps"]])
    inst, o, d, tl = (x.cuda() for x in _items(setup))
    live = inst >= 0
    before = dict(ti.LAUNCHES)
    _assert_nearest_gate(ti.items(ps, inst, o, d, tl, False),
                         ti.items_plain(ps, inst, o, d, tl, False), live)
    assert torch.equal(ti.items(ps, inst, o, d, tl, True), ti.items_plain(ps, inst, o, d, tl, True))
    k, p = ti.dense_items(ps, inst, o, d, tl, False), ti.dense_items_plain(ps, inst, o, d, tl, False)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(ti.dense_items(ps, inst, o, d, tl, True),
                       ti.dense_items_plain(ps, inst, o, d, tl, True))
    assert all(ti.LAUNCHES[k] == before[k] + 1 for k in ti.LAUNCHES)
