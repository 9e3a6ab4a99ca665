"""Two-phase traversal, phase A and packing: the port's dense (R, I) scan,
its TLAS-walk kernel's plain version (and, on a card, the kernel), and the
item compaction and instance sort, against rfw_tpu on the same rays.

Tolerances:
  * entry t: rtol 1e-6 against the JAX dense scan and the jnp tree walk
    (the same slab arithmetic); rtol 1e-5 against the Pallas kernel in
    interpret mode, as rfw_tpu's own tests hold it against the jnp walk;
  * entry sets: per ray the (t, instance) pairs agree; an instance whose t
    equals the K-th kept t may differ, since `torch.topk`, `lax.top_k` and
    the walks' visit orders break equal t differently;
  * compaction and the instance sort: exact;
  * K4 on a card against its plain version, which keeps the TPU's visit
    order where the kernel takes children nearest first: t_entry
    bit-identical; per ray and per distinct t the same instance ids, but at
    a full list's K-th kept t, where another of several equal-t entries may
    be kept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch.convert import from_numpy_scene
from rfw_tpu_torch.ops import traverse as tr
from rfw_tpu_torch.ops import traverse_entries as te
from rfw_tpu_torch.ops import traverse_items as ti
from rfw_tpu_torch.render.twophase import dense_tlas_entries

R = 1024
K = 4


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
    o, d = _torch_scene.probe_rays(R, seed=9)
    rng = np.random.default_rng(3)
    tl = rng.uniform(2.0, 12.0, R).astype(np.float32)
    tl[::7] = 0.0  # dead lanes
    jscene = JScene(*[jnp.asarray(x) for x in scene])
    return dict(scene=scene, jscene=jscene, jps=prepare_pallas_scene(jscene),
                ps=tr.prepare_scene(tscene), o=o, d=d, tl=tl)


def _torch_rays(s):
    return torch.from_numpy(s["o"]), torch.from_numpy(s["d"]), torch.from_numpy(s["tl"])


def _assert_entries_match(got_t, got_i, ref_t, ref_i, rtol):
    got_t, got_i = np.asarray(got_t), np.asarray(got_i)
    ref_t, ref_i = np.asarray(ref_t), np.asarray(ref_i)
    assert got_t.shape == ref_t.shape == got_i.shape
    fin = np.isfinite(ref_t)
    assert np.array_equal(np.isfinite(got_t), fin)
    assert np.array_equal(got_i >= 0, fin)
    np.testing.assert_allclose(got_t[fin], ref_t[fin], rtol=rtol, atol=0)
    n = 0
    for r in range(got_t.shape[0]):
        k = int(fin[r].sum())
        if k == 0:
            continue
        last = ref_t[r, k - 1]
        # below the K-th kept t the pairs agree; at it, ties may swap
        keep = ref_t[r, :k] < last * (1 - rtol)
        gkeep = got_t[r, :k] < last * (1 - rtol)
        assert sorted(got_i[r, :k][gkeep]) == sorted(ref_i[r, :k][keep]), r
        n += k
    assert n > 0


def test_dense_entries_match_jax(setup):
    from rfw_tpu.render.twophase import dense_tlas_entries as jdense

    o, d, tl = _torch_rays(setup)
    ps = setup["ps"]
    got = dense_tlas_entries(ps.inst_min, ps.inst_max, o, d, tl, K=K)
    ref = jdense(jnp.asarray(setup["scene"].inst_aabb_min),
                 jnp.asarray(setup["scene"].inst_aabb_max),
                 jnp.asarray(setup["o"]), jnp.asarray(setup["d"]),
                 jnp.asarray(setup["tl"]), K=K)
    _assert_entries_match(got.t_entry, got.inst, ref.t_entry, ref.inst, 1e-6)
    assert not (got.inst.numpy()[::7] >= 0).any()


def test_dense_entries_chunked(setup, monkeypatch):
    """Ray chunks of the dense scan change nothing."""
    from rfw_tpu_torch.render import twophase

    o, d, tl = _torch_rays(setup)
    ps = setup["ps"]
    whole = dense_tlas_entries(ps.inst_min, ps.inst_max, o, d, tl, K=K)
    monkeypatch.setattr(twophase, "CHUNK_ELEMS", 7 * ps.inst_min.shape[0])
    parts = dense_tlas_entries(ps.inst_min, ps.inst_max, o, d, tl, K=K)
    assert torch.equal(whole.t_entry, parts.t_entry)
    assert torch.equal(whole.inst, parts.inst)


def test_tree_entries_plain_match_pallas_interpret(setup):
    from rfw_tpu.ops.traverse_entries import pallas_tlas_entries

    o, d, tl = _torch_rays(setup)
    got = te.tlas_entries(setup["ps"], o, d, tl, K=K)
    ref = pallas_tlas_entries(setup["jps"], jnp.asarray(setup["o"]), jnp.asarray(setup["d"]),
                              jnp.asarray(setup["tl"]), K=K, interpret=True)
    _assert_entries_match(got.t_entry, got.inst, ref.t_entry, ref.inst, 1e-5)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_tree_entries_plain_match_jnp_walk(setup, k):
    from rfw_tpu.render.twophase import tlas_entries as jwalk

    o, d, tl = _torch_rays(setup)
    got = te.tlas_entries(setup["ps"], o, d, tl, K=k)
    ref = jwalk(jnp.asarray(setup["scene"].tlas_wide_f), jnp.asarray(setup["scene"].tlas_wide_i),
                jnp.asarray(setup["o"]), jnp.asarray(setup["d"]), jnp.asarray(setup["tl"]), K=k)
    _assert_entries_match(got.t_entry, got.inst, ref.t_entry, ref.inst, 1e-6)
    dense = dense_tlas_entries(setup["ps"].inst_min, setup["ps"].inst_max, o, d, tl, K=k)
    _assert_entries_match(got.t_entry, got.inst, dense.t_entry, dense.inst, 1e-6)


@pytest.mark.parametrize("cap_per_ray", [4.0, 0.5])
def test_compact_entries_match_jax(setup, cap_per_ray):
    """Compaction into a buffer that holds every item, and into one that
    drops some (their rays overflow)."""
    from rfw_tpu.ops.traverse_items import _compact_entries

    o, d, tl = _torch_rays(setup)
    ents = dense_tlas_entries(setup["ps"].inst_min, setup["ps"].inst_max, o, d, tl, K=K)
    cap = int(R * cap_per_ray)
    citem, ovf = ti.compact_entries(ents.inst, cap)
    jc, jo = _compact_entries(jnp.asarray(ents.inst.numpy()), cap)
    assert np.array_equal(citem.numpy(), np.asarray(jc))
    assert np.array_equal(ovf.numpy(), np.asarray(jo))
    assert bool(ovf.any()) == (cap_per_ray < 1)


def test_pack_compact_matches_jax_and_is_stable(setup):
    from rfw_tpu.ops.traverse_items import _pack_compact

    o, d, tl = _torch_rays(setup)
    ps = setup["ps"]
    ents = dense_tlas_entries(ps.inst_min, ps.inst_max, o, d, tl, K=K)
    citem, _ = ti.compact_entries(ents.inst, 2 * R)
    flat = ents.inst.reshape(-1)
    slot_item, slot_inst = ti.pack_compact(citem, flat, ps.n_inst)
    n_inst = int(ps.n_inst)
    *_, sitem = _pack_compact(jnp.asarray(citem.numpy()), jnp.asarray(flat.numpy()),
                              n_inst, 2 * R + n_inst * 1024)
    assert np.array_equal(slot_item.numpy(), np.asarray(sitem))
    si, sn = slot_item.numpy(), slot_inst.numpy()
    valid = si >= 0
    assert valid.sum() == (flat >= 0).sum() and not valid[valid.sum():].any()
    assert np.array_equal(sn[valid], flat.numpy()[si[valid]])
    assert (np.diff(sn[valid]) >= 0).all()
    # stable: ray-major (ascending item index) inside each instance run
    same = np.diff(sn[valid]) == 0
    assert (np.diff(si[valid])[same] > 0).all()


def _ids_by_t(e):
    """Per ray, (t_entry, inst) with the ids ascending inside each run of
    equal t (the runs themselves stay in t order)."""
    by_id = torch.sort(e.inst, dim=1, stable=True)
    by_t = torch.sort(e.t_entry.gather(1, by_id.indices), dim=1, stable=True)
    return by_t.values, by_id.values.gather(1, by_t.indices)


def test_entries_kernel_matches_plain_on_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode; chip_smoke.py "
                    "phases 7-8 (compare_entries) make this check on the card")
    ps = tr.PreparedScene(*[x.cuda() if isinstance(x, torch.Tensor) else x
                            for x in setup["ps"]])
    o, d, tl = (x.cuda() for x in _torch_rays(setup))
    before = te.LAUNCHES["entries"]
    for k in (1, 6, 8):
        got = te.tlas_entries(ps, o, d, tl, K=k)
        ref = te.tlas_entries_plain(ps, o, d, tl, K=k)
        assert torch.equal(got.t_entry.view(torch.int32), ref.t_entry.view(torch.int32))
        assert torch.equal(got.inst >= 0, torch.isfinite(ref.t_entry))
        t, gi = _ids_by_t(got)
        _, ri = _ids_by_t(ref)
        kth = ref.t_entry[:, k - 1:k]
        at_kth = (t == kth) & torch.isfinite(kth)
        assert torch.equal(gi[~at_kth], ri[~at_kth])
    assert te.LAUNCHES["entries"] == before + 3
