"""The per-treelet tables of the dense items tier (`prepare_scene`'s tbox
and tcount) and the culling rule of the K6 kernel, on the CPU.

The K6 kernel (`csrc/traverse_items.cu::dense_items_kernel`) tests, per
item, the treelets of its mesh in order, skips a treelet whose box the ray
misses or enters at or past the best hit so far, and tests a surviving
treelet's real slots only. Its plain version `dense_items_plain` (the TPU
kernel's work) tests all 64 slots of every treelet. `culled_items` below
is a torch emulation of the kernel's loop, in its arithmetic; the tests
hold the tables against the BLAS leaves they come from, and the emulation
against the plain version.

Scene: `tests/_torch_scene.py` with quality-2 icospheres (6 treelets a
mesh, 320 real slots of 384), so the cull has treelets to skip.

Tolerances: none; tables, results and counts are compared exactly.
"""

import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch.accel.bvh_cpu import TREELET
from rfw_tpu_torch.convert import to_tensor
from rfw_tpu_torch.ops import traverse as tr
from rfw_tpu_torch.ops import traverse_items as ti
from rfw_tpu_torch.render.intersect import Hit, T_MAX, T_MIN
from rfw_tpu_torch.render.pack import TraceScene
from rfw_tpu_torch.render.twophase import dense_tlas_entries

R = 256
K = 4


@pytest.fixture(scope="module")
def setup():
    scene = _torch_scene.build("rfw_tpu_torch", seed=4, n_inst=6, quality=2)[0]
    ps = tr.prepare_scene(TraceScene(*[to_tensor(getattr(scene, f), "cpu")
                                       for f in TraceScene._fields]))
    o, d = (torch.from_numpy(x) for x in _torch_scene.probe_rays(R, seed=21))
    tl = torch.from_numpy(np.random.default_rng(8).uniform(2.0, 14.0, R).astype(np.float32))
    tl[::7] = 0.0  # dead lanes
    # every (ray, instance) item of the rays' entry lists, instance sorted,
    # as phase B receives them; empty slots last
    ents = dense_tlas_entries(ps.inst_min, ps.inst_max, o, d, tl, K=K)
    citem, _ = ti.compact_entries(ents.inst, R * K)
    slot_item, slot_inst = ti.pack_compact(citem, ents.inst.reshape(-1), ps.n_inst)
    rid = (slot_item.clamp(min=0) // K).long()
    tl_s = torch.where(slot_item >= 0, tl[rid], float("-inf"))
    items = (slot_inst, o[rid].contiguous(), d[rid].contiguous(), tl_s)
    return dict(scene=scene, ps=ps, items=items)


def _leaves(ps):
    """(treelet, count, box (6,)) of every BLAS leaf child, decoded as the
    walk decodes a leaf."""
    boxes, codes, cnts = (x.numpy() for x in tr.node_arrays(ps))
    out = []
    for n in range(ps.tlas_root):
        for c in range(8):
            code, cnt = int(codes[n, c]), int(cnts[n, c])
            if code >= 0 or cnt == 0:
                continue
            last = (-code - 1) + min(cnt - 1, TREELET - 1)
            out.append((last // TREELET, last % TREELET + 1, boxes[n, c]))
    return out


def _slab(b, obj):
    """The kernel's slab test of boxes b (n, 8) for object-space rays obj
    (six (n,) tensors): (hit, tn)."""
    ox, oy, oz, dx, dy, dz = obj
    inv = (tr._safe_inv(dx), tr._safe_inv(dy), tr._safe_inv(dz))
    bx = torch.stack([b[:, 0], b[:, 1], b[:, 2], b[:, 4], b[:, 5], b[:, 6]], 1)[:, None]
    tn, tf = tr._child_slab(bx, 0, (ox, oy, oz), inv)
    return (tn <= tf) & (tf > T_MIN), tn


def culled_items(ps, item_inst, ray_o, ray_d, t_limit, any_hit):
    """Torch emulation of the K6 kernel's loop: per item, the treelets of
    its mesh's range in order; a treelet no leaf names, or whose box test
    fails, or whose entry t is not below the best hit so far, is skipped;
    a surviving treelet's tcount slots are tested, a later treelet's hit
    must be strictly nearer; any hit stops at the first hit. Returns
    (result, WalkStats) with the kernel's per-item counts."""
    C = ray_o.shape[0]
    i32 = torch.int32
    t_best = torch.clamp(t_limit.clone(), max=T_MAX)
    prim = torch.full((C,), -1, dtype=i32)
    hit_inst = torch.full((C,), -1, dtype=i32)
    hit_u, hit_v = torch.zeros(C), torch.zeros(C)
    occ = torch.zeros(C, dtype=torch.bool)
    counts = tr.WalkStats(*(torch.zeros(C, dtype=i32) for _ in range(4)))
    inst = item_inst.to(i32)
    valid = inst >= 0
    iid = torch.clamp(inst, 0, max(ps.n_inst - 1, 0)).long()
    lo = torch.where(valid, ps.tlo[iid], 0)
    span = torch.where(valid, ps.thi[iid] - lo, 0)
    obj = tr._rebase(ps, inst, ray_o, ray_d)
    n_treelets = ps.tris.shape[0] // TREELET
    for j in range(int(span.max()) if C else 0):
        tt = (lo + j).clamp(max=max(n_treelets - 1, 0)).long()
        take = (j < span) & (lo + j < n_treelets)
        if any_hit:
            take &= ~occ
        cnt = ps.tcount[tt]
        take &= cnt > 0
        counts.boxes.add_(take.to(i32))
        hit_box, tn = _slab(ps.tbox[tt], obj)
        take &= hit_box & (tn < t_best)
        counts.leaves.add_(take.to(i32))
        counts.tris.add_(torch.where(take, cnt, 0))
        sel = take.nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        first = (tt[sel] << tr.TSHIFT).to(i32)
        tcur = t_best[sel]
        ok, t, u, v = tr._leaf_slots(ps.tris, first, cnt[sel], tuple(x[sel] for x in obj), tcur)
        if any_hit:
            occ[sel[ok.any(dim=1)]] = True
            continue
        score = torch.where(ok, t, float("inf"))
        win = torch.argmin(score, dim=1)
        tmin = score.gather(1, win[:, None])[:, 0]
        hit = tmin < tcur
        hs, wsel = sel[hit], win[hit, None]
        t_best[hs] = tmin[hit]
        prim[hs] = (first[hit] + win[hit]).to(i32)
        hit_inst[hs] = inst[hs]
        hit_u[hs] = u[hit].gather(1, wsel)[:, 0]
        hit_v[hs] = v[hit].gather(1, wsel)[:, 0]
    return (occ if any_hit else Hit(t_best, prim, hit_inst, hit_u, hit_v)), counts


def test_tcount_and_tbox_are_each_leafs(setup):
    """tcount is each BLAS leaf's slot count and tbox its box, every
    treelet named by at most one leaf; the other treelets are 0."""
    ps = setup["ps"]
    leaves = _leaves(ps)
    named = [t for t, _, _ in leaves]
    assert len(named) == len(set(named)) and len(named) > 0
    tcount, tbox = ps.tcount.numpy(), ps.tbox.numpy()
    assert tcount.shape == (ps.tris.shape[0] // TREELET,) and tbox.shape == (tcount.shape[0], 8)
    for t, count, box in leaves:
        assert tcount[t] == count
        assert np.array_equal(tbox[t], np.array([*box[:3], 0, *box[3:], 0], np.float32))
    others = np.setdiff1d(np.arange(tcount.shape[0]), named)
    assert (tcount[others] == 0).all() and (tbox[others] == 0).all()


def test_padding_slots_are_zero_rows(setup):
    """Every slot of a treelet past its tcount is an all-zero Woop row
    (t = NaN: it never passes), so the kernel may skip it."""
    ps = setup["ps"]
    rows = ps.tris.reshape(-1, TREELET, 16)
    slot = torch.arange(TREELET)[None, :, None]
    pad = slot >= ps.tcount[:, None, None]
    assert bool((rows.masked_select(pad) == 0).all())
    real = rows[:, :, :12].abs().sum(dim=2) > 0
    assert torch.equal(real.sum(dim=1).to(torch.int32), ps.tcount)
    # the quality-2 spheres: 320 real slots in 6 treelets
    assert int(ps.tcount[:6].sum()) == 320 and bool((ps.tcount[:6] > 0).all())


def test_mesh_ranges_are_named_by_leaves(setup):
    """The treelets in [tlo, thi) of a present instance are exactly those
    the leaves of that instance's BLAS name (reached from its root)."""
    ps, scene = setup["ps"], setup["scene"]
    _, codes, cnts = (x.numpy() for x in tr.node_arrays(ps))
    present = np.nonzero(scene.inst_mesh >= 0)[0]
    assert present.size > 0
    for i in present:
        named, todo = set(), [int(ps.roots[i])]
        while todo:
            n = todo.pop()
            for c in range(8):
                code, cnt = int(codes[n, c]), int(cnts[n, c])
                if code >= 0:
                    todo.append(code)
                elif cnt > 0:
                    named.add(((-code - 1) + min(cnt - 1, TREELET - 1)) // TREELET)
        lo, hi = int(ps.tlo[i]), int(ps.thi[i])
        assert hi > lo and named == set(range(lo, hi)), i
        assert bool((ps.tcount[lo:hi] > 0).all()), i


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_winning_treelet_passes_the_cull(setup, any_hit):
    """For every item, the treelet where dense_items_plain finds its hit
    (closest: the winner; any hit: the first treelet with a hit below
    t_limit) passes the kernel's cull: its box test in the kernel's
    arithmetic, with tn below the best hit at that point of the treelet
    order."""
    ps, (inst, o, d, tl) = setup["ps"], setup["items"]
    ref = ti.dense_items_plain(ps, inst, o, d, tl, any_hit)
    obj = tr._rebase(ps, inst, o, d)
    C = inst.shape[0]
    valid = inst >= 0
    iid = torch.clamp(inst, 0, ps.n_inst - 1).long()
    lo = torch.where(valid, ps.tlo[iid], 0)
    span = torch.where(valid, ps.thi[iid] - lo, 0)
    best = torch.clamp(tl.clone(), max=T_MAX)
    found = torch.zeros(C, dtype=torch.bool)
    checked = 0
    for j in range(int(span.max())):
        tt = (lo + j).long()
        live = (j < span) & ~found
        first = (tt << tr.TSHIFT).to(torch.int32)
        full = torch.full((C,), TREELET, dtype=torch.int32)
        ok, t, _, _ = tr._leaf_slots(ps.tris, first, full, obj, best)
        tmin = torch.where(ok, t, float("inf")).amin(dim=1)
        if any_hit:
            here = live & ok.any(dim=1)
        else:
            here = live & (ref.prim >= 0) & ((ref.prim >> tr.TSHIFT) == tt.to(torch.int32))
        hit_box, tn = _slab(ps.tbox[tt], obj)
        assert bool((hit_box & (tn < best) & (ps.tcount[tt] > 0))[here].all()), j
        checked += int(here.sum())
        if any_hit:
            found |= here
        else:
            best = torch.where((j < span) & (tmin < best), tmin, best)
    assert checked == int(ref.sum() if any_hit else (ref.prim >= 0).sum()) and checked > 0


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_culled_loop_matches_plain(setup, any_hit):
    """The emulated kernel loop gives dense_items_plain's result bit for
    bit, with fewer slot tests: its box tests are the named treelets it
    reaches, its slot tests the real slots of the treelets that pass."""
    ps, (inst, o, d, tl) = setup["ps"], setup["items"]
    got, counts = culled_items(ps, inst, o, d, tl, any_hit)
    stats = {}
    ref = ti.dense_items_plain(ps, inst, o, d, tl, any_hit, stats=stats)
    if any_hit:
        assert torch.equal(got, ref) and 0 < int(ref.sum()) < int((inst >= 0).sum())
    else:
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, ref))
        assert int((ref.prim >= 0).sum()) > 0
    pr = stats["per_ray"]
    assert bool((counts.tris <= pr.tris).all()) and bool((counts.leaves <= pr.leaves).all())
    assert int(counts.tris.sum()) < 0.6 * stats["tris"]
    assert bool((counts.leaves <= counts.boxes).all()) and not bool(counts.nodes.any())
    empty = inst < 0
    assert empty.any() and not any(bool(getattr(counts, k)[empty].any())
                                   for k in ("boxes", "leaves", "tris"))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_dense_items_stats_on_cpu_are_the_plain_versions(setup, any_hit):
    """dense_items(stats=True) on the CPU returns dense_items_plain's
    result and its per-item counts: every treelet of the mesh (up to the
    first hit for any hit), 64 slot tests each, no node visit or box
    test, nothing for an empty slot."""
    ps, (inst, o, d, tl) = setup["ps"], setup["items"]
    out, ws = ti.dense_items(ps, inst, o, d, tl, any_hit, stats=True)
    stats = {}
    ref = ti.dense_items_plain(ps, inst, o, d, tl, any_hit, stats=stats)
    assert torch.equal(out, ref) if any_hit else all(
        torch.equal(a, b) for a, b in zip(out, ref))
    assert ws.warp_ns is None
    assert not bool(ws.nodes.any()) and not bool(ws.boxes.any())
    assert torch.equal(ws.tris, TREELET * ws.leaves)
    assert int(ws.leaves.sum()) == stats["leaves"] and int(ws.tris.sum()) == stats["tris"]
    span = (ps.thi - ps.tlo)[inst.clamp(min=0).long()]
    live = inst >= 0
    if any_hit:
        assert bool((ws.leaves[live] <= span[live]).all())
    else:
        assert torch.equal(ws.leaves[live], span[live])
    assert not bool(ws.leaves[~live].any())
