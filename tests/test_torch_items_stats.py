"""Per-item counts of the two-phase walks (`items(..., stats=True)`, K3/K5)
and per-ray counts of the TLAS entries walk (`tlas_entries(...,
stats=True)`, K4), and the box nesting that K4's exactness rests on.

On the CPU the wrappers run the plain walks, so these cases hold their
counts against the plain walks' own totals; the cases marked by a card
check skip here (the kernels have no CPU mode). rfw_tpu's `stats=True`
counts while-iterations per Pallas program, so nothing here compares with
it.

Tolerances: none; counts, hits, flags and entries are compared exactly.
"""

import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch.convert import to_tensor
from rfw_tpu_torch.ops import traverse as tr
from rfw_tpu_torch.ops import traverse_entries as te
from rfw_tpu_torch.ops import traverse_items as ti
from rfw_tpu_torch.render.pack import TraceScene
from rfw_tpu_torch.render.twophase import dense_tlas_entries

R = 256
K = 4
KINDS = ("nodes", "boxes", "leaves", "tris")


@pytest.fixture(scope="module")
def setup():
    scene = _torch_scene.build("rfw_tpu_torch", seed=4, n_inst=6)[0]
    ps = tr.prepare_scene(TraceScene(*[to_tensor(getattr(scene, f), "cpu")
                                       for f in TraceScene._fields]))
    o, d = (torch.from_numpy(x) for x in _torch_scene.probe_rays(R, seed=12))
    tl = torch.from_numpy(np.random.default_rng(6).uniform(2.0, 12.0, R).astype(np.float32))
    tl[::7] = 0.0  # dead lanes
    # every (ray, instance) item of the rays' entry lists, instance sorted,
    # as phase B receives them; empty slots last
    ents = dense_tlas_entries(ps.inst_min, ps.inst_max, o, d, tl, K=K)
    citem, _ = ti.compact_entries(ents.inst, R * K)
    slot_item, slot_inst = ti.pack_compact(citem, ents.inst.reshape(-1), ps.n_inst)
    rid = (slot_item.clamp(min=0) // K).long()
    tl_s = torch.where(slot_item >= 0, tl[rid], float("-inf"))
    items = (slot_inst, o[rid].contiguous(), d[rid].contiguous(), tl_s)
    return dict(ps=ps, rays=(o, d, tl), items=items)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("any_hit", [False, True])
def test_items_stats_on_cpu_are_the_plain_walks(setup, any_hit):
    """items(stats=True) on the CPU returns items_plain's result and its
    per-item counts."""
    ps, (inst, o, d, tl) = setup["ps"], setup["items"]
    out, ws = ti.items(ps, inst, o, d, tl, any_hit, stats=True)
    counts = {}
    ref = ti.items_plain(ps, inst, o, d, tl, any_hit, stats=counts)
    assert _equal(out, ref) and _equal(out, ti.items(ps, inst, o, d, tl, any_hit))
    assert _equal(ws[:4], counts["per_ray"][:4]) and ws.warp_ns is None


@pytest.mark.parametrize("any_hit", [False, True])
def test_item_counts_sum_to_totals(setup, any_hit):
    ps, (inst, o, d, tl) = setup["ps"], setup["items"]
    counts = {}
    ti.items_plain(ps, inst, o, d, tl, any_hit, stats=counts)
    pr = counts["per_ray"]
    for k in KINDS:
        c = getattr(pr, k)
        assert c.dtype == torch.int32 and c.shape == inst.shape
        assert int(c.sum()) == counts[k], k
    live = inst >= 0
    assert bool((pr.nodes[live] >= 1).all())  # every item starts at its BLAS root
    assert bool((pr.boxes <= 8 * pr.nodes).all()) and bool((pr.tris <= 64 * pr.leaves).all())
    assert counts["tris"] > 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_empty_slots_count_zero(setup, any_hit):
    """An empty slot walks nothing: zero counts, the empty result."""
    ps, (inst, o, d, tl) = setup["ps"], setup["items"]
    out, ws = ti.items(ps, inst, o, d, tl, any_hit, stats=True)
    empty = inst < 0
    assert bool(empty.any())
    for k in KINDS:
        assert int(getattr(ws, k)[empty].abs().sum()) == 0, k
    if any_hit:
        assert not bool(out[empty].any())
    else:
        assert bool((out.prim[empty] == -1).all()) and bool((out.inst[empty] == -1).all())
        assert bool((out.t[empty] == float("-inf")).all())


@pytest.mark.parametrize("k", [1, K])
def test_entries_stats_on_cpu_are_the_plain_walks(setup, k):
    """tlas_entries(stats=True) on the CPU returns the plain walk's
    entries, per-ray node visits and box tests that sum to its totals, and
    no leaf or slot tests."""
    ps, (o, d, tl) = setup["ps"], setup["rays"]
    (ents, ws) = te.tlas_entries(ps, o, d, tl, K=k, stats=True)
    counts = {}
    ref = te.tlas_entries_plain(ps, o, d, tl, K=k, stats=counts)
    assert _equal(ents, ref) and _equal(ents, te.tlas_entries(ps, o, d, tl, K=k))
    assert _equal(ws[:4], counts["per_ray"][:4]) and ws.warp_ns is None
    assert int(ws.nodes.sum()) == counts["nodes"] and int(ws.boxes.sum()) == counts["boxes"]
    assert bool((ws.nodes >= 1).all())  # every walk visits the TLAS root
    assert not bool(ws.leaves.any()) and not bool(ws.tris.any())


def test_tlas_boxes_nest(setup):
    """Every box a TLAS node stores for a child holds the boxes that child
    stores for its own children. K4 takes children nearest first and drops
    a popped node whose entry t is at or past the K-th best; its entries
    equal the plain walk's only because a child's entry t is never below its
    parent's, which nesting gives."""
    ps = setup["ps"]
    boxes, codes, cnts = (x.numpy() for x in tr.node_arrays(ps))
    tlas = range(ps.tlas_root, boxes.shape[0])
    checked = 0
    for n in tlas:
        for c in range(8):
            child = int(codes[n, c])
            if child < 0:
                continue
            lo, hi = boxes[n, c, :3], boxes[n, c, 3:]
            used = ~((codes[child] < 0) & (cnts[child] == 0))
            sub = boxes[child][used]
            valid = (sub[:, :3] <= sub[:, 3:]).all(axis=1)
            assert (sub[valid, :3] >= lo).all() and (sub[valid, 3:] <= hi).all(), (n, c)
            checked += int(valid.sum())
    assert checked > 0


def test_items_counting_instance_on_card(setup):
    """On the card the counting instance of K3/K5 gives the default
    launch's result, zero counts for empty slots, and a warp_ns row for
    every launched warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode; chip_smoke.py "
                    "phases 7-8 (compare_items, check_counts) make this check on the card")
    ps = tr.PreparedScene(*[x.cuda() if isinstance(x, torch.Tensor) else x
                            for x in setup["ps"]])
    inst, o, d, tl = (x.cuda() for x in setup["items"])
    for any_hit in (False, True):
        out, ws = ti.items(ps, inst, o, d, tl, any_hit, stats=True)
        assert _equal(out, ti.items(ps, inst, o, d, tl, any_hit))
        shape = ti.launch_shape(any_hit, True, inst.shape[0])
        assert ws.warp_ns.shape == (shape["grid"] * shape["block"] // 32, 2)
        assert bool((ws.warp_ns[:, 0] > 0).all())
        assert bool((ws.warp_ns[:, 1] >= ws.warp_ns[:, 0]).all())
        empty = inst < 0
        for k in KINDS:
            assert int(getattr(ws, k)[empty].abs().sum()) == 0, k
        live = inst >= 0
        assert bool((ws.nodes[live] >= 1).all())
        assert bool((ws.boxes <= 8 * ws.nodes).all()) and bool((ws.tris <= 64 * ws.leaves).all())
