"""The traversal's per-ray counts (`closest_hit` / `occluded` with
`stats=True`) and K1's tie rule.

On the CPU the wrappers run the plain walk, so these cases hold its per-ray
counts against its own totals and against hand-counted walks; the cases
marked by a card check skip here (the kernel has no CPU mode). rfw_tpu's
`stats=True` counts while-iterations per Pallas program, so nothing here
compares with it.

Tolerances: none; counts, flags and hits are compared exactly, and on a tie
between two coplanar triangles t is bit-identical while either triangle
may win.
"""

import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch.convert import to_tensor
from rfw_tpu_torch.models.primitives import quad3d
from rfw_tpu_torch.ops import traverse as tr
from rfw_tpu_torch.render.pack import TraceScene, pack_trace_scene

R = 256
KINDS = ("nodes", "boxes", "leaves", "tris")


def _prepared(scene, device="cpu"):
    return tr.prepare_scene(TraceScene(*[to_tensor(getattr(scene, f), device)
                                         for f in TraceScene._fields]))


@pytest.fixture(scope="module")
def setup():
    scene = _torch_scene.build("rfw_tpu_torch", seed=2)[0]
    o, d = _torch_scene.probe_rays(R, seed=8)
    tl = np.random.default_rng(3).uniform(0.5, 12.0, R).astype(np.float32)
    return _prepared(scene), torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tl)


def _plain(any_hit):
    return tr.occluded_plain if any_hit else tr.closest_hit_plain


@pytest.mark.parametrize("any_hit", [False, True])
def test_per_ray_counts_sum_to_totals(setup, any_hit):
    ps, o, d, tl = setup
    stats = {}
    _plain(any_hit)(ps, o, d, tl, stats=stats)
    pr = stats["per_ray"]
    for k in KINDS:
        c = getattr(pr, k)
        assert c.dtype == torch.int32 and c.shape == (R,)
        assert int(c.sum()) == stats[k], k
    assert (pr.nodes >= 1).all()  # every walk starts at the TLAS root
    assert (pr.boxes <= 8 * pr.nodes).all() and (pr.tris <= 64 * pr.leaves).all()
    assert stats["tris"] > 0 and pr.warp_ns is None


@pytest.mark.parametrize("any_hit", [False, True])
def test_stats_keep_the_result(setup, any_hit):
    """stats=True returns the same hits or flags as stats=False, and the
    plain walk's own per-ray counts."""
    ps, o, d, tl = setup
    fn = tr.occluded if any_hit else tr.closest_hit
    out, ws = fn(ps, o, d, tl, stats=True)
    ref = fn(ps, o, d, tl)
    if any_hit:
        assert torch.equal(out, ref)
    else:
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    stats = {}
    _plain(any_hit)(ps, o, d, tl, stats=stats)
    assert all(torch.equal(a, b) for a, b in zip(ws[:4], stats["per_ray"][:4]))


@pytest.mark.parametrize("any_hit", [False, True])
def test_ray_missing_the_tlas_root(setup, any_hit):
    """A ray that misses every child box of the TLAS root counts one node
    visit, a box test per non-empty child and no leaf."""
    ps = setup[0]
    o = torch.tensor([[100.0, 100.0, 100.0]])
    d = torch.tensor([[1.0, 1.0, 1.0]]) / 3 ** 0.5
    fn = tr.occluded if any_hit else tr.closest_hit
    out, ws = fn(ps, o, d, torch.tensor([1e30]), stats=True)
    _, codes, cnts = tr.node_arrays(ps)
    root = ps.tlas_root
    children = int((~((codes[root] < 0) & (cnts[root] == 0))).sum())
    assert children > 0
    assert ws.nodes.tolist() == [1] and ws.boxes.tolist() == [children]
    assert ws.leaves.tolist() == [0] and ws.tris.tolist() == [0]
    assert not bool(out.any()) if any_hit else out.prim.tolist() == [-1]


def _quads(n):
    """n copies of one two-triangle quad (y = 0, 2x2), each its own mesh
    (so its own treelet) under an identity instance."""
    meshes = [(k, quad3d(normal=(0, 1, 0), position=(0, 0, 0), width=2, height=2), None)
              for k in range(n)]
    return pack_trace_scene(meshes, [(k, np.eye(4, dtype=np.float32)[None])
                                     for k in range(n)])


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("side", [1.0, -1.0])
def test_tie_between_treelets(device, side):
    """Two coplanar copies of a quad in different treelets: every ray hits
    both at the same t, bit for bit, and either copy may win; t, u and v are
    those of the one copy alone, and inst names the copy that won."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(11)
    xz = rng.uniform(-0.9, 0.9, (64, 2)).astype(np.float32)
    o = np.stack([xz[:, 0], np.full(64, side, np.float32), xz[:, 1]], 1)
    d = np.tile(np.array([[0.0, -side, 0.0]], np.float32), (64, 1))
    o, d = torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)
    one = tr.closest_hit(_prepared(_quads(1), device), o, d)
    two_scene = _quads(2)
    two = tr.closest_hit(_prepared(two_scene, device), o, d)
    assert bool((one.prim >= 0).all())
    assert torch.equal(one.t.view(torch.int32), two.t.view(torch.int32))
    assert torch.equal(one.u, two.u) and torch.equal(one.v, two.v)
    lo1 = int(two_scene.mesh_tri_range[1, 0])
    copy = (two.prim >= lo1).to(torch.int32)
    assert torch.equal(two.prim - copy * lo1, one.prim)
    assert torch.equal(two.inst, copy)


def test_counting_instance_on_card(setup):
    """On the card the counting instance gives the default launch's result,
    and its per-ray counts are those of a walk from the TLAS root (nearest
    first, so not the plain walk's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ps = tr.PreparedScene(*[x.cuda() if isinstance(x, torch.Tensor) else x for x in setup[0]])
    o, d, tl = (x.cuda() for x in setup[1:])
    occ, wo = tr.occluded(ps, o, d, tl, stats=True)
    assert torch.equal(occ, tr.occluded(ps, o, d, tl))
    hit, wc = tr.closest_hit(ps, o, d, tl, stats=True)
    assert all(torch.equal(a, b) for a, b in zip(hit, tr.closest_hit(ps, o, d, tl)))
    for ws in (wo, wc):
        assert bool((ws.nodes >= 1).all()) and bool((ws.boxes <= 8 * ws.nodes).all())
        assert bool((ws.tris <= 64 * ws.leaves).all())
        assert ws.warp_ns.shape[1] == 2
        assert bool((ws.warp_ns[:, 1] >= ws.warp_ns[:, 0]).all())
