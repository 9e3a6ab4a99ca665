"""The port's device LBVH builder (`accel.lbvh.build_lbvh_device`) against
rfw_tpu's, on the CPU.

Tolerance: none. The Morton order (prim_order) is bit-identical to
rfw_tpu's at every size, duplicate codes included (ties broken by sorted
index, as the stable sort gives); so is the topology (node_left,
node_right, node_count) wherever rfw_tpu's tree reaches every node, and so
are the node boxes wherever rfw_tpu's box is the exact box of its subtree.
rfw_tpu departs from both in places: its range-length search stops short
on ranges longer than about 64 keys (a box then covers part of its
subtree, and a long run of equal codes leaves nodes unreached), and at a
power-of-two count its sparse table lacks the root's level. The port's
tree reaches every node and leaf once and every box is the exact min/max of
the leaves below it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu_torch.accel.lbvh import DeviceBvh, _clz32, build_lbvh_device


def _boxes(n, seed, dup=False):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    if dup:
        c[::3] = c[0]  # every third box shares one centroid: duplicate codes
    return c - 0.3, c + rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)


def _subtree_boxes(b, mn, mx):
    """Each node's exact box: the min/max of the leaves below it."""
    n = b.prim_order.shape[0]
    smn, smx = mn[b.prim_order], mx[b.prim_order]
    lo = np.zeros(2 * n - 1, np.int64)
    hi = np.zeros(2 * n - 1, np.int64)
    lo[n - 1:] = hi[n - 1:] = np.arange(n)
    order, stack = [], [0]
    while stack:  # parents before children; fill ranges children first
        i = stack.pop()
        order.append(i)
        if b.node_count[i] == 0:
            stack += [int(b.node_left[i]), int(b.node_right[i])]
    for i in reversed(order):
        if b.node_count[i] == 0:
            lo[i] = lo[b.node_left[i]]
            hi[i] = hi[b.node_right[i]]
    bmin = np.stack([smn[lo[i]:hi[i] + 1].min(0) for i in range(2 * n - 1)])
    bmax = np.stack([smx[lo[i]:hi[i] + 1].max(0) for i in range(2 * n - 1)])
    return bmin, bmax, sorted(order)


@pytest.mark.parametrize("n,dup", [(0, False), (1, False), (2, False), (3, False),
                                   (17, True), (1000, False), (1000, True)],
                         ids=["n0", "n1", "n2", "n3", "n17-dup", "n1000", "n1000-dup"])
def test_matches_reference(n, dup):
    from rfw_tpu.accel.lbvh import build_lbvh_device as ref_build

    mn, mx = _boxes(n, seed=n, dup=dup)
    got = build_lbvh_device(torch.from_numpy(mn), torch.from_numpy(mx))
    ref = ref_build(jnp.asarray(mn), jnp.asarray(mx))
    assert isinstance(got, DeviceBvh) and got._fields == ref._fields
    g = DeviceBvh(*[x.numpy() for x in got])
    r = DeviceBvh(*[np.asarray(x) for x in ref])
    for x, y in zip(g, r):
        assert x.dtype == y.dtype and x.shape == y.shape
    assert np.array_equal(g.prim_order, r.prim_order)
    if n < 2:
        for x, y in zip(g, r):
            assert np.array_equal(x, y)
        return
    bmin, bmax, reached = _subtree_boxes(g, mn, mx)
    assert reached == list(range(2 * n - 1))  # every node once
    assert np.array_equal(g.node_min, bmin) and np.array_equal(g.node_max, bmax)
    if _subtree_boxes(r, mn, mx)[2] != list(range(2 * n - 1)):
        assert dup  # only long runs of equal codes break rfw_tpu's tree
        return
    for f in ("node_left", "node_right", "node_count"):
        assert np.array_equal(getattr(g, f), getattr(r, f)), f
    # rfw_tpu's boxes equal the port's wherever they are the exact ones
    right = (r.node_min == bmin).all(1) & (r.node_max == bmax).all(1)
    assert np.array_equal(g.node_min[right], r.node_min[right])
    if n == 2:
        assert not right[0]  # rfw_tpu's root at a power of two covers one leaf
    if n == 1000:
        assert right.mean() > 0.98


def test_clz32():
    x = np.array([0, 1, 2, 3, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.int64)
    want = [32, 31, 30, 30, 16, 15, 1, 0, 0]
    assert _clz32(torch.from_numpy(x)).tolist() == want


def test_on_the_inputs_device_and_dtypes():
    mn, mx = _boxes(100, seed=5)
    b = build_lbvh_device(torch.from_numpy(mn), torch.from_numpy(mx))
    assert all(x.device.type == "cpu" for x in b)
    assert [x.dtype for x in b] == [torch.float32] * 2 + [torch.int32] * 4
    assert b.node_min.shape == (199, 3) and b.prim_order.shape == (100,)
