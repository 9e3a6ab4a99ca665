"""The port's native host runtime (`rfw_tpu_torch/native`, its own copy of
`rfw_tpu/native/src/bvh.cpp` built with this machine's g++) against
`rfw_tpu`'s native library and against the port's numpy paths.

Tolerance: none. The two native libraries give bit-identical outputs
(SAH build, refit, wide collapse, skinning); the port's native and numpy
builders give identical node arrays and the same primitives in every leaf
(`prim_order` may differ inside a leaf); the native collapse gives the
numpy collapse's arrays; both packages' default packs (native) are
bit-identical. `RFW_NO_NATIVE=1` selects numpy, and a failed compile
raises instead of falling back.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import _torch_scene
from rfw_tpu_torch import native
from rfw_tpu_torch.accel import bvh_cpu
from rfw_tpu_torch.render import pack


@pytest.fixture(scope="module")
def ref_native():
    from rfw_tpu import native as rn

    assert rn.available(), "rfw_tpu's native library did not build"
    return rn


def _boxes(n, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    return c - 0.2, c + rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)


def _equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name


def _leaf_sets(b):
    return [frozenset(b.prim_order[b.node_left[i]:b.node_left[i] + b.node_count[i]].tolist())
            for i in range(b.num_nodes) if b.node_count[i] > 0]


@pytest.mark.parametrize("max_leaf", [1, 8])
@pytest.mark.parametrize("n", [0, 1, 100, 5000])
def test_sah_build_matches_reference_native(ref_native, n, max_leaf):
    from rfw_tpu.accel.bvh_cpu import build_bvh_sah as ref_build

    mn, mx = _boxes(n)
    got = bvh_cpu.build_bvh_sah(mn, mx, max_leaf)
    _equal(ref_build(mn, mx, max_leaf), got)
    if n:
        _equal(ref_native.build_bvh_sah_native(mn, mx, max_leaf),
               native.build_bvh_sah_native(mn, mx, max_leaf))
    # against the port's numpy builder: the same nodes and leaf sets
    py = bvh_cpu.build_bvh_sah(mn, mx, max_leaf, use_native=False)
    for f in ("node_min", "node_max", "node_left", "node_right", "node_count"):
        assert np.array_equal(getattr(py, f), getattr(got, f)), f
    assert _leaf_sets(py) == _leaf_sets(got)
    assert sorted(got.prim_order.tolist()) == list(range(n))


def test_refit_matches_reference_native_and_numpy(ref_native, monkeypatch):
    from rfw_tpu.accel.bvh_cpu import refit_bvh as ref_refit

    mn, mx = _boxes(3000)
    b = bvh_cpu.build_bvh_sah(mn, mx, 8)
    rng = np.random.default_rng(4)
    shift = rng.normal(0, 0.3, mn.shape).astype(np.float32)
    mn2, mx2 = mn + shift, mx + shift
    got = bvh_cpu.refit_bvh(b, mn2, mx2)
    _equal(ref_refit(b, mn2, mx2), got)
    with monkeypatch.context() as m:
        m.setenv("RFW_NO_NATIVE", "1")
        _equal(bvh_cpu.refit_bvh(b, mn2, mx2), got)
    assert not np.array_equal(got.node_min, b.node_min)  # the refit moved the boxes


@pytest.mark.parametrize("tlas", [False, True], ids=["blas", "tlas"])
@pytest.mark.parametrize("root", [0, 5])
def test_widen_matches_reference_native_and_numpy(ref_native, monkeypatch, tlas, root):
    from rfw_tpu.accel.bvh_cpu import build_bvh_sah as ref_build

    mn, mx = _boxes(700)
    b = ref_build(mn, mx, 1 if tlas else 8)
    assert b.node_count[root] == 0  # an internal subtree root
    got = native.build_widen_native(b, tlas, 3 if tlas else 128, depth=3, root=root)
    ref = ref_native.build_widen_native(b, tlas, 3 if tlas else 128, depth=3, root=root)
    with monkeypatch.context() as m:
        m.setenv("RFW_NO_NATIVE", "1")
        py = pack.build_widen(b, tlas, 3 if tlas else 128, depth=3, root=root)
    for g, r, p in zip(got, ref, py):
        assert g.dtype == r.dtype and np.array_equal(g, r)
        assert np.array_equal(g, p)  # empty children are +-inf in both
    assert np.isinf(got[0]).any()
    assert all(np.array_equal(a, c) for a, c in zip(
        pack.build_widen(b, tlas, 3 if tlas else 128, root=root), got))


def test_skin_matches_reference_native(ref_native):
    from rfw_tpu_torch.render.torch_backend import apply_skin

    rng = np.random.default_rng(5)
    V, J = 500, 6
    pos = rng.normal(size=(V, 3)).astype(np.float32)
    joints = rng.integers(0, J, (V, 4)).astype(np.int32)
    w = rng.uniform(0, 1, (V, 4)).astype(np.float32)
    w[::7] = 0  # unweighted vertices keep the rest pose
    jm = np.tile(np.eye(4, dtype=np.float32), (J, 1, 1))
    jm[:, :3, :] += rng.normal(0, 0.2, (J, 3, 4)).astype(np.float32)
    got = native.skin_positions_native(pos, joints, w, jm)
    assert np.array_equal(got, ref_native.skin_positions_native(pos, joints, w, jm))
    assert np.array_equal(got[::7], pos[::7])

    view = SimpleNamespace(positions=pos, joints=joints, weights=w)
    assert np.array_equal(apply_skin(view, jm), got)


def test_default_packs_bit_identical():
    """Both packages pack the test scene with their native builders by
    default: every arena is the same."""
    ref = _torch_scene.build("rfw_tpu", seed=0, n_inst=3)[0]
    got = _torch_scene.build("rfw_tpu_torch", seed=0, n_inst=3)[0]
    for f in ref._fields:
        x, y = getattr(ref, f), getattr(got, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_no_native_selects_numpy(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the native library was called")

    monkeypatch.setenv("RFW_NO_NATIVE", "1")
    for name in ("build_bvh_sah_native", "refit_bvh_native", "build_widen_native",
                 "skin_positions_native"):
        monkeypatch.setattr(native, name, refuse)
    assert not native.available()
    mn, mx = _boxes(400)
    b = bvh_cpu.build_bvh_sah(mn, mx, 8)
    _equal(b, bvh_cpu.build_bvh_sah(mn, mx, 8, use_native=False))
    bvh_cpu.refit_bvh(b, mn, mx)
    pack.build_widen(b, False)


def test_failed_compile_raises(monkeypatch):
    """A compiler that fails makes the first native call raise with its
    stderr; nothing falls back to numpy."""
    monkeypatch.setenv("CXX", "sh -c 'echo no-compiler-here >&2; exit 3' --")
    monkeypatch.setattr(native, "_LIB", None)
    assert not native.lib_path().exists()
    mn, mx = _boxes(10)
    with pytest.raises(RuntimeError, match="no-compiler-here"):
        bvh_cpu.build_bvh_sah(mn, mx)
    assert not native.lib_path().exists()
    assert not list(native.lib_path().parent.glob(".*.tmp"))
