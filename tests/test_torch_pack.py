"""The port's host packers give bit-identical arrays to rfw_tpu's.

rfw_tpu builds BVHs with its native C++ builder when available; the port
carries only the numpy builder, so the reference runs with RFW_NO_NATIVE=1
(its own numpy path). Tolerance: none — np.array_equal on every field.
"""

import dataclasses

import numpy as np
import pytest

import _torch_scene

CASES = [
    dict(seed=0, n_inst=3, quality=1, with_tex=True),
    dict(seed=5, n_inst=5, quality=2, with_tex=False),
]


@pytest.fixture(scope="module", params=range(len(CASES)), ids=lambda i: f"case{i}")
def both(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        ref = _torch_scene.build("rfw_tpu", **CASES[request.param])
    finally:
        mp.undo()
    port = _torch_scene.build("rfw_tpu_torch", **CASES[request.param])
    return ref, port


def _assert_tuple_equal(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


def test_pack_trace_scene(both):
    (ref, port) = both
    _assert_tuple_equal(ref[0], port[0])


def test_pack_lights(both):
    ref, port = both
    _assert_tuple_equal(ref[2], port[2])


def test_materials_to_device(both):
    ref, port = both
    for f in dataclasses.fields(ref[1]):
        x, y = getattr(ref[1], f.name), getattr(port[1], f.name)
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name


def test_pack_atlas(both):
    ref, port = both
    _assert_tuple_equal(ref[3], port[3])


@pytest.mark.parametrize("size", [(32, 32), (256, 144), (1920, 1080)])
def test_camera_view(both, size):
    ref, port = both
    a = ref[4].get_view(*size).as_array()
    b = port[4].get_view(*size).as_array()
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bvh_build_matches_reference_numpy_path():
    from rfw_tpu.accel.bvh_cpu import build_bvh_sah as ref_build
    from rfw_tpu_torch.accel.bvh_cpu import build_bvh_sah

    rng = np.random.default_rng(3)
    c = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    mn, mx = c - 0.2, c + rng.uniform(0.1, 1.0, (500, 3)).astype(np.float32)
    a = ref_build(mn, mx, max_leaf=8, use_native=False)
    b = build_bvh_sah(mn, mx, max_leaf=8)
    for f in dataclasses.fields(a):
        assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), f.name
