"""The port's on-device refit (`rfw_tpu_torch/render/refit_device.py`)
against rfw_tpu's (`rfw_tpu/render/refit_device.py`) on the same packed
scene.

The scene: a skinned sphere (5 joints, seeded smooth weights), a morphed
sphere (two position/normal/tangent targets) and a sphere that is both,
each under two instances, and a static cube; packed by each package
(RFW_NO_NATIVE=1: rfw_tpu's numpy BVH code, which the port copies).

Tolerances:
  * the plans (`build_unit_plan`, `build_tlas_plan`): identical field by
    field;
  * `apply_dynamic` (skin, morphs, both) and `instance_motion_update`:
    every rewritten field within rtol 1e-4, atol 1e-4 of the JAX jit's
    (`tests/test_refit_device.py`'s tolerance; the port rounds its sums
    in another order, and `torch.linalg.inv` differs from
    `jnp.linalg.inv` by a few ulps), every other field identical, the
    static tri_shade columns (uv, LOD, material and light ids) identical;
    each refit box contains its children within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch.render import refit_device as port_refit

J = 5
BOXED = ("blas_min", "blas_max", "blas_wide_f", "blas8_box", "tlas_min", "tlas_max",
         "tlas_wide_f", "tlas8_box", "inst_aabb_min", "inst_aabb_max")


def _meshes(pkg, rng):
    """(slot, mesh, kinds) of `pkg`: skinned, morphed, both, static."""
    import importlib

    prim = importlib.import_module(f"{pkg}.models.primitives")
    out = []
    for slot, kinds in enumerate((("skin",), ("morph",), ("skin", "morph"), ())):
        m = prim.sphere(quality=2, position=(3.0 * slot, 0, 0)) if kinds else prim.cube()
        V = m.num_vertices
        if "skin" in kinds:
            m.joints = rng.integers(0, J, (V, 4)).astype(np.int32)
            w = rng.random((V, 4)).astype(np.float32) + 0.05
            m.weights = (w / w.sum(-1, keepdims=True)).astype(np.float32)
        if "morph" in kinds:
            m.morph_targets = rng.normal(0, 0.2, (2, V, 3)).astype(np.float32)
            m.morph_normals = rng.normal(0, 0.3, (2, V, 3)).astype(np.float32)
            m.morph_tangents = rng.normal(0, 0.3, (2, V, 3)).astype(np.float32)
        out.append((slot, m, kinds))
    return out


def _build(pkg):
    """Pack the scene with `pkg` and build its unit and TLAS plans."""
    import importlib

    pack = importlib.import_module(f"{pkg}.render.pack")
    refit = importlib.import_module(f"{pkg}.render.refit_device")
    rng = np.random.default_rng(5)
    meshes = _meshes(pkg, rng)
    eye = np.eye(4, dtype=np.float32)
    insts = []
    for slot, _, _ in meshes:
        m = np.stack([eye, eye])
        m[:, :3, 3] = rng.uniform(-4, 4, (2, 3))
        m[1, :3, :3] = np.diag(rng.uniform(0.5, 1.5, 3))
        insts.append((slot, m))
    ranges = {}
    scene = pack.pack_trace_scene([(s, m, None) for s, m, _ in meshes], insts,
                                  mesh_ranges_out=ranges)
    plans = []
    for slot, m, kinds in meshes:
        if not kinds:
            continue
        skin, morph = "skin" in kinds, "morph" in kinds
        plan = refit.build_unit_plan(
            scene, ranges[slot], m.positions, m.normals, m.tangents,
            m.joints if skin else None, m.weights if skin else None,
            m.morph_targets if morph else None, m.morph_normals if morph else None,
            m.morph_tangents if morph else None)
        lo, hi = ranges[slot]["inst"]
        plans.append(plan._replace(inst_rows=np.arange(lo, hi, dtype=np.int32)))
    return scene, plans, refit.build_tlas_plan(scene), meshes


@pytest.fixture(scope="module")
def both():
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        return _build("rfw_tpu"), _build("rfw_tpu_torch")
    finally:
        mp.undo()


def _pose(rng, scale=0.4):
    jm = np.zeros((J, 4, 4), np.float32)
    jm[:, :3, :3] = np.eye(3) + rng.normal(size=(J, 3, 3)) * scale
    jm[:, :3, 3] = rng.normal(size=(J, 3)) * scale
    jm[:, 3, 3] = 1.0
    return jm


def test_plans_identical(both):
    (ref_scene, ref_plans, ref_tlas, _), (scene, plans, tlas, _) = both
    _torch_scene.same(ref_scene, scene)
    _torch_scene.same(ref_plans, plans)
    _torch_scene.same(ref_tlas, tlas)
    # the levels schedule the whole tree: every internal node once
    for p in plans:
        ids = np.concatenate([lvl[0] for lvl in p.levels])
        assert len(np.unique(ids)) == len(ids) == len(p.internals)


def test_tlas_plan_min_passes_and_empty_scene():
    """min_passes is a high-water mark; an empty scene gives the all-sentinel
    no-op plan."""
    from rfw_tpu.render.pack import pack_trace_scene as ref_pack
    from rfw_tpu.render.refit_device import build_tlas_plan as ref_plan
    from rfw_tpu_torch.models.primitives import cube
    from rfw_tpu_torch.render.pack import pack_trace_scene

    eye = np.eye(4, dtype=np.float32)[None]
    for meshes, inst in (([(0, cube(), None)], [(0, eye)]), ([(0, cube(), None)], [])):
        for mp in (4, 12):
            _torch_scene.same(ref_plan(ref_pack(meshes, inst), min_passes=mp),
                              port_refit.build_tlas_plan(pack_trace_scene(meshes, inst),
                                                         min_passes=mp))


def _assert_boxes_nest(got, scene):
    """Every refit TLAS parent contains its children, and every BLAS
    8-wide child box its supernode's children, within 1e-5."""
    tmin, tmax = got["tlas_min"], got["tlas_max"]
    cnt, left, right = scene.tlas_count, scene.tlas_left, scene.tlas_right
    stack = [0]
    while stack:
        n = stack.pop()
        if cnt[n] == 0:
            for c in (left[n], right[n]):
                assert (tmin[n] <= tmin[c] + 1e-5).all() and (tmax[n] >= tmax[c] - 1e-5).all()
                stack.append(int(c))
    for box_f, code_f in (("blas8_box", "blas8_code"), ("tlas8_box", "tlas8_code")):
        box, code = got[box_f].reshape(-1, 8, 6), getattr(scene, code_f)
        if code_f == "tlas8_code":
            # node 0's logical subtree (padding supernodes are not refit)
            live, stack = set(), [0]
            while stack:
                s = stack.pop()
                live.add(s)
                stack += [int(c) for c in code[s] if c >= 0 and c not in live]
        else:
            live = range(code.shape[0])
        for s in live:
            for k in range(8):
                c = int(code[s, k])
                if c >= 0:
                    assert (box[s, k, :3] <= box[c, :, :3].min(0) + 1e-5).all()
                    assert (box[s, k, 3:] >= box[c, :, 3:].max(0) - 1e-5).all()


def _compare(ref, got, rest, rewritten):
    for f in rest._fields:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert r.dtype == g.dtype and r.shape == g.shape, f
        if f not in rewritten:
            assert np.array_equal(r, g), f  # fields no refit touches
            continue
        fin = np.isfinite(r)
        assert np.array_equal(fin, np.isfinite(g)) and np.array_equal(r[~fin], g[~fin]), f
        np.testing.assert_allclose(g[fin], r[fin], rtol=1e-4, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("units", ["skin", "morph", "both"])
def test_apply_dynamic_matches_jax(both, units):
    from rfw_tpu.render.refit_device import apply_dynamic

    (rest, ref_plans, ref_tlas, _), (scene, plans, tlas, _) = both
    rng = np.random.default_rng(11)
    pick = {"skin": [0], "morph": [1], "both": [0, 1, 2]}[units]
    poses = [_pose(rng) if i != 1 else None for i in pick]
    weights = [rng.uniform(-0.5, 1.5, 2).astype(np.float32) if i else None for i in pick]
    ref = jax.jit(apply_dynamic)(
        jax.tree.map(jnp.asarray, rest), tuple(ref_plans[i] for i in pick), ref_tlas,
        tuple(None if p is None else jnp.asarray(p) for p in poses),
        tuple(None if w is None else jnp.asarray(w) for w in weights))
    dev = port_refit.plan_to_device
    got = port_refit.apply_dynamic(
        type(scene)(*[torch.from_numpy(np.asarray(x)) for x in scene]),
        [dev(plans[i], "cpu") for i in pick], dev(tlas, "cpu"),
        [None if p is None else torch.from_numpy(p) for p in poses],
        [None if w is None else torch.from_numpy(w) for w in weights])
    _compare(ref, got, rest, port_refit.UNIT_FIELDS + port_refit.TLAS_FIELDS)
    # the deformed units' static shading columns are the packed ones
    for i in pick:
        p = plans[i]
        rows = slice(int(p.tri_lo), int(p.tri_lo) + len(p.r0))
        for cols in (slice(9, 15), slice(25, 26), slice(29, 31)):
            assert np.array_equal(got.tri_shade[rows, cols].numpy(),
                                  rest.tri_shade[rows, cols])
        # and the pose moved them
        assert not np.array_equal(got.tri_v0[rows].numpy(), rest.tri_v0[rows])
    _assert_boxes_nest({f: getattr(got, f).numpy() for f in BOXED}, rest)
    # the input scene's tensors were not written
    assert np.array_equal(scene.tri_v0, rest.tri_v0)


def test_instance_motion_update_matches_jax(both):
    from rfw_tpu.render.refit_device import instance_motion_update

    (rest, _, ref_tlas, meshes), (scene, _, tlas, _) = both
    rng = np.random.default_rng(3)
    icap = rest.inst_matrix.shape[0]
    n = int((rest.inst_mesh >= 0).sum())
    mats = np.broadcast_to(np.eye(4, dtype=np.float32), (icap, 4, 4)).copy()
    mats[:n] = rest.inst_matrix[:n]
    mats[:n, :3, 3] += rng.normal(0, 0.7, (n, 3))
    mats[:n, :3, :3] *= rng.uniform(0.7, 1.3, (n, 1, 1))
    lmin = np.zeros((icap, 3), np.float32)
    lmax = np.zeros((icap, 3), np.float32)
    by_slot = {s: m for s, m, _ in meshes}
    lmin[:n] = np.stack([by_slot[int(s)].aabb_min for s in rest.inst_mesh[:n]])
    lmax[:n] = np.stack([by_slot[int(s)].aabb_max for s in rest.inst_mesh[:n]])
    live = np.arange(icap) < n
    args = (mats, lmin, lmax, live)
    ref = jax.jit(instance_motion_update)(jax.tree.map(jnp.asarray, rest), ref_tlas,
                                          *map(jnp.asarray, args))
    got = port_refit.instance_motion_update(
        type(scene)(*[torch.from_numpy(np.asarray(x)) for x in scene]),
        port_refit.plan_to_device(tlas, "cpu"), *map(torch.from_numpy, args))
    _compare(ref, got, rest, port_refit.MOTION_FIELDS)
    _assert_boxes_nest({f: getattr(got, f).numpy() for f in BOXED}, rest)
    # every live instance's world box contains its 8 transformed corners
    from rfw_tpu_torch.mathx import Aabb, aabb_transform

    wb = aabb_transform(Aabb(lmin[:n], lmax[:n]), mats[:n])
    assert (got.inst_aabb_min[:n].numpy() <= wb.min + 1e-5).all()
    assert (got.inst_aabb_max[:n].numpy() >= wb.max - 1e-5).all()
