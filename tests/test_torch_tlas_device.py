"""The port's device TLAS build (`rfw_tpu_torch/accel/tlas_device.py`)
against rfw_tpu's `build_tlas8_device` on the same seeded instances.

Tolerance: none — box, code and cnt identical (dtype, shape, values) for
I in {1, 7, 64, 65, 600}, with and without `pad_nodes`; plus the
invariants of `tests/test_tlas_device.py`: every instance is reachable
once and every child box lies in its parent's, a single instance is leaf
0 of the root, and the port's traversal over a packed scene whose tlas8
mirror is swapped for the device build hits what brute force hits (t
within rtol 1e-3, atol 1e-4, the reference test's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfw_tpu.accel.tlas_device import build_tlas8_device as ref_build
from rfw_tpu_torch.accel.tlas_device import build_tlas8_device, tlas8_node_count
from rfw_tpu_torch.mathx import compose_trs, quat_identity


def _random_instances(rng, n, rotate=True):
    """n seeded object->world matrices (translation, scale, and with
    `rotate` a random rotation) and local boxes."""
    mats = []
    for _ in range(n):
        t = rng.uniform(-6, 6, 3).astype(np.float32)
        s = rng.uniform(0.3, 1.4, 3).astype(np.float32)
        q = rng.normal(size=4).astype(np.float32) if rotate else quat_identity()
        mats.append(compose_trs(t, (q / np.linalg.norm(q)).astype(np.float32), s))
    lmin = rng.uniform(-1, 0, (n, 3)).astype(np.float32)
    lmax = (lmin + rng.uniform(0.1, 2, (n, 3))).astype(np.float32)
    return np.stack(mats).astype(np.float32), lmin, lmax


def _port(mats, lmin, lmax, pad_nodes=0):
    return [a.numpy() for a in build_tlas8_device(
        torch.from_numpy(mats), torch.from_numpy(lmin), torch.from_numpy(lmax),
        pad_nodes=pad_nodes)]


@pytest.mark.parametrize("n", [1, 7, 64, 65, 600])
def test_matches_jax_bit_for_bit(n):
    rng = np.random.default_rng(n)
    args = _random_instances(rng, n)
    for pad in (0, tlas8_node_count(n) + 5):
        ref = [np.asarray(a) for a in ref_build(*map(jnp.asarray, args), pad_nodes=pad)]
        got = _port(*args, pad_nodes=pad)
        for name, r, g in zip(("box", "code", "cnt"), ref, got):
            assert r.dtype == g.dtype and r.shape == g.shape, name
            assert np.array_equal(r, g), (n, pad, name)
        assert got[0].shape[0] == max(pad, tlas8_node_count(n))


@pytest.mark.parametrize("n", [23, 600])
def test_every_instance_reachable_once_and_contained(n):
    rng = np.random.default_rng(7)
    mats, lmin, lmax = _random_instances(rng, n)
    box, code, cnt = _port(mats, lmin, lmax)
    assert box.shape[0] == tlas8_node_count(n)
    seen = []

    def walk(node, pmin, pmax):
        for c in range(8):
            bmin, bmax = box[node, 6 * c:6 * c + 3], box[node, 6 * c + 3:6 * c + 6]
            if not np.all(bmin <= bmax):
                continue  # empty slot
            assert np.all(bmin >= pmin - 1e-4) and np.all(bmax <= pmax + 1e-4)
            if code[node, c] >= 0:
                walk(code[node, c], bmin, bmax)
            else:
                seen.append(-code[node, c] - 1)

    walk(0, np.full(3, -np.inf), np.full(3, np.inf))
    assert sorted(seen) == list(range(n))
    assert cnt.sum() == n


def test_single_instance():
    mats, _, _ = _random_instances(np.random.default_rng(1), 1)
    box, code, cnt = _port(mats, np.full((1, 3), -1, np.float32), np.ones((1, 3), np.float32))
    assert code[0, 0] == -1  # leaf instance 0 (= -(0+1))
    assert (cnt[0] == np.array([1, 0, 0, 0, 0, 0, 0, 0])).all()


def test_traversal_with_device_tlas_matches_oracle():
    """Swap the packed scene's host-built tlas8 mirror for the device
    build; the port's traversal (its plain walk on the CPU) must still
    agree with brute force."""
    from rfw_tpu_torch.convert import scene_to_device
    from rfw_tpu_torch.models import cube, sphere
    from rfw_tpu_torch.ops.traverse import closest_hit, prepare_scene
    from rfw_tpu_torch.render.intersect import brute_force_closest
    from rfw_tpu_torch.render.pack import pack_trace_scene

    import _torch_scene

    rng = np.random.default_rng(3)
    mesh, box = sphere(quality=1), cube()
    mats_a, _, _ = _random_instances(rng, 9, rotate=False)
    mats_b, _, _ = _random_instances(rng, 5, rotate=False)
    scene = pack_trace_scene([(0, mesh, None), (1, box, None)], [(0, mats_a), (1, mats_b)])
    n = int((scene.inst_mesh >= 0).sum())
    by_slot = {0: mesh, 1: box}
    lmin = np.stack([by_slot[int(s)].aabb_min for s in scene.inst_mesh[:n]])
    lmax = np.stack([by_slot[int(s)].aabb_max for s in scene.inst_mesh[:n]])
    b8, c8, n8 = _port(scene.inst_matrix[:n], lmin, lmax,
                       pad_nodes=scene.tlas8_box.shape[0])
    swapped = scene._replace(tlas8_box=b8, tlas8_code=c8, tlas8_cnt=n8)
    ps = prepare_scene(scene_to_device(swapped, "cpu"))

    o = rng.uniform(-8, 8, (1024, 3)).astype(np.float32)
    o[:, 2] += 4.0
    d = rng.uniform(-7, 7, (1024, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    hit = closest_hit(ps, torch.from_numpy(o), torch.from_numpy(d))
    v0, e1, e2, _ = _torch_scene.world_triangles(scene)
    t_ref, p_ref, _, _ = brute_force_closest(*map(torch.from_numpy, (o, d, v0, e1, e2)))
    mask = hit.prim.numpy() >= 0
    assert mask.any() and (mask == (p_ref.numpy() >= 0)).all()
    np.testing.assert_allclose(hit.t.numpy()[mask], t_ref.numpy()[mask], rtol=1e-3, atol=1e-4)
