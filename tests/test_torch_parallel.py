"""The scale-out layer's building block, `render_sample(row0=)`, and the
single-process behaviour of `rfw_tpu_torch.parallel`.

A `row0` strip renders rows [row0, row0 + height) of the frame whose view
it is given: pixel ids, Sobol keys and camera rays stay the full frame's.
Under Sobol the two half-frame strips concatenate to the full frame bit
for bit, at 32x32 and at 128x128 (R = 16,384, where the full frame's
bounce vertex runs on a compacted live prefix and the strips' do not).
The port's strip is held to `rfw_tpu`'s `render_sample(row0=)` strip at
`test_torch_wavefront.py`'s tolerances (Sobol, and the random sampler with
one key, whose per-lane draws are the strip's own in both packages).
`rfw_tpu.parallel` itself is not run here: its own `test_parallel.py`
holds its sharded functions to its `render_sample`, and the multi-rank
collectives of the port run in `test_torch_distributed.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_scene
from rfw_tpu_torch.convert import from_numpy_scene
from rfw_tpu_torch.render import threefry
from rfw_tpu_torch.render import wavefront as tw
from test_torch_wavefront import _cfg_kwargs, _frac_close

W = H = 32


@pytest.fixture(scope="module")
def scene():
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        return _torch_scene.build("rfw_tpu", seed=1)
    finally:
        mp.undo()


def _port_args(scene, width, height):
    sc, mats, lights, atlas, camera = scene
    s, m, li, a = from_numpy_scene(sc, mats, lights, atlas, device="cpu")
    return s, m, a, li, torch.from_numpy(camera.get_view(width, height).as_array())


def _port(scene, kw, width, height, rows, row0=0, sample_index=3, key=None):
    s, m, a, li, view = _port_args(scene, width, height)
    r = tw.render_sample(s, m, a, li, view, width, rows, tw.RenderConfig(**kw),
                         sample_index=sample_index, key=key, row0=row0)
    return {k: getattr(r, k).numpy() for k in r._fields}


@pytest.mark.parametrize("size,bounces", [(32, 2), (128, 1)], ids=["32x32", "128x128"])
def test_strips_concatenate_to_full_frame(scene, size, bounces):
    kw = _cfg_kwargs(scene[1], bounces, aovs=True)
    if size == 128:
        assert len(tw._prefix_sizes(size * size, 256)) > 1  # the full frame compacts
        assert len(tw._prefix_sizes(size * size // 2, 256)) == 1  # a strip does not
    full = _port(scene, kw, size, size, size)
    halves = [_port(scene, kw, size, size, size // 2, row0=r) for r in (0, size // 2)]
    for k, v in full.items():
        assert halves[0][k].shape[0] == size * size // 2
        np.testing.assert_array_equal(np.concatenate([h[k] for h in halves]), v, err_msg=k)


def test_row0_as_tensor_matches_int(scene):
    kw = _cfg_kwargs(scene[1], 1, aovs=False)
    a = _port(scene, kw, W, H, H // 2, row0=H // 2)
    b = _port(scene, kw, W, H, H // 2, row0=torch.tensor(H // 2))
    np.testing.assert_array_equal(a["radiance"], b["radiance"])


def _jax_strip(scene, kw, key, sample_index):
    from rfw_tpu.render.atlas import atlas_to_device
    from rfw_tpu.render.lights_pack import DeviceLights
    from rfw_tpu.render.pack import TraceScene
    from rfw_tpu.render.wavefront import RenderConfig, render_sample

    sc, mats, lights, atlas, camera = scene
    r = render_sample(
        TraceScene(*[jnp.asarray(x) for x in sc]), jax.device_put(mats),
        atlas_to_device(atlas), DeviceLights(*[jnp.asarray(x) for x in lights]),
        jnp.asarray(camera.get_view(W, H).as_array()), key, W, H // 2,
        RenderConfig(traversal="packet", **kw), sample_index=sample_index, row0=H // 2)
    return {k: np.asarray(getattr(r, k)) for k in r._fields}


def test_row0_strip_matches_jax_sobol(scene):
    """Sobol at test_torch_wavefront.py's radiance and AOV tolerances."""
    kw = _cfg_kwargs(scene[1], 2)
    ref = _jax_strip(scene, kw, jax.random.PRNGKey(0), jnp.uint32(3))
    got = _port(scene, kw, W, H, H // 2, row0=H // 2)
    assert got["radiance"].shape == (W * H // 2, 3) and np.isfinite(got["radiance"]).all()
    assert _frac_close(got["radiance"], ref["radiance"], 1e-3, 1e-3) >= 0.99
    m_ref, m_got = ref["radiance"].mean(), got["radiance"].mean()
    assert m_ref > 0 and abs(m_got - m_ref) <= 1e-3 * m_ref
    for aov, atol, rtol in (("albedo", 1e-4, 0.0), ("normal", 1e-4, 0.0),
                            ("depth", 0.0, 1e-4), ("position", 1e-4, 1e-4)):
        assert _frac_close(got[aov], ref[aov], atol, rtol) >= 0.99, aov


def test_row0_strip_matches_jax_random(scene):
    """The random sampler with one key, at test_random_sampler_matches_jax's
    tolerances: the strip draws its own lanes' threefry uniforms in both
    packages."""
    kw = {**_cfg_kwargs(scene[1], 2), "sampler": "random"}
    ref = _jax_strip(scene, kw, jax.random.fold_in(jax.random.PRNGKey(42), 3), None)
    got = _port(scene, kw, W, H, H // 2, row0=H // 2, sample_index=None,
                key=threefry.fold_in(threefry.PRNGKey(42), 3))
    assert np.isfinite(got["radiance"]).all()
    assert _frac_close(got["radiance"], ref["radiance"], 1e-3, 1e-3) >= 0.99
    m_ref, m_got = ref["radiance"].mean(), got["radiance"].mean()
    assert m_ref > 0 and abs(m_got - m_ref) <= 1e-3 * m_ref
    assert _frac_close(got["normal"], ref["normal"], 1e-4, 0.0) >= 0.99
    assert _frac_close(got["depth"], ref["depth"], 0.0, 1e-4) >= 0.99


def test_init_distributed_single_process_is_a_no_op(monkeypatch):
    from rfw_tpu_torch.parallel import init_distributed

    for k in ("RFW_COORDINATOR", "RFW_NUM_PROCESSES", "RFW_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert init_distributed(coordinator="127.0.0.1:1", num_processes=1) is False
    assert not dist.is_initialized()


def test_no_card_raises(monkeypatch):
    """Without a card, the entry points that default to it raise: no
    group is made, nothing falls back to gloo."""
    from rfw_tpu_torch.parallel import film_mesh, init_distributed
    from rfw_tpu_torch.parallel.mesh import mesh_2d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        film_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_2d(1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(coordinator="127.0.0.1:1", num_processes=2, process_id=0)
    assert not dist.is_initialized()


@pytest.fixture
def one_rank():
    """A one-rank gloo group made by film_mesh(device="cpu"), destroyed
    after the test."""
    from rfw_tpu_torch.parallel import film_mesh

    assert not dist.is_initialized()
    try:
        yield film_mesh(device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_one_rank_mesh_runs_the_sharded_paths(scene, one_rank):
    """On a one-rank mesh every strategy is the plain call it stands for:
    the film strip is the frame (random sampler, bit for bit), the spp
    and 2-D means the sequential means (Sobol), and scene broadcast is the
    identity; a mesh larger than the world raises."""
    from torch.distributed.tensor import DTensor

    from rfw_tpu_torch.parallel import broadcast_scene, film_mesh, render_sample_sharded
    from rfw_tpu_torch.parallel.mesh import mesh_2d, render_sharded_2d, render_spp_sharded

    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    s, m, a, li, view = _port_args(scene, W, H)
    kw = _cfg_kwargs(scene[1], 1, aovs=False)
    key = threefry.PRNGKey(5)
    rnd = tw.RenderConfig(**{**kw, "sampler": "random"})
    res = render_sample_sharded(one_rank, s, m, a, li, view, key, W, H, rnd)
    assert isinstance(res.radiance, DTensor)
    ref = tw.render_sample(s, m, a, li, view, W, H, rnd, key=key)
    np.testing.assert_array_equal(res.radiance.full_tensor().numpy(), ref.radiance.numpy())

    sob = tw.RenderConfig(**kw)
    seq = sum(tw.render_sample(s, m, a, li, view, W, H, sob, sample_index=i,
                               key=k).radiance for i, k in enumerate(threefry.split(key, 2))) / 2
    spp = render_spp_sharded(film_mesh(axis="spp", device="cpu"), s, m, a, li, view, key,
                             W, H, 2, sob)
    two = render_sharded_2d(mesh_2d(1, 1, device="cpu"), s, m, a, li, view, key, W, H, 2, sob)
    for got in (spp, two):
        np.testing.assert_allclose(got.full_tensor().numpy(), seq.numpy(), rtol=1e-5, atol=1e-6)
    assert broadcast_scene(s) is s
    with pytest.raises(ValueError, match="world"):
        film_mesh(2, device="cpu")
