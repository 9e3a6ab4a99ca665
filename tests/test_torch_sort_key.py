"""The bounce sort's four keys (RFW_SORT_KEY: "octmorton", "morton",
"mortonoct", "instance"; RFW_SORT_INST=1 for "instance") in the port,
against rfw_tpu's render_sample under the same key.

Both packages read the key at import into a module constant; the cases set
both constants (and drop rfw_tpu's traced render_sample, which read its
constant while it was traced). The JAX reference runs its "packet" tier on
the CPU, the port its plain kernel tier, with the same tile width, so the
lane order, the compaction prefixes and (under "random") the threefry
uniforms a lane draws are the same. The shading configuration is cut to
the base lobe in both (`mat_features` 0, no texture kinds, no area-light
next-event estimation), which halves the reference's compile time; the
lane order, the point here, is not affected.

Tolerances (`tests/test_torch_wavefront.py`'s): at least 99% of pixels
within atol 1e-3 + rtol 1e-3 on every channel and the mean within 1e-3
relative of rfw_tpu's frame (float32 rounding of the shading, JAX against
torch); the alias renders bit for bit as "instance" does (one package, the
same key); the live-lane order is exact.

Where the port differs from rfw_tpu by design: rfw_tpu's dead-lane key
2^30 lies below its "mortonoct" key of every live ray whose origin is in
the upper half of the scene box along x, so with compaction on (R >=
16,384) it traces only the prefix of sum(alive) lanes and those live lanes
past it are never traced; the port's dead key (2^31) keeps every live lane
first. `test_mortonoct_above_compaction_traces_every_live_lane` counts the
lanes rfw_tpu leaves untraced and shows that the port traces them all.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch.convert import from_numpy_scene
from rfw_tpu_torch.render import threefry
from rfw_tpu_torch.render import wavefront as tw

W = H = 32
BIG = 128  # 16,384 lanes: compaction on
SAMPLE = 3
KEYS = tw.SORT_KEYS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with _torch_scene.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def scene():
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        return _torch_scene.build("rfw_tpu", seed=1)
    finally:
        mp.undo()


@pytest.fixture
def sort_key(monkeypatch):
    """set(key): both packages' SORT_KEY; rfw_tpu's render_sample traced
    anew under it (and its traces dropped again after the case)."""
    from rfw_tpu.render import wavefront as jw

    def set_key(key):
        monkeypatch.setattr(tw, "SORT_KEY", key)
        monkeypatch.setattr(jw, "SORT_KEY", key)
        jw.render_sample.clear_cache()

    yield set_key
    jw.render_sample.clear_cache()


def _kw(sampler):
    return dict(max_bounces=1, clamp=20.0, sky_intensity=0.35, sampler=sampler,
                two_phase="off", aovs=False, tex_mask=0, mat_features=0,
                has_area_lights=False)


def _jax_render(scene, sampler, size=W):
    from rfw_tpu.render.atlas import atlas_to_device
    from rfw_tpu.render.lights_pack import DeviceLights
    from rfw_tpu.render.pack import TraceScene
    from rfw_tpu.render.wavefront import RenderConfig, render_sample

    sc, mats, lights, atlas, camera = scene
    return np.asarray(render_sample(
        TraceScene(*[jnp.asarray(x) for x in sc]), jax.device_put(mats),
        atlas_to_device(atlas), DeviceLights(*[jnp.asarray(x) for x in lights]),
        jnp.asarray(camera.get_view(size, size).as_array()),
        jax.random.fold_in(jax.random.PRNGKey(42), SAMPLE), size, size,
        RenderConfig(traversal="packet", **_kw(sampler)),
        sample_index=jnp.uint32(SAMPLE) if sampler == "sobol" else None).radiance)


def _port_render(scene, sampler, size=W):
    sc, mats, lights, atlas, camera = scene
    s, m, li, a = from_numpy_scene(sc, mats, lights, atlas, device="cpu")
    return tw.render_sample(
        s, m, a, li, torch.from_numpy(camera.get_view(size, size).as_array()), size, size,
        tw.RenderConfig(**_kw(sampler)),
        sample_index=SAMPLE if sampler == "sobol" else None,
        key=threefry.fold_in(threefry.PRNGKey(42), SAMPLE)).radiance.numpy()


def _bounce_calls(monkeypatch):
    """Record each bounce trace's t_limit (a tensor; the primaries' is the
    scalar T_MAX) through the port's kernel tier."""
    calls = []
    real = tw.closest_hit

    def rec(ps, o, d, tl=tw.T_MAX, **kw):
        if isinstance(tl, torch.Tensor) and tl.dim() == 1:
            calls.append(tl.clone())
        return real(ps, o, d, tl, **kw)

    monkeypatch.setattr(tw, "closest_hit", rec)
    return calls


def assert_close(got, ref):
    assert np.isfinite(got).all() and got.shape == ref.shape
    ok = np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref)
    assert ok.all(axis=1).mean() >= 0.99
    assert ref.mean() > 0 and abs(got.mean() - ref.mean()) <= 1e-3 * ref.mean()


def assert_live_first(tl):
    """The bounce trace's live lanes (t_limit > 0) form a prefix."""
    live = (tl > 0).to(torch.int8)
    assert int(live.sum()) > 0 and not bool((live[1:] > live[:-1]).any())


@pytest.mark.parametrize("key", KEYS)
def test_sobol_matches_reference(scene, sort_key, monkeypatch, key):
    """Under every key the port renders rfw_tpu's frame (below the
    compaction threshold), and its bounce trace sees the live lanes first."""
    sort_key(key)
    calls = _bounce_calls(monkeypatch)
    got = _port_render(scene, "sobol")
    assert len(calls) == 1 and calls[0].shape == (W * H,)
    assert_live_first(calls[0])
    assert_close(got, _jax_render(scene, "sobol"))


@pytest.mark.parametrize("key", [k for k in KEYS if k != "mortonoct"])
def test_random_matches_reference(scene, sort_key, monkeypatch, key):
    """Under "random" a lane's uniforms follow its place, so the frame
    shows the lane order: the port's equals rfw_tpu's under the same key
    and differs from its own under the default key ("mortonoct" is left
    out: rfw_tpu puts some live lanes after dead ones there)."""
    sort_key(key)
    got = _port_render(scene, "random")
    assert_close(got, _jax_render(scene, "random"))
    if key != "octmorton":
        monkeypatch.setattr(tw, "SORT_KEY", "octmorton")
        assert not np.array_equal(got, _port_render(scene, "random"))


def test_sort_inst_alias(scene, monkeypatch, tmp_path):
    """RFW_SORT_INST=1 selects "instance" in both packages (each reads it
    at import, here in a fresh process), and the port renders under it bit
    for bit as under "instance"."""
    code = (
        "import os, sys, numpy as np, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "import _torch_scene, test_torch_sort_key as t\n"
        "import rfw_tpu.render.wavefront as jw\n"
        "from rfw_tpu_torch.render import wavefront as tw\n"
        "print(jw.SORT_KEY, tw.SORT_KEY)\n"
        "torch.set_num_threads(1)\n"
        "os.environ['RFW_NO_NATIVE'] = '1'\n"
        "scene = _torch_scene.build('rfw_tpu', seed=1)\n"
        "np.save(sys.argv[1], t._port_render(scene, 'random'))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("RFW_SORT")}
    env.update(RFW_SORT_INST="1", JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu",
               OMP_NUM_THREADS="1", PYTHONPATH=os.getcwd())
    out_path = str(tmp_path / "alias.npy")
    res = subprocess.run([sys.executable, "-c", code, out_path], env=env, cwd=os.getcwd(),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-2:] == ["instance", "instance"]
    monkeypatch.setattr(tw, "SORT_KEY", "instance")
    assert np.array_equal(np.load(out_path), _port_render(scene, "random"))


@pytest.mark.parametrize("key", KEYS)
def test_sort_key_puts_live_lanes_first(key):
    """sort_key under every key on lanes whose live origins all lie in the
    upper half of the box along x (where rfw_tpu's "mortonoct" key passes
    its dead key): a stable sort puts every live lane first and keeps the
    live lanes in the order of the key without the dead lanes."""
    rng = np.random.default_rng(7)
    n = 4096
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    o[:, 0] = rng.uniform(0.05, 1, n)  # upper half of the box along x
    d = rng.normal(size=(n, 3)).astype(np.float32)
    alive = torch.from_numpy(rng.uniform(size=n) < 0.6)
    hint = torch.from_numpy(rng.integers(-1, 300, n).astype(np.int32))
    mn, mx = torch.tensor([-1.0, -1.0, -1.0]), torch.tensor([1.0, 1.0, 1.0])
    oc = tuple(torch.from_numpy(o[:, j]) for j in range(3))
    dc = tuple(torch.from_numpy(d[:, j]) for j in range(3))
    k = tw.sort_key(oc, dc, mn, mx, alive, hint, key=key)
    live_keys = tw.sort_key(oc, dc, mn, mx, None, hint, key=key)
    if key == "mortonoct":
        assert bool((live_keys[alive] >= 1 << 30).all())
    assert bool((live_keys < tw.DEAD_KEY).all()) and bool((live_keys >= 0).all())
    perm = torch.sort(k, stable=True).indices
    n_live = int(alive.sum())
    assert bool(alive[perm[:n_live]].all()) and not bool(alive[perm[n_live:]].any())
    live_idx = alive.nonzero().squeeze(1)
    order = live_idx[torch.sort(live_keys[live_idx], stable=True).indices]
    assert torch.equal(perm[:n_live], order)


def test_sort_key_refuses_an_unknown_key():
    c = (torch.zeros(2),) * 3
    with pytest.raises(ValueError, match="sort key"):
        tw.sort_key(c, c, torch.zeros(3), torch.ones(3), key="hilbert")


def test_mortonoct_above_compaction_traces_every_live_lane(scene, sort_key, monkeypatch):
    """At 128 x 128 (compaction on) under "mortonoct": rfw_tpu sorts live
    lanes with keys of 2^30 and more behind its dead lanes and traces only
    the prefix that covers sum(alive), so a counted number of live lanes is
    never traced; the port traces every live lane, and its frame is the
    one it renders under the default key."""
    from rfw_tpu.render import wavefront as jw

    sort_key("mortonoct")
    # rfw_tpu's bounce sort (its operands: the key with dead lanes at 2^30,
    # then radiance, throughput, alive, ...) and its bounce trace (the
    # prefix's t_limit), as the jitted render runs them
    seen = {}
    real_sort, real_trace = jax.lax.sort, jw.packet_closest_hit

    def rec_sort(operands, *a, **k):
        if isinstance(operands, tuple) and len(operands) >= 18:
            jax.debug.callback(lambda key, alive: seen.update(key=np.asarray(key),
                                                              alive=np.asarray(alive)),
                               operands[0], operands[7])
        return real_sort(operands, *a, **k)

    def rec_trace(ps, o, d, tl, **k):
        if jnp.ndim(tl) == 1:
            jax.debug.callback(functools.partial(
                lambda n, live: seen.update(n=n, traced=int(live)), tl.shape[0]),
                jnp.sum(tl > 0))
        return real_trace(ps, o, d, tl, **k)

    monkeypatch.setattr(jax.lax, "sort", rec_sort)
    monkeypatch.setattr(jw, "packet_closest_hit", rec_trace)
    _jax_render(scene, "sobol", BIG)
    monkeypatch.setattr(jax.lax, "sort", real_sort)
    jw.render_sample.clear_cache()

    key, alive = seen["key"], seen["alive"]
    n_live = int(alive.sum())
    assert key.shape == (BIG * BIG,) and key[~alive].tolist() == [1 << 30] * int((~alive).sum())
    sorted_live = alive[np.argsort(key, kind="stable")]
    # the prefix rfw_tpu traced: the smallest rung of its ladder over sum(alive)
    sizes = jw._prefix_sizes(BIG * BIG, 512, 1)
    assert len(sizes) > 1 and seen["n"] == sizes[sum(n_live > p for p in sizes[:-1])]
    untraced = n_live - int(sorted_live[:seen["n"]].sum())
    assert seen["traced"] == n_live - untraced
    assert int((key[alive] >= 1 << 30).sum()) > 0 and untraced > 0

    calls = _bounce_calls(monkeypatch)
    port_live = []
    real_key = tw.sort_key

    def rec_key(*a, **k):  # _sort_state passes the state's alive mask 5th
        port_live.append(int(a[4].sum()))
        return real_key(*a, **k)

    monkeypatch.setattr(tw, "sort_key", rec_key)
    got = _port_render(scene, "sobol", BIG)
    assert len(calls) == 1 and len(port_live) == 1
    assert_live_first(calls[0])
    assert int((calls[0] > 0).sum()) == port_live[0]  # every live lane traced
    # the two packages' vertex-0 states agree up to float32 rounding
    assert abs(port_live[0] - n_live) <= 1e-3 * n_live
    monkeypatch.setattr(tw, "SORT_KEY", "octmorton")
    assert_close(got, _port_render(scene, "sobol", BIG))
