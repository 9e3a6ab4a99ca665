"""render_sample's three switches in the port against rfw_tpu under the
same environment:

  * RFW_DEEP_LADDER (read by `_prefix_sizes` at each call): 0 drops the two
    sub-floor rungs that max_bounces >= 3 adds to the compaction ladder;
  * RFW_COMPACTION (read by render_sample at each call): 0 traces and
    shades every lane at every vertex, even with `compaction="auto"`, so
    no live count is read back to the host;
  * RFW_POTENTIAL_MAX (read at import into `POTENTIAL_MAX`): the padded
    light-table rows up to which the light pick weighs each light's
    potential at the shading point; 0 leaves the global power CDF.

rfw_tpu reads the first two while its jitted render_sample is traced and
the third into a constant the trace reads, so each case drops its traces
before and after. The JAX reference runs its "packet" tier on the CPU and
the port its plain kernel tier, with the same tile width (256 at 128 x
128, R = 16,384: compaction on). The shading configuration of the 128 x
128 cases is cut to the base lobe in both (as `test_torch_sort_key.py`
does) to halve the reference's compile time.

Tolerances (`tests/test_torch_wavefront.py`'s): at least 99% of pixels
within atol 1e-3 + rtol 1e-3 on every channel and the mean within 1e-3
relative of rfw_tpu's frame; the port's frames with a switch on and off
(one package, the Sobol sampler keyed by pixel) are equal.
"""

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
from rfw_tpu_torch.render import wavefront as tw

SMALL = 32
BIG = 128  # 16,384 lanes: compaction on
SAMPLE = 3


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
def jw():
    """rfw_tpu's wavefront module, its render_sample traces dropped before
    and after the case (they read the switches when traced)."""
    from rfw_tpu.render import wavefront as jw

    jw.render_sample.clear_cache()
    yield jw
    jw.render_sample.clear_cache()


def _kw(max_bounces=1, full=False, mats=None):
    kw = dict(max_bounces=max_bounces, clamp=20.0, sky_intensity=0.35, sampler="sobol",
              two_phase="off", aovs=False, tex_mask=0, mat_features=0,
              has_area_lights=False)
    if full:
        kw.update(tex_mask=tw.tex_kinds_mask(mats.tex), mat_features=tw.mat_feature_mask(mats),
                  has_area_lights=True)
    return kw


def _jax_render(scene, kw, size):
    from rfw_tpu.render.atlas import atlas_to_device
    from rfw_tpu.render.lights_pack import DeviceLights
    from rfw_tpu.render.pack import TraceScene
    from rfw_tpu.render.wavefront import RenderConfig, render_sample

    sc, mats, lights, atlas, camera = scene
    return np.asarray(render_sample(
        TraceScene(*[jnp.asarray(x) for x in sc]), jax.device_put(mats),
        atlas_to_device(atlas), DeviceLights(*[jnp.asarray(x) for x in lights]),
        jnp.asarray(camera.get_view(size, size).as_array()), jax.random.PRNGKey(0), size,
        size, RenderConfig(traversal="packet", **kw), sample_index=jnp.uint32(SAMPLE)).radiance)


def _port_render(scene, kw, size):
    sc, mats, lights, atlas, camera = scene
    s, m, li, a = from_numpy_scene(sc, mats, lights, atlas, device="cpu")
    return tw.render_sample(
        s, m, a, li, torch.from_numpy(camera.get_view(size, size).as_array()), size, size,
        tw.RenderConfig(**kw), sample_index=SAMPLE).radiance.numpy()


def assert_close(got, ref):
    assert np.isfinite(got).all() and got.shape == ref.shape
    ok = np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref)
    assert ok.all(axis=1).mean() >= 0.99
    assert ref.mean() > 0 and abs(got.mean() - ref.mean()) <= 1e-3 * ref.mean()


def _picks(monkeypatch):
    """Record each `_pick_prefix` call's (sizes, chosen prefix)."""
    calls = []
    real = tw._pick_prefix

    def rec(sizes, live):
        n = real(sizes, live)
        calls.append((list(sizes), n))
        return n

    monkeypatch.setattr(tw, "_pick_prefix", rec)
    return calls


# --------------------------------------------------------- RFW_DEEP_LADDER
@pytest.mark.parametrize("ladder", ["1", "0"])
@pytest.mark.parametrize("bounces", [1, 3, 5])
@pytest.mark.parametrize("g", [32, 1024])
@pytest.mark.parametrize("R", [1000, 16384, 65536, 2073600])
def test_prefix_sizes_match_reference(monkeypatch, R, g, bounces, ladder):
    from rfw_tpu.render.wavefront import _prefix_sizes

    monkeypatch.setenv("RFW_DEEP_LADDER", ladder)
    got = tw._prefix_sizes(R, g, bounces)
    assert got == _prefix_sizes(R, g, bounces)
    assert got[-1] == R and got == sorted(set(got))
    monkeypatch.setenv("RFW_DEEP_LADDER", "1")
    deep = tw._prefix_sizes(R, g, bounces)
    # the switch only drops rungs, and only where the deep ladder adds them
    assert set(got) <= set(deep)
    if ladder == "1" or bounces < 3:
        assert got == deep


def test_deep_ladder_off_renders_the_same_frame(scene, monkeypatch):
    """At 128 x 128 with 3 bounces the port's frames with the deep ladder
    (whose last vertex traces a sub-floor rung) and without it are
    bit-identical, and without it no sub-floor rung is chosen."""
    kw = _kw(max_bounces=3)
    g = tw.resolve_traversal(tw.RenderConfig(**kw), BIG * BIG).lanes
    picks = _picks(monkeypatch)
    on = _port_render(scene, kw, BIG)
    deep = picks[-1][0]
    monkeypatch.setenv("RFW_DEEP_LADDER", "0")
    shallow = tw._prefix_sizes(BIG * BIG, g, 3)
    sub_floor = set(deep) - set(shallow)
    assert len(sub_floor) == 2 and {n for _, n in picks} & sub_floor
    del picks[:]
    off = _port_render(scene, kw, BIG)
    assert len(picks) == 4  # vertex 0 and three bounce vertices
    assert all(sizes == shallow for sizes, _ in picks[1:])
    assert not {n for _, n in picks} & sub_floor
    assert np.array_equal(on, off)


# ---------------------------------------------------------- RFW_COMPACTION
def test_compaction_off_matches_reference(scene, jw, monkeypatch):
    """At 128 x 128 (compaction on by default) under RFW_COMPACTION=0: the
    port's frame matches rfw_tpu's under the same switch, reads no live
    count (no `_pick_prefix` call), and equals its own compacted frame."""
    kw = _kw()
    picks = _picks(monkeypatch)
    compacted = _port_render(scene, kw, BIG)
    assert len(picks) == 2  # vertex 0 and the bounce vertex
    del picks[:]
    monkeypatch.setenv("RFW_COMPACTION", "0")
    got = _port_render(scene, kw, BIG)
    assert picks == []
    assert np.array_equal(got, compacted)
    assert_close(got, _jax_render(scene, kw, BIG))


# ------------------------------------------------------- RFW_POTENTIAL_MAX
def test_potential_max_read_at_import(tmp_path):
    """RFW_POTENTIAL_MAX sets both packages' constant at import (here in
    a fresh process)."""
    code = ("import rfw_tpu.render.wavefront as jw\n"
            "from rfw_tpu_torch.render import wavefront as tw\n"
            "print(jw.POTENTIAL_MAX, tw.POTENTIAL_MAX)\n")
    env = dict(os.environ, RFW_POTENTIAL_MAX="0", JAX_PLATFORMS="cpu",
               JAX_PLATFORM_NAME="cpu", OMP_NUM_THREADS="1", PYTHONPATH=os.getcwd())
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.getcwd(),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-2:] == ["0", "0"]
    assert tw.POTENTIAL_MAX == int(os.environ.get("RFW_POTENTIAL_MAX", "16"))


@pytest.fixture(scope="module")
def two_points(scene):
    """The scene with its lights replaced by two point lights of unequal
    power (packed by rfw_tpu; both packages read the same arrays)."""
    from rfw_tpu.backend.lights import (
        AreaLightsView, DirectionalLightsView, PointLightsView, SpotLightsView,
    )
    from rfw_tpu.render.lights_pack import pack_lights

    sc, mats, _, atlas, camera = scene
    pts = PointLightsView(
        position=np.array([[-1.0, 3.0, 1.0], [1.5, 2.5, -0.5]], np.float32),
        energy=np.array([[40.0, 38.0, 35.0], [8.0, 9.0, 10.0]], np.float32),
        changed=np.ones(2, bool))
    lights = pack_lights(pts, SpotLightsView.empty(), DirectionalLightsView.empty(),
                         AreaLightsView.empty())
    return sc, mats, lights, atlas, camera


def test_power_cdf_pick_matches_reference(two_points, jw, monkeypatch):
    """With POTENTIAL_MAX 0 in both packages the light pick is the power
    CDF: the port's frame with two point lights matches rfw_tpu's, and
    differs from its own potential-weighted frame."""
    kw = _kw(full=True, mats=two_points[1])
    kw["has_area_lights"] = False
    potential = _port_render(two_points, kw, SMALL)
    monkeypatch.setattr(tw, "POTENTIAL_MAX", 0)
    monkeypatch.setattr(jw, "POTENTIAL_MAX", 0)
    got = _port_render(two_points, kw, SMALL)
    assert_close(got, _jax_render(two_points, kw, SMALL))
    assert not np.array_equal(got, potential)
