"""The layer tools of rfw_tpu_torch.tools against the reference's tools/.

Each tool's `main([...])` runs here on the CPU (`--device cpu`, the
plain versions) at 32x32, the smallest frame the reference tools' 32 x 32
pixel blocks allow, on the small textured glTF of
`_torch_scene.bench_gltf_doc` (`--gltf`); the reference's bench.py loads
the same file through its PICA global (`_torch_scene.reference_bench`).
Everything a tool prints that is not a time is held against rfw_tpu on
the same inputs:

  * bisect_e2e: its three RenderConfigs equal, field for field, those the
    reference tool (tools/bisect_e2e.py, run as a script with
    render_sample recording its config) builds for the same scene;
  * bench_traverse: its coherent primaries against rfw_tpu's camera_rays
    over rfw_tpu's _block_swizzle (rtol 1e-5, atol 1e-6), its bounce rays
    against the reference's composition (jax.random's sphere directions
    from the same hits) at that tolerance, and its sorted rays bit for bit
    the reference's sort (octant, morton_codes, lax.sort) of its unsorted
    rays; the two-phase any hit agrees with K2 on every ray;
  * check_traverse: zero mismatches against the oracle, the gate passed;
  * bench_items: no disagreement on untruncated rays, none with --fused,
    and phase A by K4 keeps the reference walk's entry sets;
  * diag_live: its live shares against those the reference tool
    (tools/diag_live.py, run as a script with its Pallas calls in
    interpret mode) prints: the primaries' share equal to its 4 decimals,
    the bounce share within the rays that flip when the hit t moves by the
    TPU kernel's 1.5e-5 relative error (the reference's material split
    fails in the reference itself; the shares come before it);
  * profile_e2e: every stage reported.
"""

import dataclasses
import json
import runpy
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

import _torch_scene
from rfw_tpu_torch import bench as tbench
from rfw_tpu_torch.ops.traverse import closest_hit, prepare_scene
from rfw_tpu_torch.tools import (
    bench_items, bench_traverse, bisect_e2e, check_traverse, diag_live, profile_e2e,
)

TOOLS = Path(__file__).resolve().parent.parent / "tools"
W = H = 32
R = W * H
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def gltf_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("tools") / "scene.gltf"
    path.write_text(json.dumps(_torch_scene.bench_gltf_doc()))
    return str(path)


@pytest.fixture(scope="module")
def ref_bench(gltf_path):
    with _torch_scene.reference_bench(gltf_path) as bench:
        yield bench


@pytest.fixture(scope="module")
def port(ref_bench, gltf_path):
    """The port's bench scene (its numpy build, as the reference's) and
    its prepared traversal arrays."""
    parts = tbench.build_scene(W, H, gltf=gltf_path, device="cpu")
    return parts, prepare_scene(parts[0])


def _args(gltf_path, *extra):
    return ["--width", str(W), "--height", str(H), "--gltf", gltf_path, "--device", "cpu",
            *extra]


def _run_reference_tool(script, argv, bench, patches=()):
    """tools/<script> as a script with `bench` as its bench module, jax.jit
    the identity, every pallas_call in interpret mode and each (module,
    name, value) of `patches` applied."""
    orig = pallas.pallas_call

    def pallas_call(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call", pallas_call)
        mp.setattr(jax, "jit", lambda f=None, **kw: f if f is not None else (lambda g: g))
        mp.setattr(sys, "argv", [str(TOOLS / script), *argv])
        mp.setattr(sys, "path", list(sys.path))
        mp.setitem(sys.modules, "bench", bench)
        for module, name, value in patches:
            mp.setattr(module, name, value)
        runpy.run_path(str(TOOLS / script), run_name="__main__")


# ------------------------------------------------------------ bisect_e2e
def test_bisect_configs_match_reference(ref_bench, port, gltf_path, capsys):
    from rfw_tpu.render import wavefront as jw

    seen = []

    def render_sample(*a, **k):
        seen.append(a[8])
        return types.SimpleNamespace(radiance=jnp.zeros(1))

    _run_reference_tool("bisect_e2e.py", ["--width", str(W), "--height", str(H), "--reps", "1"],
                        ref_bench, [(jw, "render_sample", render_sample)])
    ref = dict(zip(bisect_e2e.CONFIGS, seen[::2]))  # a warm-up and one rep each
    assert len(seen) == 6
    parts = port[0]
    got = bisect_e2e.configs(parts[1], parts[3])
    for name in bisect_e2e.CONFIGS:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(ref[name]), name
    capsys.readouterr()

    out = bisect_e2e.main(_args(gltf_path, "--reps", "1"))
    assert out["delta_bounce_block"] == out["anchor"] - out["b0"]
    assert out["delta_sobol"] == out["anchor"] - out["uniform"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))


# -------------------------------------------------------- bench_traverse
def test_bench_traverse_populations(ref_bench, port):
    from rfw_tpu.accel.lbvh import morton_codes
    from rfw_tpu.render.wavefront import _block_swizzle, camera_rays

    parts, ps = port
    pops = bench_traverse.populations(parts, ps, W, H)
    ref_scene = ref_bench.build_scene(W, H)
    px, py, _ = _block_swizzle(W, H, 1024)
    key = jax.random.PRNGKey(3)
    o_ref, d_ref = camera_rays(ref_scene[4], W, H, key, (px, py))
    o, d = pops["coherent"]
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=RTOL, atol=ATOL)

    # the bounce rays: the reference's composition on the port's hits
    hit = closest_hit(ps, o, d)
    oj, dj = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    pos = oj + jnp.where(jnp.asarray(hit.prim.numpy()) >= 0,
                         jnp.asarray(hit.t.numpy()), 1.0)[:, None] * dj
    k1, k2 = jax.random.split(key)
    z = jax.random.uniform(k1, (R,)) * 2 - 1
    phi = jax.random.uniform(k2, (R,)) * 2 * np.pi
    s = jnp.sqrt(jnp.maximum(1 - z * z, 0.0))
    d_inc = jnp.stack([s * jnp.cos(phi), s * jnp.sin(phi), z], axis=1)
    o_inc = pos + d_inc * 1e-3
    uo, ud = pops["unsorted"]
    np.testing.assert_allclose(ud.numpy(), np.asarray(d_inc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(uo.numpy(), np.asarray(o_inc), rtol=RTOL, atol=ATOL)

    # the sorted rays: the reference's sort of the port's unsorted rays
    o_inc, d_inc = jnp.asarray(uo.numpy()), jnp.asarray(ud.numpy())
    sc = ref_scene[0]
    octant = ((d_inc[:, 0] >= 0).astype(jnp.int32) + 2 * (d_inc[:, 1] >= 0).astype(jnp.int32)
              + 4 * (d_inc[:, 2] >= 0).astype(jnp.int32))
    cell = morton_codes(o_inc, sc.tlas_min[0], sc.tlas_max[0]).astype(jnp.int32)
    skey = octant * (1 << 27) + (cell >> 5)
    out = jax.lax.sort((skey, o_inc[:, 0], o_inc[:, 1], o_inc[:, 2],
                        d_inc[:, 0], d_inc[:, 1], d_inc[:, 2]), num_keys=1)
    so, sd = pops["sorted"]
    assert np.array_equal(so.numpy(), np.stack([np.asarray(x) for x in out[1:4]], 1))
    assert np.array_equal(sd.numpy(), np.stack([np.asarray(x) for x in out[4:7]], 1))
    assert len(np.unique(np.asarray(skey))) > 8  # the sort has work to do


def test_bench_traverse_main(port, gltf_path, capsys):
    out = bench_traverse.main(_args(gltf_path, "--reps", "1", "--occluded", "--tp-occluded",
                                    "--stats"))
    for case in bench_traverse.CASES:
        for call in ("closest", "occluded", "occl_cl_nee", "occl_tp_nee"):
            assert out[f"{case}.{call}"] > 0 and out[f"{case}.{call}_ms"] > 0
        assert out[f"{case}.occl_mismatch"] == 0
        assert out[f"{case}.nodes_mean"] >= 1
    # sorting reorders the same rays: the same per-ray counts
    assert out["sorted.tris_mean"] == out["unsorted.tris_mean"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["rays"] == R


# -------------------------------------------------------- check_traverse
def test_check_traverse_passes(gltf_path):
    out = check_traverse.main(_args(gltf_path, "--oracle-rays", "512"))
    assert out["ok"] and out["oracle_rays"] == 512
    assert out["oracle_mask_mismatch"] == 0 and out["occluded_mismatch"] == 0
    assert out["k1_vs_plain_ok"] and out["k2_vs_plain_identical"]
    assert out["oracle_t_rel_err_max"] < 1e-3


def test_check_traverse_fails_on_a_wrong_hit(gltf_path, monkeypatch):
    """The gate catches a walk that loses hits."""
    real = check_traverse.oracle

    def shifted(o, d, tris):
        t, p = real(o, d, tris)
        return t * 0.5, p

    monkeypatch.setattr(check_traverse, "oracle", shifted)
    out = check_traverse.main(_args(gltf_path, "--oracle-rays", "64"))
    assert not out["ok"] and not out["oracle_ok"]


# ----------------------------------------------------------- bench_items
@pytest.mark.parametrize("flags", [(), ("--fused",), ("--breakdown", "--pallas-A")],
                         ids=["twophase", "fused", "breakdown"])
def test_bench_items_agree(gltf_path, flags):
    out = bench_items.main(_args(gltf_path, "--reps", "1", *flags))
    assert out["mask_mismatch"] == 0 and out["t_mismatch"] == 0
    assert 0 <= out["trunc_frac"] <= 1
    if "--breakdown" in flags:
        assert out["A_entry_set_mismatch"] == 0 and out["occupied_slots"] > 0


# ------------------------------------------------------------- diag_live
def _live_b2(ps, o, d, hit):
    from rfw_tpu_torch.tools import bounce_rays

    o2, d2 = bounce_rays(o, d, hit)
    return closest_hit(ps, o2, d2, torch.where(hit.prim >= 0, 1e30, 0.0)).prim >= 0


def test_diag_live_matches_reference(ref_bench, port, gltf_path, capsys):
    """The reference tool prints its live shares (to stderr, 4 decimals)
    before its material split, whose real-hit stage calls the since
    changed `_shading_basis` and fails (IndexError) in the reference
    itself; the shares are read from those lines. The primaries' share is
    equal. The bounce rays start at the primaries' hit points, which the
    TPU kernel's t (within 1.5e-5 relative of an exact walk) places
    otherwise: the second share may differ by as many rays as flip when
    the port's hit t moves by 1.5e-5 relative either way."""
    with pytest.raises(IndexError):
        _run_reference_tool("diag_live.py",
                            ["--width", str(W), "--height", str(H), "--reps", "1"], ref_bench)
    err = capsys.readouterr().err
    ref = [float(line.rsplit(":", 1)[1]) for line in err.splitlines()
           if line.startswith(("primary hit fraction", "bounce-1 hit fraction"))]
    assert len(ref) == 2, err
    out = diag_live.main(_args(gltf_path, "--reps", "1"))
    assert 0 < out["live_b1"] < 1 and 0 < out["live_b2"] < 1
    assert round(out["live_b1"], 4) == ref[0]

    parts, ps = port
    o, d, _ = bench_traverse.primary_rays(parts[4], W, H)
    hit = closest_hit(ps, o, d)
    live = _live_b2(ps, o, d, hit)
    assert live.float().mean().item() == out["live_b2"]
    flips = max(int((_live_b2(ps, o, d, hit._replace(t=hit.t * f)) != live).sum())
                for f in (1 - 1.5e-5, 1 + 1.5e-5))
    assert abs(out["live_b2"] - ref[1]) * R <= flips + 0.5e-4 * R, (out["live_b2"], ref[1],
                                                                    flips)
    for k in ("mat_block", "one_bilinear", "two_bilinear", "mat_real_m5", "mat_real_m15"):
        assert out[k] > 0


# ----------------------------------------------------------- profile_e2e
def test_profile_e2e_reports_every_stage(gltf_path):
    out = profile_e2e.main(_args(gltf_path, "--reps", "1"))
    for k in ("render_sample(1b)", "trace_primary", "trace_occluded", "sort_pair",
              "shading_basis", "material+atlas", "light+disney", "camera+sobol2",
              "sobol_slot3", "v0_sort16", "out_sort4"):
        assert out[k] > 0, k
    assert out["device"] == "cpu" and out["card"].startswith("cpu")


def test_tools_need_a_card_unless_told(monkeypatch, gltf_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (bisect_e2e, profile_e2e, bench_traverse, bench_items, check_traverse,
                 diag_live):
        with pytest.raises(RuntimeError, match="cpu"):
            tool.main(["--width", "8", "--height", "8", "--gltf", gltf_path])
