"""The port's last six tools (rfw_tpu_torch.tools: profile_shading,
ubench_atlas, ubench_gather, bench_nee, profile_dynamics,
bench_fused_stages) on the CPU (`--device cpu`, the plain versions), at
32x32 on the small textured glTF of `_torch_scene.bench_gltf_doc`
(`--gltf`), as `tests/test_torch_tools.py` runs the other tools. Each
tool's `main([...])` runs and every stage or key it prints is there;
everything a tool prints that is not a time is held against the
reference or the port's own call:

  * bench_nee: `measure` against the reference's `tools/bench_nee.py::
    measure` (run as a script with the repository's bench.py loading the
    same glTF, Pallas in interpret mode) on 2 frames of the random
    sampler, whose threefry uniforms are the reference's bit for bit:
    var_mean and lum_mean within rtol 1e-5; each mode's child process ran
    with the RFW_POTENTIAL_MAX it was given; a child that fails makes the
    parent raise with its stderr;
  * bench_fused_stages: the call its stages are captured from returns the
    hits of `twophase_closest_with_fallback`, bit for bit;
  * profile_dynamics: on the procedural skinned glTF of
    `_torch_scene.gltf_doc` as its CesiumMan, the route it reports is the
    route TorchBackend's dirty skin sync takes on the CPU.
"""

import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas

import _torch_scene
from rfw_tpu_torch import bench as tbench
from rfw_tpu_torch.ops import traverse_items as ti
from rfw_tpu_torch.ops.traverse import prepare_scene
from rfw_tpu_torch.render.torch_backend import TorchBackend
from rfw_tpu_torch.tools import (
    bench_fused_stages, bench_nee, profile_dynamics, profile_shading, ubench_atlas,
    ubench_gather,
)
from rfw_tpu_torch.tools.bench_traverse import populations

TOOLS = Path(__file__).resolve().parent.parent / "tools"
W = H = 32
FRAMES = 2
#: a small item buffer, so that rays are truncated and the fallback runs
ITEMS_PER_RAY = 0.1


@pytest.fixture(scope="module")
def gltf_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("tools_shading") / "scene.gltf"
    path.write_text(json.dumps(_torch_scene.bench_gltf_doc()))
    return str(path)


def _args(gltf_path, *extra):
    return ["--width", str(W), "--height", str(H), "--gltf", gltf_path, "--device", "cpu",
            *map(str, extra)]


# ------------------------------------------------------ the shading tools
def test_profile_shading_reports_every_stage(gltf_path):
    out = profile_shading.main(_args(gltf_path, "--reps", 1, "--iters", 2))
    assert set(profile_shading.STAGES) >= {
        "gather_tri_shade", "gather_atlas", "basis_math", "sample_light", "disney_eval",
        "disney_pdf", "disney_sample", "sobol3", "sobol3_plain", "frame_tolocal"}
    for k in profile_shading.STAGES:
        assert out[k] > 0, k
    assert out["rays"] == W * H and out["card"].startswith("cpu")


def test_ubench_atlas_reports_every_stage(gltf_path):
    out = ubench_atlas.main(_args(gltf_path, "--reps", 1, "--iters", 2))
    for k in ubench_atlas.STAGES:
        assert out[k] > 0, k


@pytest.mark.parametrize("sweep", [None, "--sweep-size", "--sweep-width"],
                         ids=["gathers", "size", "width"])
def test_ubench_gather_reports_every_case(sweep):
    flags = ["--rays", "4096", "--reps", "1", "--shrink", "4096", "--device", "cpu"]
    out = ubench_gather.main(flags + ([sweep] if sweep else []))
    keys = {None: ubench_gather.GATHERS,
            "--sweep-size": [f"{name}_{loc}" for name, *_ in ubench_gather.sweep_cases()
                             for loc in ("rand", "sorted")],
            "--sweep-width": [f"f32x{c}_{form}" for c in ubench_gather.WIDTHS
                              for form in ubench_gather.FORMS]}[sweep]
    assert len(keys) == {None: 7, "--sweep-size": 20, "--sweep-width": 33}[sweep]
    for k in keys:
        assert out[k] > 0, k
    assert out["unit"] == ("ns/row" if sweep else "ms")


# ------------------------------------------------------------- bench_nee
@pytest.fixture(scope="module")
def nee_reference(gltf_path):
    """The reference's `measure` at 32x32 over 2 frames: the script run as
    `test_torch_tools.py` runs the reference tools (its bench module the
    repository's bench.py on the test glTF, every pallas_call in
    interpret mode)."""
    orig = pallas.pallas_call

    def pallas_call(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with _torch_scene.reference_bench(gltf_path) as bench, pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call", pallas_call)
        mp.setattr(sys, "path", list(sys.path))
        mp.setitem(sys.modules, "bench", bench)
        # the script's setdefault must not change this process's environment
        mp.setenv("JAX_COMPILATION_CACHE_DIR", jax.config.jax_compilation_cache_dir or "")
        ns = runpy.run_path(str(TOOLS / "bench_nee.py"), run_name="bench_nee_reference")
        return ns["measure"](W, H, FRAMES)


def test_bench_nee_measure_matches_reference(nee_reference, gltf_path):
    got = bench_nee.measure(W, H, FRAMES, gltf=gltf_path, device="cpu")
    var_mean, _, lum_mean, _ = nee_reference
    assert var_mean > 0 and lum_mean > 0
    np.testing.assert_allclose([got[0], got[2]], [var_mean, lum_mean], rtol=1e-5)
    assert np.isfinite(got).all() and got[3] > 0


def test_bench_nee_forks_each_mode(gltf_path):
    args = _args(gltf_path, "--frames", FRAMES)
    out = bench_nee.main(args)
    for mode, pm in (("potential", 16), ("power", 0)):
        child = out[mode]
        assert child["mode"] == mode and child["potential_max"] == pm
        for k in ("var_mean", "var_median", "lum_mean", "sec_frame"):
            assert np.isfinite(child[k]) and child[k] > 0, (mode, k)
    assert out["var_ratio_mean"] > 0 and out["var_ratio_median"] > 0
    sweep = bench_nee.main(args + ["--sweep", "--counts", "3"])["sweep"]
    assert [row["lights"] for row in sweep] == [3]
    row = sweep[0]
    assert row["potential"]["potential_max"] == 4096 and row["power"]["potential_max"] == 0
    assert row["potential"]["lights"] == row["power"]["lights"] == 3
    for k in ("var_ratio", "time_ratio", "efficiency_ratio"):
        assert row[k] > 0, k


def test_bench_nee_child_failure_raises(tmp_path):
    """The reference prints a failed child's stderr and drops its row; the
    port raises with it."""
    missing = str(tmp_path / "no_such_scene.gltf")
    with pytest.raises(RuntimeError, match="bench_nee child potential") as err:
        bench_nee.main(_args(missing, "--frames", FRAMES))
    assert "no_such_scene.gltf" in str(err.value)


# ---------------------------------------------------- bench_fused_stages
@pytest.fixture(scope="module")
def fused_rays(gltf_path):
    parts = tbench.build_scene(W, H, gltf=gltf_path, device="cpu")
    ps = prepare_scene(parts[0])
    o, d = populations(parts, ps, W, H)["sorted"]
    return ps, o, d, torch.full((W * H,), 1e30)


@pytest.mark.parametrize("k4", [False, True], ids=["dense", "k4"])
def test_fused_stages_capture_the_call(fused_rays, monkeypatch, k4):
    """The captured call returns the hits of the two-phase call itself,
    truncates rays and retraces them, and every stage is timed alone and
    bracketed."""
    if k4:
        monkeypatch.setattr(ti, "DENSE_A_MAX_INST", 0)
    ps, o, d, tl = fused_rays
    hit, calls = bench_fused_stages.capture(ps, o, d, tl, 8, ITEMS_PER_RAY)
    ref = ti.twophase_closest_with_fallback(ps, o, d, tl, K=8, items_per_ray=ITEMS_PER_RAY)
    for a, b in zip(hit, ref):
        assert torch.equal(a, b)
    assert [c[0] for c in calls] == ["_phase_a", "_pack", "items", "_merge_closest",
                                     "closest_hit"]
    ms = bench_fused_stages.isolated(calls, 1, torch.device("cpu"), k4)
    assert set(ms) == {"A.k4" if k4 else "A.dense", "B.pack", "C.items", "D.merge",
                       "E.fallback"}
    call = bench_fused_stages.stages(ps, o, d, tl, 8, ITEMS_PER_RAY, "cpu")
    labels = bench_fused_stages.STAGE_FNS
    assert set(call["stage_ms"]) == {labels[f] for f in labels if f != "dense_items"}
    assert call["truncated"] > 0 and call["retraced"] == call["truncated"]


@pytest.mark.parametrize("flags", [(), ("--pallas-A",)], ids=["dense", "k4"])
def test_fused_stages_main(gltf_path, flags):
    out = bench_fused_stages.main(_args(gltf_path, "--reps", 1, "--items-per-ray",
                                        ITEMS_PER_RAY, *flags))
    phase_a = "A.k4" if flags else "A.dense"
    for k in (phase_a, "B.pack", "C.items", "D.merge", "E.fallback"):
        assert out[k] > 0, k
    assert 0 < out["occupied_slots"] <= out["slots"] == int(np.ceil(W * H * ITEMS_PER_RAY))
    assert out["pallas_A"] == bool(flags) and out["bracketed"]["total_ms"] > 0


# ------------------------------------------------------ profile_dynamics
def test_profile_dynamics_reports_the_backend_route(tmp_path, monkeypatch):
    man = tmp_path / "CesiumMan"
    man.mkdir()
    (man / "CesiumMan.gltf").write_text(json.dumps(_torch_scene.gltf_doc()))
    out = profile_dynamics.main(["--assets", str(tmp_path), "--no-pica", "--size", "32x16",
                                 "--reps", "2", "--device", "cpu"])
    for k in ("lights_fields_ms", "lights_blob_ms", "dyn_sync_ms", "render_quiescent_ms",
              "render_dirty_ms"):
        assert out[k] > 0, k

    # the route of the same content's dirty skin sync, seen on the backend
    seen = []
    for name, route in (("_apply_device_dynamics", "device"), ("_rebuild_scene", "host")):
        def counted(self, *a, _fn=getattr(TorchBackend, name), _route=route, **k):
            seen.append(_route)
            return _fn(self, *a, **k)
        monkeypatch.setattr(TorchBackend, name, counted)
    app, backend, men = profile_dynamics.build(32, 16, str(tmp_path), False, torch.device("cpu"))
    app.render_frame()
    del seen[:]
    men[0].set_time(0.3)
    men[1].set_time(1.0)
    app.scene.synchronize(backend)
    assert seen in (["device"], ["host"])
    assert out["mode"] == seen[0] == "device"


def test_new_tools_need_a_card_unless_told(monkeypatch, gltf_path, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    size = ["--width", "8", "--height", "8", "--gltf", gltf_path]
    for tool, argv in ((profile_shading, size), (ubench_atlas, size),
                       (ubench_gather, ["--rays", "64"]), (bench_nee, size),
                       (bench_fused_stages, size),
                       (profile_dynamics, ["--assets", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="cpu"):
            tool.main(argv)
