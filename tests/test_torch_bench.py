"""The port's benchmark entry point, rfw_tpu_torch/bench.py, against the
reference's bench.py.

The reference loads pica, which is not in the repository; here its
module global PICA points at a small textured glTF written by the test
(`_torch_scene.bench_gltf_doc`: a rotated, scaled parent node, the floor
mesh instanced twice), and the port gets the same file with `gltf=`.
Importing bench.py sets JAX_COMPILATION_CACHE_DIR; the fixture restores
the environment. Both packages pack with their numpy BVH builders
(RFW_NO_NATIVE=1), as tests/test_torch_pack.py compares them.

  * build_scene: every field of the TraceScene, materials, atlas and
    lights and the view bit for bit;
  * the timed loop at 32x18, 2 samples, the reference's own main() (its
    film captured at add_sample) against the port's sample_loop on the
    same config: the per-pixel film within tests/test_torch_wavefront.py's
    tolerance (99% of pixels within atol 1e-3 + rtol 1e-3 on every
    channel, the mean within 1e-3 relative);
  * main() on the CPU prints one line with the reference's keys and the
    port's, and its value follows the ray-count rule;
  * without --device cpu and without a card, main() raises.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import _torch_scene
from rfw_tpu_torch import bench as tbench

W, H = 32, 18
SPP = 2


@pytest.fixture(scope="module")
def gltf_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "scene.gltf"
    path.write_text(json.dumps(_torch_scene.bench_gltf_doc()))
    return str(path)


@pytest.fixture(scope="module")
def ref_bench(gltf_path):
    with _torch_scene.reference_bench(gltf_path) as bench:
        yield bench


def _same_fields(ref, got, names, what):
    for f in names:
        r, g = getattr(ref, f), getattr(got, f)
        if r is None or g is None:
            assert r is None and g is None, f"{what}.{f}"
            continue
        r = np.asarray(r)
        g = g.numpy()
        if r.dtype == np.uint32:
            g = g.view(np.uint32)
        assert r.dtype == g.dtype and r.shape == g.shape, f"{what}.{f}: {r.dtype}{r.shape} vs " \
                                                          f"{g.dtype}{g.shape}"
        assert np.array_equal(r, g), f"{what}.{f} differs"


@pytest.fixture(scope="module")
def scenes(ref_bench, gltf_path):
    ref = ref_bench.build_scene(W, H)
    got = tbench.build_scene(W, H, gltf=gltf_path, device="cpu")
    return ref, got


def test_build_scene_matches_reference(scenes):
    (r_sc, r_m, r_at, r_li, r_view), (sc, m, at, li, view) = scenes
    assert int((sc.inst_mesh >= 0).sum()) == 3  # the ribbon and the floor twice
    _same_fields(r_sc, sc, sc._fields, "TraceScene")
    _same_fields(r_m, m, [f.name for f in dataclasses.fields(m)], "DeviceMaterials")
    _same_fields(r_at, at, at._fields, "TextureAtlas")
    _same_fields(r_li, li, li._fields, "DeviceLights")
    assert view.dtype == torch.float32 and np.array_equal(np.asarray(r_view), view.numpy())


def test_sample_loop_matches_reference(ref_bench, scenes, monkeypatch, capsys):
    """bench.py's main() at 32x18, 2 samples (one warm-up), its film
    captured where it adds each sample, against the port's loop."""
    from rfw_tpu.render import film as jfilm

    films = []
    real_add = jfilm.add_sample

    def add_sample(accum, sample):
        out = real_add(accum, sample)
        films.append(np.asarray(out))
        return out

    monkeypatch.setattr(jfilm, "add_sample", add_sample)
    monkeypatch.setattr(sys, "argv", ["bench.py", "--width", str(W), "--height", str(H),
                                      "--spp", str(SPP)])
    ref_bench.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert len(films) == SPP

    parts = scenes[1]
    cfg = tbench.bench_config(parts[1], parts[3])
    film, seconds = tbench.sample_loop(parts, W, H, cfg, SPP)
    assert seconds > 0
    got, ref = film.numpy() / SPP, films[-1] / SPP
    assert got.shape == ref.shape == (W * H, 3) and np.isfinite(got).all()
    ok = (np.abs(got - ref) <= 1e-3 + 1e-3 * np.abs(ref)).all(axis=1)
    assert ok.mean() >= 0.99, ok.mean()
    assert ref.mean() > 0 and abs(got.mean() - ref.mean()) <= 1e-3 * ref.mean()
    # the loop adds SPP distinct samples: sample 1 alone is not half the film
    one, _ = tbench.sample_loop(parts, W, H, cfg, 1)
    assert not torch.allclose(one * SPP, film)


def test_bench_config_matches_reference(ref_bench, scenes):
    from rfw_tpu.render.wavefront import RenderConfig, mat_feature_mask, tex_kinds_mask

    r_m, r_li = scenes[0][1], scenes[0][3]
    ref = RenderConfig(max_bounces=1, clamp=20.0, sky_intensity=0.35, sort_secondary=True,
                       sampler="sobol", tex_mask=tex_kinds_mask(r_m.tex),
                       mat_features=mat_feature_mask(r_m),
                       has_area_lights=bool(np.asarray(r_li.n_area)[0] > 0), aovs=False)
    got = tbench.bench_config(scenes[1][1], scenes[1][3])
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_main_prints_one_line(capsys):
    """The acceptance run: the procedural flagship scene on the CPU."""
    out = tbench.main(["--device", "cpu", "--width", str(W), "--height", str(H),
                       "--spp", str(SPP), "--repeats", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(out))
    for k in ("metric", "value", "unit", "vs_baseline", "ms_per_sample", "ms_per_sample_all",
              "repeats", "spp", "scene", "two_phase", "peak_mem_mb", "setup_s", "device",
              "card", "film_mean", "film_finite"):
        assert k in line, k
    assert line["vs_baseline"] is None and line["unit"] == "Mrays/s"
    assert line["repeats"] == 2 and len(line["ms_per_sample_all"]) == 2
    assert "ms_per_sample_quartiles" not in line  # only beyond two repeats
    assert line["ms_per_sample"] == pytest.approx(np.median(line["ms_per_sample_all"]))
    rays = W * H * SPP * 2 * (1 + 1)
    assert line["value"] == pytest.approx(rays / (line["ms_per_sample"] * SPP * 1e-3) / 1e6,
                                          rel=1e-12)
    assert line["film_finite"] and line["film_mean"] > 0
    assert line["device"] == "cpu" and line["peak_mem_mb"] is None and line["setup_s"] > 0


def test_entry_point_needs_a_card_unless_told(monkeypatch, gltf_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        tbench.main(["--width", "8", "--height", "8", "--spp", "1", "--gltf", gltf_path])
    if not torch.backends.cuda.is_built():
        with pytest.raises((RuntimeError, AssertionError)):
            tbench.build_scene(8, 8, gltf=gltf_path)


def test_two_phase_off_traces_no_items(monkeypatch, gltf_path):
    """--two-phase off keeps the bounce rays on the classic walk: no
    two-phase call in a sample; "auto" makes one a bounce."""
    from rfw_tpu_torch.render import wavefront

    calls = []
    real = wavefront.twophase_closest_with_fallback
    monkeypatch.setattr(wavefront, "twophase_closest_with_fallback",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    parts = tbench.build_scene(W, H, gltf=gltf_path, device="cpu")
    for mode, n in (("off", 0), ("auto", 1)):
        calls.clear()
        tbench.sample(parts, W, H, tbench.bench_config(parts[1], parts[3], two_phase=mode), 1)
        assert len(calls) == n, mode
