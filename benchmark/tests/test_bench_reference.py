"""The reference against the port's plain path on the CPU at a tiny size:
the radiance of one sample per pixel, and the judged frames of whole runs
(a test may import both)."""

import numpy as np
import pytest
import torch

from benchmark import harness, judge, scene
from benchmark.reference import Reference

from ._tiny import SEED, run, tiny


def _spec(workload):
    with tiny():
        _, cell, cfg, traffic, gen = harness.load_cell(workload)
    return gen.build(SEED, cfg), traffic


@pytest.mark.parametrize("workload", ["flagship-still", "heavy10k-bounce"])
def test_one_sample_per_pixel_agrees_with_the_backend(workload):
    from rfw_tpu_torch.render.torch_backend import TorchBackend, TorchSettings

    spec, traffic = _spec(workload)
    be = TorchBackend(spec.width, spec.height, TorchSettings(**spec.settings), device="cpu")
    scene.feed(spec, be)
    traffic.apply(be, spec, 5)
    be.synchronize()
    be.render(None, scene.camera(spec))
    prog = torch.from_numpy(be.hdr_frame().reshape(-1, 3))
    ref = Reference(spec, "cpu")
    ref.set_instances(traffic.scene_at(spec, 5).instances)
    pid = torch.arange(spec.width * spec.height)
    want = ref.radiance(pid, torch.zeros_like(pid))
    close = torch.isclose(prog, want, rtol=1e-4, atol=1e-5).all(dim=1)
    # a path whose hit differs by rounding at an edge may diverge; no more
    # than 1% of them
    assert close.float().mean() >= 0.99, close.float().mean()
    assert (prog.sum(1) > 0).float().mean() > 0.5  # the frame is not black


@pytest.mark.parametrize("workload", ["flagship-still", "heavy10k-still", "heavy10k-bounce"])
def test_runs_are_judged_correct(workload):
    result, info = run(workload, seconds=0.4)
    assert result["correct"], info
    assert info["judged"]["off_pct"] <= 1.0
    assert list(result)[-1] == "checks"


def test_still_film_accumulates_every_sample():
    spec, traffic = _spec("flagship-still")
    pixels = judge.pick_pixels(SEED, spec.width, spec.height, 16)
    one = judge.expected(spec, traffic, pixels, [0, 3], "cpu")
    ref = Reference(spec, "cpu")
    ref.set_instances(spec.instances)
    pid = torch.as_tensor(pixels)
    acc = sum(ref.radiance(pid, torch.full_like(pid, s)) for s in range(4))
    assert np.array_equal(one[1], judge.tonemap(acc, 4))
    assert np.array_equal(one[0], judge.tonemap(ref.radiance(pid, torch.zeros_like(pid)), 1))
