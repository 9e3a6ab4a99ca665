"""The judge's control and faults, on the CPU at a tiny size.

The control (the reference in bfloat16 put in the program's place) has to
fail each cell's limit, in both of its forms: the film summed in bfloat16,
and in float32. Then whole runs, past the harness's look for a
card, with the timed path broken underneath, have to come out not correct:
a step that returns its state unchanged (the film never takes the sample;
the motion sync leaves the instances where they were), half of the batch
left out (half the pixels' radiance dropped), and an answer altered where
it is produced (the sample's radiance off by 5%). The cells run on one card,
so no exchange between cards can be left out."""

import pytest

from benchmark import control

from ._tiny import CPU, SEED, run, tiny

CELLS = ["flagship-still", "heavy10k-still", "heavy10k-bounce"]


@pytest.mark.parametrize("workload,form", [(w, f) for w in CELLS for f in control.FORMS])
def test_control_fails_the_limit(workload, form):
    with tiny():
        forms, lim = control.control(workload, SEED, 16, CPU)
    assert forms[form]["off_pct"] > lim["off_pct"], forms


def _film_unchanged(monkeypatch):
    from rfw_tpu_torch.render import film

    monkeypatch.setattr(film, "add_sample", lambda accum, sample: accum)


def _half_dropped(monkeypatch):
    from rfw_tpu_torch.render import torch_backend

    real = torch_backend.render_sample

    def half(*a, **k):
        res = real(*a, **k)
        rad = res.radiance.clone()
        rad[: rad.shape[0] // 2] = 0.0
        return res._replace(radiance=rad)

    monkeypatch.setattr(torch_backend, "render_sample", half)


def _altered(monkeypatch):
    from rfw_tpu_torch.render import torch_backend

    real = torch_backend.render_sample
    monkeypatch.setattr(torch_backend, "render_sample",
                        lambda *a, **k: (lambda r: r._replace(radiance=r.radiance * 1.05))(
                            real(*a, **k)))


def _motion_dropped(monkeypatch):
    from rfw_tpu_torch.render import refit_device

    monkeypatch.setattr(refit_device, "instance_motion_update", lambda scene, *a, **k: scene)


FAULTS = {"film_unchanged": _film_unchanged, "half_dropped": _half_dropped,
          "altered": _altered, "motion_dropped": _motion_dropped}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in FAULTS if f != "motion_dropped" or w == "heavy10k-bounce"])
def test_fault_makes_the_run_not_correct(monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch)
    result, info = run(workload, seconds=0.3)
    assert not result["correct"], info["judged"]


def test_sound_bounce_run_takes_the_device_motion_route(monkeypatch):
    from rfw_tpu_torch.render import refit_device

    calls = []
    real = refit_device.instance_motion_update
    monkeypatch.setattr(refit_device, "instance_motion_update",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    result, info = run("heavy10k-bounce", seconds=0.3)
    assert result["correct"], info
    assert len(calls) >= info["frames"]
