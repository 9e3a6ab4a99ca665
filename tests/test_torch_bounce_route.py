"""The route of a bounce vertex's closest hits (`render/wavefront.py::
_bounce_two_phase`) and the counter that records it.

`two_phase="auto"` takes the two-phase path for a scene on the CPU, as
`rfw_tpu` does, and the classic kernel K1 for a scene on the card, where it
is the faster route; "on", "off" and RFW_TWO_PHASE ("1" on, anything else
off) decide alike on either device. The rule reads the device as a plain
value, so the CPU holds it for both. Under a torch profiler each bounce
vertex adds `int(classic)` to `route.classic_bounce`.

The `*_on_card` tests need a card (they skip here): a 1080p "auto" sample
there equals the "off" sample bit for bit, enters no `rfw.trace.phase_a`
and counts its one bounce in `route.classic_bounce`. Where the card is,
run them without this directory's conftest, which imports JAX:
`python -m pytest --noconftest tests/test_torch_bounce_route.py`.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_scene
from rfw_tpu_torch.convert import from_numpy_scene
from rfw_tpu_torch.render import wavefront as tw
from rfw_tpu_torch.utils import trace

W = H = 32
BOUNCES = 2


@pytest.mark.parametrize("env", [None, "1", "0"])
@pytest.mark.parametrize("two_phase", ["auto", "on", "off"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_bounce_route_rule(monkeypatch, device, two_phase, env):
    if env is None:
        monkeypatch.delenv("RFW_TWO_PHASE", raising=False)
        want = two_phase == "on" or (two_phase == "auto" and device == "cpu")
    else:
        monkeypatch.setenv("RFW_TWO_PHASE", env)
        want = env == "1"
    cfg = tw.RenderConfig(two_phase=two_phase)
    dev = torch.device(device)
    assert tw._bounce_two_phase(cfg, tw.Tier("kernel", 256, True), dev) is want
    # a tier that forbids two-phase (the Pallas names off the 1,024 grain) never takes it
    assert tw._bounce_two_phase(cfg, tw.Tier("kernel", 256, False), dev) is False


@pytest.fixture(scope="module")
def small():
    mp = pytest.MonkeyPatch()
    mp.setenv("RFW_NO_NATIVE", "1")
    try:
        sc, mats, lights, atlas, camera = _torch_scene.build("rfw_tpu_torch", seed=1)
    finally:
        mp.undo()
    return (*from_numpy_scene(sc, mats, lights, atlas, "cpu"), mats, camera)


def _traced_sample(small, two_phase):
    """One CPU sample under a profiler: (its frame record's counts, the
    names of its rfw.trace.* spans)."""
    scene, mats, lights, atlas, mats_np, camera = small
    cfg = tw.RenderConfig(max_bounces=BOUNCES, sampler="sobol", two_phase=two_phase,
                          tex_mask=tw.tex_kinds_mask(mats_np.tex),
                          mat_features=tw.mat_feature_mask(mats_np))
    view = torch.from_numpy(camera.get_view(W, H).as_array())
    with _torch_scene.one_torch_thread(), profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.end_frame()  # the counts start anew
        tw.render_sample(scene, mats, atlas, lights, view, W, H, cfg, sample_index=1)
        trace.end_frame()
    spans = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.is_user_annotation() and e.name().startswith("rfw.trace."))
    return trace.frames()[-1]["counts"], spans


@pytest.mark.parametrize("two_phase,classic", [("off", BOUNCES), ("auto", 0), ("on", 0)])
def test_classic_bounce_counter_on_cpu(monkeypatch, small, two_phase, classic):
    monkeypatch.delenv("RFW_TWO_PHASE", raising=False)
    monkeypatch.setattr(trace, "_frames", collections.deque(maxlen=trace.FRAMES_KEPT))
    counts, spans = _traced_sample(small, two_phase)
    assert counts["route.classic_bounce"] == classic
    # "auto" keeps rfw_tpu's route on the CPU: a two-phase call each bounce
    assert spans["rfw.trace.phase_a"] == BOUNCES - classic
    assert ("tp.truncated" in counts) is (classic == 0)


def _card_sample(two_phase, traced=False):
    """Sample 1 of the bench's 1080p flagship on the card: (its radiance,
    the names of the rfw.trace.* spans it entered, its counts), the last
    two None untraced."""
    from rfw_tpu_torch import bench

    parts = bench.build_scene(1920, 1080, device="cuda")
    cfg = bench.bench_config(parts[1], parts[3], two_phase=two_phase)
    bench.sample(parts, 1920, 1080, cfg, 0)  # warm-up: the kernels build
    torch.cuda.synchronize()
    if not traced:
        return bench.sample(parts, 1920, 1080, cfg, 1).radiance, None, None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trace.end_frame()  # the counts start anew
        r = bench.sample(parts, 1920, 1080, cfg, 1).radiance
        torch.cuda.synchronize()
        trace.end_frame()
    spans = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.is_user_annotation() and e.name().startswith("rfw.trace."))
    return r, spans, trace.frames()[-1]["counts"]


def test_auto_equals_off_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: on the CPU \"auto\" takes the two-phase route")
    monkeypatch.delenv("RFW_TWO_PHASE", raising=False)
    auto, *_ = _card_sample("auto")
    off, *_ = _card_sample("off")
    assert auto.device.type == "cuda"
    assert torch.equal(auto, off)


def test_auto_enters_no_phase_a_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: on the CPU \"auto\" takes the two-phase route")
    monkeypatch.delenv("RFW_TWO_PHASE", raising=False)
    monkeypatch.setattr(trace, "_frames", collections.deque(maxlen=trace.FRAMES_KEPT))
    _, spans, counts = _card_sample("auto", traced=True)
    assert spans["rfw.trace.closest"] >= 2  # vertex 0 and the bounce through K1
    assert spans["rfw.trace.phase_a"] == 0 and spans["rfw.trace.phase_b"] == 0, spans
    assert spans["rfw.trace.fallback"] == 0, spans
    assert counts["route.classic_bounce"] == 1, counts  # the bench's 1 bounce
    assert "tp.truncated" not in counts and "tp.retraced" not in counts, counts
