"""The import guard, by whole top-level names: no module the benchmark runs
may load jax, jaxlib, flax or rfw_tpu (the JAX package), and the reference
loads nothing of the program either. `rfw_tpu_torch` begins with
`rfw_tpu`, so a prefix match would wrongly catch it."""

import subprocess
import sys

import pytest

from benchmark import harness

REPO = harness.HERE.parent

BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def __init__(self, names): self.names = names
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block({names!r}))
sys.path.insert(0, {repo!r})
"""


@pytest.mark.parametrize("name,caught", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("rfw_tpu", True), ("rfw_tpu.render.wavefront", True),
    ("rfw_tpu_torch", False), ("rfw_tpu_torch.render.torch_backend", False),
    ("jaxtyping", False), ("numpy", False),
])
def test_guard_compares_whole_top_level_names(name, caught):
    assert harness.forbidden_modules([name]) == ([name] if caught else [])


def _run(code: str, blocked) -> subprocess.CompletedProcess:
    src = BLOCKER.format(names=set(blocked), repo=str(REPO)) + code
    return subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                          timeout=240, cwd=str(REPO))


def test_reference_and_judge_load_nothing_of_the_program():
    code = """
from benchmark import judge, reference, scene, stats, roofline, traffic_gen
from benchmark.laws import bounce, static
from benchmark.configs import flagship, heavy10k
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("rfw_tpu_torch", "rfw_tpu", "jax"))
print("BAD", bad)
"""
    r = _run(code, ("rfw_tpu_torch", "rfw_tpu", "jax", "jaxlib", "flax"))
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout


def test_a_whole_run_loads_no_jax_and_no_rfw_tpu():
    code = """
import time, torch
from benchmark import harness
from benchmark.tests._tiny import run
result, info = run("heavy10k-bounce", seconds=0.3)
assert result["correct"], info
print("FOUND", harness.forbidden_modules())
"""
    r = _run(code, ("rfw_tpu", "jax", "jaxlib", "flax"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOUND []" in r.stdout
