"""The port imports without jax and without rfw_tpu.

The machine with the GPU has no jax installed, so every module of
rfw_tpu_torch (and chip_smoke.py) must import with `import jax` failing,
and none may import rfw_tpu, whose host modules reach jax through their
package __init__ files.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "rfw_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]

_NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "rfw_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
import rfw_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rfw_tpu_torch.__path__, "rfw_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "rfw_tpu") for m in sys.modules)
print(" ".join(names))
print("imported", len(names))
"""

#: modules that must be among those imported with jax blocked (the
#: backend layer and the host copies it needs, beside the renderer's)
MODULES = [
    "rfw_tpu_torch.backend.contract", "rfw_tpu_torch.backend.structs",
    "rfw_tpu_torch.backend.lights", "rfw_tpu_torch.models.mesh2d",
    "rfw_tpu_torch.models.mesh3d", "rfw_tpu_torch.models.primitives",
    "rfw_tpu_torch.utils.log", "rfw_tpu_torch.utils.timing",
    "rfw_tpu_torch.render.pack", "rfw_tpu_torch.render.overlay",
    "rfw_tpu_torch.render.fxaa", "rfw_tpu_torch.render.film",
    "rfw_tpu_torch.render.torch_backend", "rfw_tpu_torch.render.wavefront",
    "rfw_tpu_torch.convert", "rfw_tpu_torch.scenes",
]


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _NO_JAX], env=env, cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    n = int(lines[-1].split()[-1])
    assert n >= 20, out.stdout
    missing = set(MODULES) - set(lines[-2].split())
    assert not missing, missing


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_rfw_tpu_import(path):
    roots = {m.split(".")[0] for m in _imported_modules(path)}
    assert not roots & {"jax", "jaxlib", "rfw_tpu"}, roots


def test_importing_builds_nothing():
    """The CUDA build happens at first use only: importing the kernel
    modules loads no kernel library."""
    from rfw_tpu_torch.ops import _build, traverse, traverse_entries, traverse_items  # noqa: F401

    assert _build._LIBS == {}
