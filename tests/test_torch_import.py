"""The port imports without jax and without rfw_tpu.

The machine with the GPU has no jax installed, so every module of
rfw_tpu_torch (and chip_smoke.py and the examples' counterparts,
examples/torch_*.py) must import with `import jax` failing, and none may
import rfw_tpu, whose host modules reach jax through their package
__init__ files, nor the repository's bench.py (the reference's benchmark;
the port's is rfw_tpu_torch.bench). Pillow may be absent there too: every module imports with
PIL blocked (texture decoding and the font rasterizer import it inside the
function that needs it; frames are encoded by utils/png.py).
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "rfw_tpu_torch"
EXAMPLES = sorted((REPO / "examples").glob("torch_*.py"))
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] + EXAMPLES

_NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "rfw_tpu", "bench"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
sys.modules["PIL"] = None  # importing a module must not need PIL either
import rfw_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rfw_tpu_torch.__path__, "rfw_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
for n in EXAMPLES:
    importlib.import_module(f"examples.{n}")
assert not any(m.split(".")[0] in ("jax", "rfw_tpu", "bench") for m in sys.modules)
print(" ".join(names))
print("imported", len(names))
"""

#: modules that must be among those imported with jax blocked (the
#: backend layer and the host copies it needs, the scene and app layer,
#: the loaders, the font plugin and the numpy oracle, the device
#: dynamics and the threefry sampler, the scale-out layer and the PNG
#: writer, the native host runtime, the packet and lockstep tiers and
#: the device LBVH, beside the renderer's)
MODULES = [
    "rfw_tpu_torch.backend.contract", "rfw_tpu_torch.backend.structs",
    "rfw_tpu_torch.backend.lights", "rfw_tpu_torch.models.mesh2d",
    "rfw_tpu_torch.models.mesh3d", "rfw_tpu_torch.models.primitives",
    "rfw_tpu_torch.utils.log", "rfw_tpu_torch.utils.timing",
    "rfw_tpu_torch.render.pack", "rfw_tpu_torch.render.overlay",
    "rfw_tpu_torch.render.fxaa", "rfw_tpu_torch.render.film",
    "rfw_tpu_torch.render.torch_backend", "rfw_tpu_torch.render.wavefront",
    "rfw_tpu_torch.convert", "rfw_tpu_torch.scenes",
    "rfw_tpu_torch.utils.collections", "rfw_tpu_torch.utils.track",
    "rfw_tpu_torch.utils.task", "rfw_tpu_torch.utils.physics",
    "rfw_tpu_torch.mathx.transform", "rfw_tpu_torch.mathx.aabb",
    "rfw_tpu_torch.scene.materials", "rfw_tpu_torch.scene.descriptor",
    "rfw_tpu_torch.scene.instances", "rfw_tpu_torch.scene.camera",
    "rfw_tpu_torch.scene.lights", "rfw_tpu_torch.scene.graph",
    "rfw_tpu_torch.scene.scene", "rfw_tpu_torch.scene.serialize",
    "rfw_tpu_torch.loaders", "rfw_tpu_torch.loaders.obj", "rfw_tpu_torch.loaders.gltf",
    "rfw_tpu_torch.app", "rfw_tpu_torch.app.ecs", "rfw_tpu_torch.app.events",
    "rfw_tpu_torch.app.input", "rfw_tpu_torch.app.timer", "rfw_tpu_torch.app.instance",
    "rfw_tpu_torch.app.window", "rfw_tpu_torch.font", "rfw_tpu_torch.font.plugin",
    "rfw_tpu_torch.render.cpu_reference",
    "rfw_tpu_torch.render.refit_device", "rfw_tpu_torch.render.threefry",
    "rfw_tpu_torch.accel.tlas_device", "rfw_tpu_torch.accel.lbvh",
    "rfw_tpu_torch.parallel", "rfw_tpu_torch.parallel.mesh",
    "rfw_tpu_torch.parallel.distributed", "rfw_tpu_torch.utils.png",
    "rfw_tpu_torch.native", "rfw_tpu_torch.render.packet",
    "rfw_tpu_torch.render.intersect", "rfw_tpu_torch.render.twophase",
    "rfw_tpu_torch.ops", "rfw_tpu_torch.bench", "rfw_tpu_torch.tools.bisect_e2e",
    "rfw_tpu_torch.tools.profile_e2e", "rfw_tpu_torch.tools.bench_traverse",
    "rfw_tpu_torch.tools.bench_items", "rfw_tpu_torch.tools.check_traverse",
    "rfw_tpu_torch.tools.diag_live", "rfw_tpu_torch.tools.bench_nee",
    "rfw_tpu_torch.tools.profile_shading", "rfw_tpu_torch.tools.ubench_atlas",
    "rfw_tpu_torch.tools.ubench_gather", "rfw_tpu_torch.tools.profile_dynamics",
    "rfw_tpu_torch.tools.bench_fused_stages",
]


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = _NO_JAX.replace("EXAMPLES", repr([p.stem for p in EXAMPLES]))
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=str(REPO),
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
    assert not roots & {"jax", "jaxlib", "rfw_tpu", "bench"}, roots


def test_importing_builds_nothing():
    """The CUDA and the native builds happen at first use only: importing
    the modules loads no kernel library and no native library."""
    script = (
        "import rfw_tpu_torch.ops, rfw_tpu_torch.native\n"
        "from rfw_tpu_torch.ops import _build, traverse, traverse_entries, traverse_items\n"
        "from rfw_tpu_torch.render import pack, packet, intersect, twophase, wavefront\n"
        "from rfw_tpu_torch.accel import bvh_cpu, lbvh\n"
        "assert _build._LIBS == {} and rfw_tpu_torch.native._LIB is None\n")
    out = subprocess.run([sys.executable, "-c", script], env=dict(os.environ, PYTHONPATH=str(REPO)),
                         cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
