"""Build and load the port's CUDA kernels.

Each `rfw_tpu_torch/csrc/<name>.cu` compiles with nvcc for Hopper
(`sm_90a`) into its own shared library with a plain C interface, loaded
with ctypes. `build()` starts one nvcc per source, all at once, and waits
for them; `load_library(name)` builds what is missing and loads one
library. The build happens at first use, never at import, into
`build/rfw_tpu_torch/<hash>/` at the root of the checkout; the hash covers
the source, the shared headers (`csrc/*.cuh`) and the compiler flags, so a
changed source builds anew and an unchanged one is reused. A failed nvcc
raises with its stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "rfw_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_p, _i, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
#: C entry points per source: function name -> argtypes (each returns int)
SIGNATURES = {
    "traverse": {
        "rfw_traverse": [
            _i, _i,  # any_hit, arity
            _p, _i,  # nodes, n_nodes
            _p, _i,  # tris, n_tri_rows
            _p, _i,  # insts, n_inst
            _p, _i,  # roots, tlas_root
            _p, _p, _p, _i,  # ray_o, ray_d, t_limit, n_rays
            _p, _p, _p, _p, _p,  # out_t, out_prim, out_inst, out_u, out_v
            _p,  # out_occluded
            _p, _p, _p,  # next_ray (2 int32), out_stats, warp_ns
            _p,  # stream
        ],
        "rfw_traverse_info": [_i, _i, _i, _i, _p],  # any_hit, stats, arity, n_rays, out[8]
    },
    "traverse_items": {
        "rfw_items": [
            _i, _i,  # any_hit, arity
            _p, _i,  # nodes, n_nodes
            _p, _i,  # tris, n_tri_rows
            _p, _i,  # insts, n_inst
            _p,  # roots
            _p,  # item_inst
            _p, _p, _p, _i,  # ray_o, ray_d, t_limit, n_items
            _p, _p, _p, _p, _p,  # out_t, out_prim, out_inst, out_u, out_v
            _p,  # out_occluded
            _p, _p, _p,  # next_item (2 int32), out_stats, warp_ns
            _p,  # stream
        ],
        "rfw_items_info": [_i, _i, _i, _i, _p],  # any_hit, stats, arity, n_items, out[8]
        "rfw_dense_items": [
            _i,  # any_hit
            _p, _i,  # tris, n_tri_rows
            _p, _i,  # insts, n_inst
            _p, _p,  # tlo, thi
            _p, _p,  # tbox, tcount
            _p,  # item_inst
            _p, _p, _p, _i,  # ray_o, ray_d, t_limit, n_items
            _p, _p, _p, _p, _p,  # out_t, out_prim, out_inst, out_u, out_v
            _p,  # out_occluded
            _p, _p,  # out_stats, warp_ns
            _p,  # stream
        ],
        "rfw_dense_items_info": [_i, _i, _i, _p],  # any_hit, stats, n_items, out[8]
    },
    "traverse_entries": {
        "rfw_tlas_entries": [
            _i, _i,  # K, arity
            _p, _i,  # nodes, n_nodes
            _i,  # tlas_root
            _p, _p, _p, _i,  # ray_o, ray_d, t_limit, n_rays
            _p, _p,  # out_t (R,K), out_inst (R,K)
            _p, _p, _p,  # next_ray (2 int32), out_stats, warp_ns
            _p,  # stream
        ],
        "rfw_tlas_entries_info": [_i, _i, _i, _i, _p],  # K, stats, arity, n_rays, out[8]
    },
    "sampler": {
        "rfw_sobol_slot": [
            _i,  # n (2 or 3)
            _p, _p,  # pixel_id (R,) int32, index_lanes (R,) uint32 or null
            _u, _u,  # index, slot
            _i,  # n_lanes
            _p,  # out (R, n) float32
            _p,  # stream
        ],
    },
    "ubench_leaf": {
        "rfw_ubench_leaf": [
            _i,  # variant
            _p, _i,  # tris, n_rows
            _p,  # obj (9, 8, 128)
            _i, _i,  # iters, copies
            _p, _p,  # out_t, out_aux (copies, 8, 128)
            _p,  # stream
        ],
    },
    "ubench_grid": {
        "rfw_ubench_grid": [
            _i,  # variant
            _p, _i,  # nodes, n_nodes
            _p, _i,  # tris, n_tri_rows
            _p, _i,  # insts, n_inst
            _p, _i,  # roots, tlas_root
            _p, _p, _p, _i,  # ray_o, ray_d, t_limit, n_rays
            _p, _p, _p, _p, _p,  # out_t, out_prim, out_inst, out_u, out_v
            _p,  # stream
        ],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


class Built(NamedTuple):
    name: str
    path: Path
    seconds: float  # spent in nvcc; 0.0 when the library was already built
    log: str  # nvcc's stderr: the ptxas register/spill report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for s in [src, *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    if not src.exists():
        raise RuntimeError(f"no CUDA source {src}")
    return BUILD_ROOT / _digest(src) / f"librfw_{name}.so"


def build(names=None) -> List[Built]:
    """Compile the named sources (default: every `csrc/*.cu`) that are not
    built at their current hash, one nvcc process each, all in parallel."""
    if names is None:
        names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    done, running = [], []
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            log = lib.parent / f"{name}.log"
            done.append(Built(name, lib, 0.0, log.read_text() if log.exists() else ""))
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.parent / f".{lib.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        running.append((name, lib, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, lib, tmp, cmd, proc, t0 in running:
        _, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
            continue
        (lib.parent / f"{name}.log").write_text(err)
        os.replace(tmp, lib)
        done.append(Built(name, lib, seconds, err))
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library of `csrc/<name>.cu` (built at first call),
    with restype and argtypes set on each of its C entry points."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build([name])[0].path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = _i
        f.argtypes = argtypes
    _LIBS[name] = lib
    return lib
