"""Build and load the port's CUDA kernels.

`load_library()` compiles every `rfw_tpu_torch/csrc/*.cu` with nvcc for
Hopper (`sm_90a`) into one shared library with a plain C interface, and
loads it with ctypes. The build happens at first use, never at import, into
`build/rfw_tpu_torch/<hash>/` at the root of the checkout; the hash covers
the sources and the compiler flags, so a changed source builds anew and an
unchanged one is reused. A failed nvcc raises with its stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "rfw_tpu_torch"
LIB_NAME = "librfw_tpu_torch_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB: Optional[ctypes.CDLL] = None


class Built(NamedTuple):
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


def _sources():
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Built:
    """Compile the kernels unless this source hash is built already."""
    srcs = _sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        log = out_dir / "build.log"
        return Built(lib_path, 0.0, log.read_text() if log.exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(s) for s in srcs]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    (out_dir / "build.log").write_text(proc.stderr)
    os.replace(tmp, lib_path)
    return Built(lib_path, seconds, proc.stderr)


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build().path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rfw_traverse.restype = i
    lib.rfw_traverse.argtypes = [
        i,  # any_hit
        p, i,  # nodes, n_nodes
        p, i,  # tris, n_tri_rows
        p, i,  # insts, n_inst
        p, i,  # roots, tlas_root
        p, p, p, i,  # ray_o, ray_d, t_limit, n_rays
        p, p, p, p, p,  # out_t, out_prim, out_inst, out_u, out_v
        p,  # out_occluded
        p,  # stream
    ]
    _LIB = lib
    return _LIB
