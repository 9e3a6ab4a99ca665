"""ctypes bindings for the port's native host runtime (`native/src/bvh.cpp`).

Counterpart of `rfw_tpu/native/__init__.py`: the same C ABI (binned-SAH
build, refit, linear-blend skinning, the wide supernode collapse) and the
same Python names. The host build calls it by default, as `rfw_tpu`'s does:
`accel.bvh_cpu.build_bvh_sah` / `refit_bvh`, `render.pack.build_widen` and
`render.torch_backend.apply_skin`.

The library builds at first use, never at import: `CXX` (default `g++`)
with the reference Makefile's flags, into
`build/rfw_tpu_torch/<hash>/librfw_native.so` at the root of the checkout.
The hash covers the source, the compiler, its flags and the host's name
(`-march=native` code runs only on CPUs like the builder's). The compiler
writes a temporary name that is then renamed, so several processes may
build at once. Unlike `rfw_tpu`, which falls back to numpy silently, a
failed build raises with the compiler's stderr. The numpy paths run only
when the caller asks for them: `RFW_NO_NATIVE=1` (read at each call, the
variable `rfw_tpu` reads), or `build_bvh_sah(use_native=False)`, the
keyword of `rfw_tpu`'s signature.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shlex
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "bvh.cpp"
#: the build root the CUDA kernels share (`ops._build.BUILD_ROOT`)
BUILD_ROOT = SRC.parents[3] / "build" / "rfw_tpu_torch"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


class Built(NamedTuple):
    path: Path
    seconds: float  # spent in the compiler; 0.0 when the library was built
    log: str  # the compiler's stderr


def enabled(use_native: bool = True) -> bool:
    """Whether a host build call takes the native path: the caller asked
    for it and `RFW_NO_NATIVE` is not "1"."""
    return use_native and os.environ.get("RFW_NO_NATIVE") != "1"


def _cxx() -> list:
    return shlex.split(os.environ.get("CXX", "g++"))


def lib_path() -> Path:
    """Where the library of the current source, compiler and flags lives."""
    h = hashlib.sha256()
    h.update(SRC.read_bytes())
    h.update(" ".join(_cxx() + CXXFLAGS).encode())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "librfw_native.so"


def build() -> Built:
    """Compile the library unless it is built at its current hash."""
    lib = lib_path()
    if lib.exists():
        return Built(lib, 0.0, "")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f".{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [*_cxx(), *CXXFLAGS, "-o", str(tmp), str(SRC)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native build failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return Built(lib, time.perf_counter() - t0, proc.stderr)


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build().path))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.rfw_build_bvh_sah.restype = ctypes.c_int
        lib.rfw_build_bvh_sah.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, i32p, i32p, i32p, i32p,
        ]
        lib.rfw_refit_bvh.restype = None
        lib.rfw_refit_bvh.argtypes = [
            ctypes.c_int, f32p, f32p, i32p, i32p, i32p, i32p, f32p, f32p,
        ]
        lib.rfw_skin_positions.restype = None
        lib.rfw_skin_positions.argtypes = [ctypes.c_int, f32p, i32p, f32p, f32p, f32p]
        lib.rfw_build_wide8.restype = ctypes.c_int
        lib.rfw_build_wide8.argtypes = [
            ctypes.c_int, f32p, f32p, i32p, i32p, i32p, i32p,
            ctypes.c_int, ctypes.c_int, f32p, i32p, i32p,
        ]
        lib.rfw_build_widen.restype = ctypes.c_int
        lib.rfw_build_widen.argtypes = [
            ctypes.c_int, f32p, f32p, i32p, i32p, i32p, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, i32p, i32p,
        ]
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the host build takes the native path: False under
    `RFW_NO_NATIVE=1`; otherwise the library is built and loaded (a failed
    build raises)."""
    if not enabled():
        return False
    _load()
    return True


def build_bvh_sah_native(aabb_min: np.ndarray, aabb_max: np.ndarray, max_leaf: int = 4):
    """Native binned-SAH build -> BvhNodes; None for zero boxes (the numpy
    path's inverted root covers them)."""
    from rfw_tpu_torch.accel.bvh_cpu import BvhNodes

    n = aabb_min.shape[0]
    if n == 0:
        return None
    lib = _load()
    cap = max(2 * n, 2)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_left = np.zeros(cap, np.int32)
    node_right = np.zeros(cap, np.int32)
    node_count = np.zeros(cap, np.int32)
    order = np.empty(n, np.int32)
    n_nodes = lib.rfw_build_bvh_sah(
        np.ascontiguousarray(aabb_min, np.float32),
        np.ascontiguousarray(aabb_max, np.float32),
        n, max_leaf, node_min, node_max, node_left, node_right, node_count, order,
    )
    return BvhNodes(
        node_min=node_min[:n_nodes].copy(),
        node_max=node_max[:n_nodes].copy(),
        node_left=node_left[:n_nodes].copy(),
        node_right=node_right[:n_nodes].copy(),
        node_count=node_count[:n_nodes].copy(),
        prim_order=order,
    )


def refit_bvh_native(bvh, aabb_min: np.ndarray, aabb_max: np.ndarray) -> bool:
    """In-place native refit of `bvh`'s node bounds (its node_min/node_max
    must be C-contiguous float32); returns True."""
    _load().rfw_refit_bvh(
        bvh.num_nodes,
        bvh.node_min, bvh.node_max, bvh.node_left, bvh.node_right,
        bvh.node_count, bvh.prim_order,
        np.ascontiguousarray(aabb_min, np.float32),
        np.ascontiguousarray(aabb_max, np.float32),
    )
    return True


def build_widen_native(bvh, tlas: bool, leaf_base_offset: int = 0,
                       depth: int = 3, root: int = 0):
    """Native wide supernode collapse ((1<<depth)-ary, subtree at `root`)
    -> (box, code, cnt); None for a depth the library does not take
    (outside 1..5)."""
    lib = _load()
    arity = 1 << depth
    n = bvh.num_nodes
    box = np.empty((n, 6 * arity), np.float32)
    code = np.empty((n, arity), np.int32)
    cnt = np.empty((n, arity), np.int32)
    s = lib.rfw_build_widen(
        n,
        np.ascontiguousarray(bvh.node_min, np.float32),
        np.ascontiguousarray(bvh.node_max, np.float32),
        np.ascontiguousarray(bvh.node_left, np.int32),
        np.ascontiguousarray(bvh.node_right, np.int32),
        np.ascontiguousarray(bvh.node_count, np.int32),
        np.ascontiguousarray(bvh.prim_order, np.int32),
        int(tlas), leaf_base_offset, depth, root, box, code, cnt,
    )
    if s < 0:
        return None
    return box[:s].copy(), code[:s].copy(), cnt[:s].copy()


def build_wide8_native(bvh, tlas: bool, leaf_base_offset: int = 0):
    """Native 8-wide supernode collapse -> (box, code, cnt)."""
    return build_widen_native(bvh, tlas, leaf_base_offset, depth=3)


def skin_positions_native(
    positions: np.ndarray, joints: np.ndarray, weights: np.ndarray,
    joint_matrices: np.ndarray,
) -> np.ndarray:
    """Native linear-blend skinning of positions -> (V,3) float32."""
    lib = _load()
    n = positions.shape[0]
    out = np.empty((n, 3), np.float32)
    lib.rfw_skin_positions(
        n,
        np.ascontiguousarray(positions, np.float32),
        np.ascontiguousarray(joints, np.int32),
        np.ascontiguousarray(weights, np.float32),
        np.ascontiguousarray(joint_matrices.reshape(-1, 16), np.float32),
        out,
    )
    return out
