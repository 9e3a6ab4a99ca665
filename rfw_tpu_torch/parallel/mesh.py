"""Scale-out over a device mesh: film strips, samples, or both.

Counterpart of `rfw_tpu/parallel/mesh.py`, in `torch.distributed`'s idiom.
One process drives one device: rank r renders on `cuda:(local rank %
device_count)` (or on the CPU over gloo when the caller names
`device="cpu"`). A JAX `Mesh` becomes a `DeviceMesh` with named dims, and
a sharded `jax.Array` a `DTensor` (`Shard(0)` over the film dim,
`Replicate()` over the others), so `.full_tensor()` gives the frame as
`np.asarray` gives the JAX array's.

Three strategies, as in the JAX package:
  * film strips (`render_sample_sharded`): each rank renders rows
    [row0, row0 + height / n) of the frame by `render_sample(row0=)`, with
    the same key; no collective;
  * samples (`render_spp_sharded`): each rank renders full frames for its
    share of `threefry.split(key, spp)`, then one SUM all-reduce;
  * both (`render_sharded_2d` on an (spp, film) mesh): strips of the
    rank's share of the samples, reduced over the spp dim only.

Under `sampler="sobol"` every strategy equals the sequential render bit
for bit up to the reduction's rounding (pixel-keyed uniforms). The random
sampler draws per lane of the call, so a strip draws its own lanes'
uniforms: the sharded random frame is the concatenation of the strips'
`render_sample(row0=...)` calls under the same key, an unbiased estimate
of the same image, not the single-call frame (`rfw_tpu`'s one SPMD
program draws the whole frame's lanes; its `render_sharded_2d` has the
strips' behaviour).

Without an initialised process group, `film_mesh` and `mesh_2d` make a
one-rank group on a free local port (NCCL on the card, gloo only for
`device="cpu"`), so single-process code runs the path a one-device JAX
mesh runs.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard


def rank_device(device=None) -> torch.device:
    """The device this rank drives: the CPU when the caller names it, else
    `cuda:(local rank % device_count)`. Raises where there is no card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the scale-out layer runs on CUDA devices and none is available; "
            "pass device='cpu' to run over gloo on the host")
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ensure_group(device: torch.device) -> None:
    """A one-rank process group on a free local port when none exists."""
    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if device.type == "cpu" else "nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)


def _mesh(shape: tuple, names: tuple, device) -> DeviceMesh:
    dev = rank_device(device)
    _ensure_group(dev)
    n = int(np.prod(shape))
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks {shape} over a world of "
                         f"{dist.get_world_size()}: one rank drives one device")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def film_mesh(n_devices: Optional[int] = None, axis: str = "film",
              device=None) -> DeviceMesh:
    """1-D mesh over film strips, one rank per device (the world's size
    when `n_devices` is None)."""
    n = dist.get_world_size() if n_devices is None and dist.is_initialized() else n_devices
    return _mesh((n or 1,), (axis,), device)


def mesh_2d(n_spp: int, n_film: int, device=None) -> DeviceMesh:
    """2-D (spp, film) mesh: samples x film strips."""
    return _mesh((n_spp, n_film), ("spp", "film"), device)


def _device_of(mesh: DeviceMesh) -> torch.device:
    return rank_device("cpu" if mesh.device_type == "cpu" else None)


def _tree_map(fn, tree):
    """fn over the array leaves (tensors, numpy arrays) of a dict,
    NamedTuple, dataclass, list or tuple; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"no array leaves in {type(tree).__name__}")


def _to_device(tree, dev: torch.device):
    from rfw_tpu_torch.convert import to_tensor

    return _tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor)
                     else to_tensor(a, dev), tree)


def _dim_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _placements(mesh: DeviceMesh, axis: Optional[str]) -> list:
    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def _sharded(mesh: DeviceMesh, local: torch.Tensor, axis: str) -> DTensor:
    """This rank's rows as its shard of a DTensor split over `axis`, the
    ranks' rows concatenated in rank order."""
    local = local.contiguous()
    n = _dim_size(mesh, axis)
    return DTensor.from_local(local, mesh, _placements(mesh, axis), run_check=False,
                              shape=torch.Size((local.shape[0] * n, *local.shape[1:])),
                              stride=local.stride())


def shard_rays(mesh: DeviceMesh, *tensors: torch.Tensor, axis: str = "film"):
    """Per-ray tensors (the same full tensor on every rank) as DTensors
    sharded over `axis`: rank k keeps the k-th of n equal row blocks."""
    dev = _device_of(mesh)
    n = _dim_size(mesh, axis)
    k = mesh.get_local_rank(axis)
    out = []
    for t in tensors:
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not split into {n} equal shards")
        out.append(_sharded(mesh, t.to(dev).chunk(n)[k], axis))
    return tuple(out)


def replicate(mesh: DeviceMesh, tree):
    """Each array leaf of `tree` as a DTensor replicated over the mesh
    (its local tensor on this rank's device)."""
    dev = _device_of(mesh)
    placements = _placements(mesh, None)
    return _tree_map(lambda t: DTensor.from_local(t, mesh, placements, run_check=False),
                     _to_device(tree, dev))


def _strip(mesh: DeviceMesh, height: int, axis: str):
    n = _dim_size(mesh, axis)
    if height % n:
        raise ValueError(f"height {height} must divide {n} strips")
    h_loc = height // n
    return h_loc, mesh.get_local_rank(axis) * h_loc


def render_sample_sharded(mesh: DeviceMesh, scene, mats, atlas, lights, view, key,
                          width: int, height: int, config=None, axis: str = "film",
                          sample_index=None):
    """One sample per pixel with the film split into strips over `axis`:
    this rank renders its strip (`row0 = rank * height // n`) with the
    same key. Returns a SampleResult of DTensors sharded over `axis`
    (`.full_tensor()` gathers the frame)."""
    from rfw_tpu_torch.render.wavefront import RenderConfig, SampleResult, render_sample

    config = config or RenderConfig()
    h_loc, row0 = _strip(mesh, height, axis)
    dev = _device_of(mesh)
    scene, mats, atlas, lights, view = _to_device((scene, mats, atlas, lights, view), dev)
    r = render_sample(scene, mats, atlas, lights, view, width, h_loc, config,
                      sample_index=sample_index, key=key, row0=row0)
    return SampleResult(*[_sharded(mesh, t, axis) for t in r])


def _sample_share(mesh: DeviceMesh, spp: int, axis: str):
    n = _dim_size(mesh, axis)
    if spp % n:
        raise ValueError(f"spp {spp} must divide the {n} ranks of the {axis!r} dim")
    per = spp // n
    return mesh.get_local_rank(axis) * per, per


def _mean_over(mesh: DeviceMesh, scene, mats, atlas, lights, view, key, width, h_loc,
               row0, spp, config, axis):
    """Sum of this rank's samples (keys `threefry.split(key, spp)`, Sobol
    index = the sample's number), SUM-reduced over `axis`, / spp."""
    from rfw_tpu_torch.render import threefry
    from rfw_tpu_torch.render.wavefront import RenderConfig, render_sample

    config = config or RenderConfig()
    s0, per = _sample_share(mesh, spp, axis)
    keys = threefry.split(key, spp)
    dev = _device_of(mesh)
    scene, mats, atlas, lights, view = _to_device((scene, mats, atlas, lights, view), dev)
    acc = torch.zeros((width * h_loc, 3), dtype=torch.float32, device=dev)
    for s in range(s0, s0 + per):
        acc += render_sample(scene, mats, atlas, lights, view, width, h_loc, config,
                             sample_index=s if config.sampler == "sobol" else None,
                             key=keys[s], row0=row0).radiance
    dist.all_reduce(acc, dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return acc / spp


def render_sharded_2d(mesh: DeviceMesh, scene, mats, atlas, lights, view, key,
                      width: int, height: int, spp: int, config=None):
    """Strips over the mesh's "film" dim for this rank's share of the
    samples over its "spp" dim; the sample mean reduces over "spp" (one
    all-reduce). Under "sobol" sample s takes sample_index s, so the
    result is the sequential Sobol mean. Returns the (W*H, 3) mean
    radiance as a DTensor sharded over "film"."""
    h_loc, row0 = _strip(mesh, height, "film")
    acc = _mean_over(mesh, scene, mats, atlas, lights, view, key, width, h_loc, row0,
                     spp, config, "spp")
    return _sharded(mesh, acc, "film")


def render_spp_sharded(mesh: DeviceMesh, scene, mats, atlas, lights, view, key,
                       width: int, height: int, spp: int, config=None, axis: str = "spp"):
    """Full frames for this rank's share of `threefry.split(key, spp)`
    over `axis`, one SUM all-reduce, / spp. Under "sobol" sample s takes
    sample_index s, as in `render_sharded_2d` (`rfw_tpu`'s version draws
    its keys' random uniforms whatever the sampler). Returns the
    (W*H, 3) mean radiance as a DTensor replicated over the mesh."""
    acc = _mean_over(mesh, scene, mats, atlas, lights, view, key, width, height, 0,
                     spp, config, axis)
    return DTensor.from_local(acc, mesh, _placements(mesh, None), run_check=False)
