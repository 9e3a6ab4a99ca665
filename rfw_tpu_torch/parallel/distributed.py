"""Multi-process scale-out: the process group and the scene broadcast.

Counterpart of `rfw_tpu/parallel/distributed.py` over `torch.distributed`,
one process per device:

  * `init_distributed` initialises the process group from its arguments
    or the same `RFW_COORDINATOR` / `RFW_NUM_PROCESSES` / `RFW_PROCESS_ID`
    variables as `rfw_tpu`'s (NCCL on the card; gloo when the caller names
    `device="cpu"`), and sets the rank's CUDA device;
  * `global_film_mesh` is the film mesh over every rank;
  * `broadcast_scene` sends rank 0's packed scene (any tree of arrays) to
    every rank; the others pass skeletons of the same shapes and dtypes.

Launch one process per card, each with the same coordinator
(`host:port` of rank 0) and its own `RFW_PROCESS_ID`.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from rfw_tpu_torch.parallel.mesh import _to_device, _tree_map, film_mesh, rank_device


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> bool:
    """Initialise the process group for a multi-process render. Arguments
    fall back to RFW_COORDINATOR / RFW_NUM_PROCESSES / RFW_PROCESS_ID.
    Returns False, and initialises nothing, for one process; True once a
    group of `num_processes` ranks is up."""
    coordinator = coordinator or os.environ.get("RFW_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("RFW_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RFW_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator is None:
        return False
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        backend = "nccl"
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed runs NCCL on CUDA devices and none is "
                               "available; pass device='cpu' for gloo on the host")
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def global_film_mesh(axis: str = "film", device=None):
    """1-D film mesh over every rank of the group (after init_distributed)."""
    return film_mesh(None, axis, device)


def broadcast_scene(tree, is_source: Optional[bool] = None):
    """Broadcast the source rank's scene tree (a dict, NamedTuple or
    dataclass of numpy arrays or tensors: TraceScene, DeviceMaterials,
    DeviceLights, TextureAtlas) to every rank. The other ranks pass
    skeletons of the same shapes and dtypes (e.g. zeros). `is_source`
    defaults to rank 0; exactly one rank may be the source. Returns the
    tree as tensors on this rank's device; with one process, `tree`
    unchanged."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    dev = rank_device("cpu" if dist.get_backend() == "gloo" else None)
    if is_source is None:
        is_source = dist.get_rank() == 0
    flags = torch.zeros(dist.get_world_size(), dtype=torch.int32, device=dev)
    flags[dist.get_rank()] = int(bool(is_source))
    dist.all_reduce(flags)
    if int(flags.sum()) != 1:
        raise ValueError(f"{int(flags.sum())} ranks claim to be the broadcast's source")
    src = int(flags.argmax())

    def bcast(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous() if is_source else t.clone()  # never write a caller's skeleton
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src)
        return t

    return _tree_map(bcast, _to_device(tree, dev))
