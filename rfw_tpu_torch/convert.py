"""Carry the packed scene arenas over to torch tensors on a device.

The packed arenas (`TraceScene`, `DeviceMaterials`, `DeviceLights`,
`TextureAtlas`) are the renderer's "weights". `from_numpy_scene` accepts
them as produced by this package's packers or by `rfw_tpu`'s (any object
with the same field names whose fields convert with `np.asarray`), so the
tests can feed the same arenas to both renderers.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from rfw_tpu_torch.backend.structs import DeviceMaterials
from rfw_tpu_torch.render.atlas import TextureAtlas
from rfw_tpu_torch.render.lights_pack import DeviceLights
from rfw_tpu_torch.render.pack import TraceScene


def to_tensor(x, device) -> torch.Tensor:
    """numpy-convertible array -> tensor on `device`. uint32 arrays (the
    texel pool) keep their bit patterns as int32."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def from_numpy_scene(trace_scene, device_materials, device_lights, atlas,
                     device="cuda"):
    """Returns (TraceScene, DeviceMaterials, DeviceLights, TextureAtlas) of
    tensors on `device` (the card unless the caller names another)."""
    scene = TraceScene(*[to_tensor(getattr(trace_scene, f), device)
                         for f in TraceScene._fields])
    mats = DeviceMaterials(**{
        f.name: to_tensor(getattr(device_materials, f.name), device)
        for f in fields(DeviceMaterials)})
    lights = DeviceLights(*[to_tensor(getattr(device_lights, f), device)
                            for f in DeviceLights._fields])
    tex = TextureAtlas(*[
        None if getattr(atlas, f) is None else to_tensor(getattr(atlas, f), device)
        for f in TextureAtlas._fields])
    return scene, mats, lights, tex
