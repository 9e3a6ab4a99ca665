"""Carry the packed scene arenas over to torch tensors on a device.

The packed arenas (`TraceScene`, `DeviceMaterials`, `DeviceLights`,
`TextureAtlas`) are the renderer's "weights". Each has its own upload, so
that a backend uploads only what changed; `update_scene` re-uploads only
the `TraceScene` fields whose host array changed, and those a device refit
rewrote. `from_numpy_scene`
uploads all four. They accept the arenas as produced by this package's
packers or by `rfw_tpu`'s (any object with the same field names whose
fields convert with `np.asarray`), so the tests can feed the same arenas
to both renderers.
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


def scene_to_device(trace_scene, device="cuda") -> TraceScene:
    return TraceScene(*[to_tensor(getattr(trace_scene, f), device)
                        for f in TraceScene._fields])


def materials_to_device(device_materials, device="cuda") -> DeviceMaterials:
    return DeviceMaterials(**{
        f.name: to_tensor(getattr(device_materials, f.name), device)
        for f in fields(DeviceMaterials)})


def lights_to_device(device_lights, device="cuda") -> DeviceLights:
    return DeviceLights(*[to_tensor(getattr(device_lights, f), device)
                          for f in DeviceLights._fields])


def atlas_to_device(atlas, device="cuda") -> TextureAtlas:
    return TextureAtlas(*[
        None if getattr(atlas, f) is None else to_tensor(getattr(atlas, f), device)
        for f in TextureAtlas._fields])


def update_scene(old_host, old_dev: TraceScene, new_host, device="cuda",
                 stale=()) -> TraceScene:
    """Equality-gated upload: a field keeps its device tensor when its host
    array is unchanged (same shape, dtype and values) and it is not named
    in `stale`; every other field is uploaded. `stale` names the fields
    whose device tensors no longer match `old_host` (a device refit rewrote
    them), so the host comparison cannot vouch for them."""
    out = {}
    for f in TraceScene._fields:
        new, old = np.asarray(getattr(new_host, f)), np.asarray(getattr(old_host, f))
        if (f not in stale and old.shape == new.shape and old.dtype == new.dtype
                and np.array_equal(old, new)):
            out[f] = getattr(old_dev, f)
        else:
            out[f] = to_tensor(new, device)
    return TraceScene(**out)


def from_numpy_scene(trace_scene, device_materials, device_lights, atlas,
                     device="cuda"):
    """Returns (TraceScene, DeviceMaterials, DeviceLights, TextureAtlas) of
    tensors on `device` (the card unless the caller names another)."""
    return (scene_to_device(trace_scene, device),
            materials_to_device(device_materials, device),
            lights_to_device(device_lights, device),
            atlas_to_device(atlas, device))
