"""Law `bounce` (rfw-rs examples/animated): every instance of the
configuration's moving meshes sits at its rest matrix with y raised by
amplitude * |sin(omega * t + phase)|, phase = phase_per_unit * (x + z) of
its rest position, t = frame * dt on a simulated clock. One
`set_3d_instances` call a moving mesh a frame; the scene changes before
every frame, so each frame's film holds its own sample 0 alone."""

import dataclasses
from typing import List, Tuple

import numpy as np

from benchmark import scene


def moved(spec, params, frame) -> List[Tuple[int, np.ndarray]]:
    """(mesh slot, (I,4,4) matrices) of every moving slot at `frame`."""
    t = frame * params["dt"]
    out = []
    for slot in spec.moving:
        rest = spec.instances[slot]
        phase = params["phase_per_unit"] * (rest[:, 0, 3] + rest[:, 2, 3])
        m = rest.copy()
        m[:, 1, 3] = rest[:, 1, 3] + params["amplitude"] * np.abs(
            np.sin(params["omega"] * t + phase)).astype(np.float32)
        out.append((slot, m))
    return out


def apply(backend, spec, params, frame):
    for slot, m in moved(spec, params, frame):
        backend.set_3d_instances([(slot, scene.instances_view(spec, slot, m))])


def scene_at(spec, params, frame):
    mats = list(spec.instances)
    for slot, m in moved(spec, params, frame):
        mats[slot] = m
    return dataclasses.replace(spec, instances=mats)


def film_start(params, frame):
    return frame
