"""The one generator of traffic: what changes in the scene before each frame.

A traffic mix is a data file, `traffic/<name>.json`, of parameters: `law`,
the law's numbers, and `warmup_frames`, the frames that set-up renders
before the window. The law is a module of its own, `laws/<law>.py`, found
by that name, so a new kind of traffic is a new law file and a new data
file, with no edit to a file that is already here. A law has three
functions, each of (spec, params, frame), frame 0 being the first warm-up
frame:

  * `apply(backend, spec, params, frame)`: the Backend calls made before
    the frame's `synchronize()`; returns None, or the CameraView3D to
    render the frame with where the law moves the camera;
  * `scene_at(spec, params, frame)`: the `SceneSpec` as it stands when the
    frame renders (what the reference renders);
  * `film_start(params, frame)`: the first frame whose sample the frame's
    film still holds (the Backend resets the film on any change), so that
    the film of `frame` holds samples 0..frame - film_start, all rendered
    in `scene_at(spec, params, frame)`.

The loop is closed (one viewer; a frame starts when the last one has
returned), so a mix has no arrival rate. A law's output is a pure function
of the spec, the parameters and the frame, so the reference rebuilds any
frame's scene from them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from benchmark.by_name import load_module


class Traffic:
    """A traffic mix: its parameters and its law."""

    def __init__(self, params: Dict, law):
        self.params, self.law = params, law
        self.warmup_frames = int(params["warmup_frames"])

    def apply(self, backend, spec, frame: int):
        return self.law.apply(backend, spec, self.params, frame)

    def scene_at(self, spec, frame: int):
        return self.law.scene_at(spec, self.params, frame)

    def film_start(self, frame: int) -> int:
        return self.law.film_start(self.params, frame)


def load(name: str, root: Path) -> Traffic:
    params = json.loads((root / "traffic" / f"{name}.json").read_text())
    law = root / "laws" / f"{params.get('law')}.py"
    if not law.is_file():
        raise ValueError(f"traffic {name}: no law file laws/{params.get('law')}.py")
    return Traffic(params, load_module(law))
