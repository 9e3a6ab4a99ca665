"""Law `static`: nothing changes between frames, so the film of frame f
holds samples 0..f, all of one scene (a progressive viewer)."""


def apply(backend, spec, params, frame):
    return None


def scene_at(spec, params, frame):
    return spec


def film_start(params, frame):
    return 0
