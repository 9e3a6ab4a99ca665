"""Backend sync: host ms a traced frame inside the program's
`rfw.sync.dynamics` spans, the device dynamics route (skinning, the
re-bake of the deformed units' arenas, the BLAS and TLAS refit). None
where the program records no such span."""

from benchmark import program_spans


def read(t):
    s = program_spans.spans(t, lambda name: name == "rfw.sync.dynamics")
    return 1e3 * sum(b - a for a, b in s) / len(t.frames) if s else None
