"""Backend sync: vertices the device dynamics route skins a traced frame,
the mean of the program's `dyn.vertices` count (every unit skinned every
frame: the characters' vertex count times their number)."""

from benchmark import program_spans


def read(t):
    n = program_spans.counter(t, "dyn.vertices")
    return None if n is None else sum(n) / len(t.frames)
