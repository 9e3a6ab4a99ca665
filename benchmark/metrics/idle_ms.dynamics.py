"""Backend sync: device-idle ms a traced frame inside the program's
`rfw.sync.dynamics` spans (`program_spans.idle_ms`): how far the eager
refit is bound by its launches."""

from benchmark import program_spans


def read(t):
    return program_spans.idle_ms(t, lambda name: name == "rfw.sync.dynamics")
