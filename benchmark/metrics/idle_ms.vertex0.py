"""render_sample: device-idle ms a traced frame inside the program's
`rfw.vertex0` spans (`program_spans.idle_ms`)."""

from benchmark import program_spans


def read(t):
    return program_spans.idle_ms(t, lambda name: name == "rfw.vertex0")
