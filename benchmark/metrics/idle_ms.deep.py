"""render_sample: device-idle ms a traced frame inside the program's
`rfw.bounce.<depth>` spans of depth 2 and on (`program_spans.idle_ms`);
none at one bounce."""

from benchmark import program_spans


def _deep(name: str) -> bool:
    head, _, depth = name.rpartition(".")
    return head == "rfw.bounce" and depth.isdigit() and int(depth) >= 2


def read(t):
    return program_spans.idle_ms(t, _deep)
