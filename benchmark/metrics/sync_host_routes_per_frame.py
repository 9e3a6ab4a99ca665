"""Backend sync: host routes a traced frame, the program's
`rfw.sync.repack` and `rfw.sync.rebuild` spans (a guard of the device
motion route: 0 while every sync stays on the device). None where the
program records no `rfw.sync` span."""

from benchmark import program_spans

HOST_ROUTES = ("rfw.sync.repack", "rfw.sync.rebuild")


def read(t):
    if not program_spans.spans(t, lambda name: name == "rfw.sync"):
        return None
    return len(program_spans.spans(t, lambda name: name in HOST_ROUTES)) / len(t.frames)
