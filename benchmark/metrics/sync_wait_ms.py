"""Backend sync: host ms a traced frame inside the program's
`rfw.sync.wait` span, the device synchronize that closes
`TorchBackend.synchronize()`."""

from benchmark import program_spans


def read(t):
    s = program_spans.spans(t, lambda name: name == "rfw.sync.wait")
    return 1e3 * sum(b - a for a, b in s) / len(t.frames) if s else None
