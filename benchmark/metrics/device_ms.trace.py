"""Traversal kernels: device ms a traced frame of the kernels that
`trace_kernels.txt` names."""

from benchmark.tracing import kernel_seconds


def read(t):
    s = kernel_seconds(t, traversal=True)
    return 1e3 * s / len(t.frames) if s > 0 else None
