"""Shading and glue: device ms a traced frame of every kernel that
`trace_kernels.txt` does not name (eager shading, the dense phase-A scan,
sorts, film, tonemap, the sync's device work)."""

from benchmark.tracing import kernel_seconds


def read(t):
    s = kernel_seconds(t, traversal=False)
    return 1e3 * s / len(t.frames) if s > 0 else None
