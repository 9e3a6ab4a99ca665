"""Traversal kernels: rays a traced frame that the two-phase fallback
retraced through K1/K2 (the program's `tp.retraced` count)."""

from benchmark import program_spans


def read(t):
    n = program_spans.counter(t, "tp.retraced")
    return None if n is None else sum(n) / len(t.frames)
