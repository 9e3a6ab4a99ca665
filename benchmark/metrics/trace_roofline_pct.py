"""Traversal kernels: the least time a frame's traversal work needs at the
card's peak memory bandwidth (`roofline.py`, from shapes alone), over the
traversal kernels' device time, in percent."""

from benchmark import roofline
from benchmark.tracing import kernel_seconds


def read(t):
    s = kernel_seconds(t, traversal=True)
    peak = roofline.peak(t.ctx["kind"], t.ctx["root"])
    if s <= 0 or peak is None:
        return None
    c = t.ctx
    work = roofline.trace_bytes(c["width"], c["height"], c["bounces"], c["n_triangles"],
                                c["n_instances"], c["samples"])
    return roofline.share_pct(work * len(t.frames), s, peak["hbm_bytes_per_s"])
