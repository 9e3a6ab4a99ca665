"""render_sample: the share of the lanes a vertex shades that are alive,
100 x the window's `lanes.live` over its `lanes.shaded` (the program's
frame records: vertex 0's hit prefix and each bounce's live prefix)."""

from benchmark import program_spans


def read(t):
    shaded = program_spans.counter(t, "lanes.shaded")
    live = program_spans.counter(t, "lanes.live")
    if not shaded or not live or sum(shaded) == 0:
        return None
    return 100.0 * sum(live) / sum(shaded)
