"""render_sample: the share of the lanes the deep bounce vertices (depth 2
and on) shade that are alive, 100 x the window's `lanes.live.deep` over its
`lanes.shaded.deep` (the program's frame records; none at one bounce)."""

from benchmark import program_spans


def read(t):
    shaded = program_spans.counter(t, "lanes.shaded.deep")
    live = program_spans.counter(t, "lanes.live.deep")
    if not shaded or not live or sum(shaded) == 0:
        return None
    return 100.0 * sum(live) / sum(shaded)
