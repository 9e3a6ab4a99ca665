"""render_sample: bounce vertices a traced frame whose live prefix took one
of the deep ladder's two sub-floor rungs (the program's `ladder.subfloor`
count; 0 a frame where the ladder is off or the path shallower than 3)."""

from benchmark import program_spans


def read(t):
    n = program_spans.counter(t, "ladder.subfloor")
    return None if n is None else sum(n) / len(t.frames)
