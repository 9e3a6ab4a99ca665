"""Device: the share of the traced window in which no kernel, copy or set
ran on the card (100 minus the union of device spans), in percent."""

from benchmark import stats


def read(t):
    lo, hi = t.window
    spans = [(a, b) for _, a, b, _ in t.device_in_window()]
    if not spans:
        return None
    return 100.0 * (1.0 - stats.busy(spans, lo, hi) / (hi - lo))
