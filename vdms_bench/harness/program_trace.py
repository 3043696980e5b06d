"""The program's own spans and counters over the steady part of the
window: differences of the ``trace`` block of the device backend's
stats (``dispatch_stats()["device"]["trace"]``, ``{"spans": {name:
[count, seconds]}, "counters": {name: n}}``) between the window's start
and its steady point.  A program without that block gives ``None``,
and so does every reader built on it."""


def delta(run):
    """``(spans, counters)``: per span ``(count, seconds)`` and per
    counter its rise, or ``None`` where the program keeps no trace."""
    before, after = run.backend
    if "trace" not in before or "trace" not in after:
        return None
    b, a = before["trace"], after["trace"]
    spans = {}
    for name, (n, s) in a["spans"].items():
        n0, s0 = b["spans"].get(name, (0, 0.0))
        spans[name] = (n - n0, s - s0)
    counters = {name: v - b["counters"][name]
                for name, v in a["counters"].items()
                if name in b["counters"]}
    return spans, counters


def span_mean(run, name, scale):
    """Mean seconds of span ``name`` times ``scale``, or ``None``."""
    d = delta(run)
    if d is None:
        return None
    n, s = d[0].get(name, (0, 0.0))
    return scale * s / n if n > 0 else None


def seconds_per(run, spans, counter, scale):
    """The summed seconds of ``spans`` over the rise of ``counter``,
    times ``scale``, or ``None``."""
    d = delta(run)
    if d is None or d[1].get(counter, 0) <= 0:
        return None
    return scale * sum(d[0].get(s, (0, 0.0))[1] for s in spans) \
        / d[1][counter]
