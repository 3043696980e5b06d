"""The preprocessing feed's 95th percentile of query time, in ms, over
the steady part of the traced run: the host paces that cell, so its
tail is the engine's, not the device's."""
from harness.stats import percentile
from harness.window import query_ms, steady_queries


def read(run):
    return percentile(query_ms(steady_queries(run), run.window_s), 95)
