"""The classify cells' 95th percentile of query time, in ms, over the
steady part of the traced run.  Per-layer, not end to end: on the
shared host its spread between runs (21–25% of the median in two sets
of six) is wider than any bound the benchmark may set."""
from harness.stats import percentile
from harness.window import query_ms, steady_queries


def read(run):
    return percentile(query_ms(steady_queries(run), run.window_s), 95)
