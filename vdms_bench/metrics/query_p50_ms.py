"""Median of every query's time from submit to result, in ms; a failed
query counts as taking the whole window."""
from harness.stats import percentile
from harness.window import query_ms


def read(run):
    return percentile(query_ms(run.queries, run.window_s), 50)
