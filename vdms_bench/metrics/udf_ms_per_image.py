"""Milliseconds of the model UDF's device route per image it served in
the steady part of the window (the benchmark's span around each call:
one prefill and the decode steps over the micro-batch, the labels
stamped)."""
from harness.window import steady_calls


def read(run):
    calls = steady_calls(run)
    rows = sum(c["rows"] for c in calls)
    if rows == 0:
        return None
    return 1e3 * sum(c["seconds"] for c in calls) / rows
