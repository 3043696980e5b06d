"""Mean time of the metadata selection of a query's Find, in ms, over
the steady part of the window (the program's ``query.find`` span)."""
from harness.program_trace import span_mean


def read(run):
    return span_mean(run, "query.find", 1e3)
