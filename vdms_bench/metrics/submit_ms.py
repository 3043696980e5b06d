"""Mean time of the engine's ``submit()`` call, in ms, over the steady
part of the window: parsing, the planner's compile, the metadata Find
and the launch of the first phase (the benchmark's span around the
call)."""
from harness.window import steady_queries


def read(run):
    spans = [r["submit_s"] for r in steady_queries(run)]
    return 1e3 * sum(spans) / len(spans) if spans else None
