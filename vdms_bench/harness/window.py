"""The parts of a run's window the readers take: every query (the
end-to-end metrics of an untraced run), or those of the steady part, up
to a traced run's slice (the per-layer spans and counters)."""


def query_ms(queries, window_s: float) -> list[float]:
    """Each query's submit-to-result time in ms; a failed one counts as
    the whole window."""
    return [1e3 * (r["latency_s"] if r["ok"] else window_s) for r in queries]


def steady_queries(run) -> list[dict]:
    return [r for r in run.queries if r["t_done"] <= run.steady_s]


def steady_calls(run) -> list[dict]:
    return [c for c in run.udf_calls
            if c["start"] + c["seconds"] <= run.steady_s]


def images(run, queries) -> int:
    groups = sum(len(r["meta"]["groups"]) for r in queries if r["ok"])
    return groups * run.config["collection"]["group_size"]
