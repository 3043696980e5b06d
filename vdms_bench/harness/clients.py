"""Closed-loop clients: each thread submits a query to the engine, waits
for its result, then sends the next, until the window's deadline; a
query sent before the deadline is waited for to its end.  A seeded
reservoir keeps the responses of a uniform sample of the completed
queries, each with its times, for the correctness check."""
from __future__ import annotations

import random
import threading
import time

RESULT_TIMEOUT_S = 300.0


class Reservoir:
    def __init__(self, size: int, seed: int):
        self.size = size
        self.kept: list = []
        self._seen = 0
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def offer(self, item) -> None:
        with self._lock:
            self._seen += 1
            if len(self.kept) < self.size:
                self.kept.append(item)
                return
            j = self._rng.randrange(self._seen)
            if j < self.size:
                self.kept[j] = item


def run_closed_loop(engine, client_queries, deadline_of, reservoir=None,
                    annotate=None, during=None) -> list[dict]:
    """Runs one thread per entry of ``client_queries`` (an iterator of
    ``(query, meta)`` per client) from a common start; a client stops
    sending once ``time.perf_counter()`` passes ``deadline_of(t0)``.
    Returns one record per query sent: ``client``, ``meta``,
    ``t_submit`` (since t0), ``submit_s`` (the ``submit()`` call alone),
    ``latency_s`` (submit to result), ``ok``, and ``t0`` on the first.
    ``annotate(name)``, when given, is a context manager put around each
    ``submit()`` (a profiler range in a traced run); ``during(t0)``, when
    given, runs on the calling thread while the clients run."""
    records: list[dict] = []
    lock = threading.Lock()
    go = threading.Event()
    start: dict = {}

    def client(c, queries):
        go.wait()
        t0 = start["t0"]
        deadline = deadline_of(t0)
        for query, meta in queries:
            if time.perf_counter() >= deadline:
                break
            rec = {"client": c, "meta": meta}
            ts = time.perf_counter()
            try:
                if annotate is None:
                    fut = engine.submit(query)
                else:
                    with annotate("vdmsbench.submit"):
                        fut = engine.submit(query)
                rec["submit_s"] = time.perf_counter() - ts
                res = fut.result(RESULT_TIMEOUT_S)
                rec["ok"] = not res["stats"]["failed"]
                rec["error"] = None if rec["ok"] else str(res["stats"])
            except Exception as e:  # noqa: BLE001 — a failed query is counted
                res = None
                rec["ok"] = False
                rec["error"] = f"{type(e).__name__}: {e}"
                rec.setdefault("submit_s", time.perf_counter() - ts)
            done = time.perf_counter()
            rec["t_submit"] = ts - t0
            rec["latency_s"] = done - ts
            rec["t_done"] = done - t0
            with lock:
                records.append(rec)
            if rec["ok"] and reservoir is not None:
                reservoir.offer((meta, res["entities"],
                                 (rec["t_submit"], rec["t_done"])))

    threads = [threading.Thread(target=client, args=(c, q), daemon=True,
                                name=f"vdmsbench-client-{c}")
               for c, q in enumerate(client_queries)]
    for t in threads:
        t.start()
    start["t0"] = time.perf_counter()
    go.set()
    if during is not None:
        during(start["t0"])
    for t in threads:
        t.join()
    for r in records:
        r["t0"] = start["t0"]
    return records
