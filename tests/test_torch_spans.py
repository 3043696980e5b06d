"""The engine's spans and counters (``repro_torch.core.spans``) on the
CPU: the recorder's arithmetic, its copy-out, its cost with the profiler
off, its ranges under the profiler, and what one engine run with the
device backend and the reduced model UDF records."""
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import spans
from repro_torch.core.engine import VDMSAsyncEngine
from repro_torch.core.udf import (register_model_udf, served_calls,
                                  unregister_udf)

UDF = "t_spans_rwkv6"
STEPS = 4


def test_spans_nest_and_their_counts_and_seconds_add_up():
    rec = spans.SpanRecorder()
    with rec.span("outer", "1"):
        for _ in range(3):
            with rec.span("inner", "1"):
                sum(range(1000))
    rec.add("wait", 0.25, 4)
    rec.add("wait", 0.5)
    rec.count("rows", 7)
    rec.count("rows")
    with rec.span("batch", "1", n=5):        # one block, five results
        pass
    snap = rec.snapshot()
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert outer[0] == 1 and inner[0] == 3
    assert snap["spans"]["batch"][0] == 5
    assert 0 < inner[1] <= outer[1]
    assert snap["spans"]["wait"] == [5, 0.75]
    assert snap["counters"] == {"rows": 8}


def test_spans_from_many_threads_all_count():
    """More threads than cores, switching every microsecond: a lost
    update would leave a count short."""
    rec = spans.SpanRecorder()
    n_threads = 2 * (os.cpu_count() or 1) + 2

    def work():
        for _ in range(500):
            with rec.span("s"):
                pass
            rec.add("w", 0.5)
            rec.count("c")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = rec.snapshot()
    assert snap["spans"]["s"][0] == 500 * n_threads
    assert snap["spans"]["w"] == [500 * n_threads, 250.0 * n_threads]
    assert snap["counters"]["c"] == 500 * n_threads


def test_snapshot_returns_a_copy():
    rec = spans.SpanRecorder()
    with rec.span("a"):
        pass
    rec.count("c", 2)
    first = rec.snapshot()
    first["spans"]["a"][0] = 99
    first["counters"]["c"] = 99
    first["spans"]["b"] = [1, 1.0]
    with rec.span("a"):
        pass
    second = rec.snapshot()
    assert second["spans"]["a"][0] == 2 and "b" not in second["spans"]
    assert second["counters"] == {"c": 2}
    assert first["spans"]["a"][0] == 99


def test_no_range_is_entered_with_the_profiler_off(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a profiler range was entered")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rec = spans.SpanRecorder()
    with rec.span("query.find", "3"):
        with rec.span("device.group", {"3", "4"}):
            pass
    assert rec.snapshot()["spans"]["query.find"][0] == 1


def test_spans_appear_under_the_profiler_with_their_qids():
    rec = spans.SpanRecorder()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with rec.span("query.submit"):
            with rec.span("query.find", "17"):
                torch.ones(4).add_(1)
        with rec.span("device.group", {"12", "3"}):
            pass
    got = {e.name: list(e.concrete_inputs) for e in prof.events()
           if e.name.startswith(("query.", "device."))}
    assert got == {"query.submit": [], "query.find": [17],
                   "device.group": [3, 12]}
    # the span still counts while the profiler records
    assert rec.snapshot()["spans"]["query.find"][0] == 1


def test_the_null_recorder_records_nothing():
    assert spans.current() is spans.NULL
    with spans.NULL.span("udf.call"):
        spans.NULL.count("udf.rows", 3)
    rec = spans.SpanRecorder()
    with spans.using(rec):
        assert spans.current() is rec
        with spans.current().span("udf.call"):
            pass
    assert spans.current() is spans.NULL
    assert rec.snapshot()["spans"]["udf.call"][0] == 1


def _faces(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (24, 24, 3)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture
def model_udf():
    register_model_udf(UDF, arch="rwkv6-1.6b", steps=STEPS, reduced=True,
                       device="cpu")
    try:
        yield UDF
    finally:
        unregister_udf(UDF)


def _engine():
    return VDMSAsyncEngine(
        device="cpu", dispatch="cost", device_backend="cpu",
        device_batch_size=64, device_max_wait_ms=200.0,
        cost_overrides={UDF: {"device": 1e-6, "native": 10.0,
                              "remote": 10.0, "batcher": 10.0}})


def _query(group):
    return [{"FindImage": {"constraints": {"group": ["==", group]},
                           "operations": [{"type": "udf",
                                           "options": {"id": UDF}}]}}]


def test_an_engine_run_records_each_layer(model_udf):
    eng = _engine()
    try:
        for i, img in enumerate(_faces(12)):
            eng.add_entity("image", img, {"group": i // 4})
        before = eng.trace_stats()
        futs = [eng.submit(_query(g)) for g in range(3)]
        res = [f.result(120) for f in futs]
        after = eng.trace_stats()
        assert after == eng.dispatch_stats()["device"]["trace"]
    finally:
        eng.shutdown()
    assert before == {"spans": {}, "counters": {}}
    assert all(r["stats"]["failed"] == 0 and r["stats"]["matched"] == 4
               for r in res)
    sp, ct = after["spans"], after["counters"]
    n = 12
    for name in ("query.submit", "query.plan", "query.find",
                 "query.expand", "boundary.in"):
        assert sp[name][0] == 3, name
    for name in ("boundary.out", "device.wait"):
        assert sp[name][0] == n, name
    # the way out: one stacked copy a query, its 4 results of one shape
    assert ct["boundary.out_copies"] == 3
    groups = sp["device.group"][0]
    assert groups >= 1
    assert sp["device.host_segment"][0] == groups
    assert sp["udf.call"][0] == groups
    assert sp["udf.decode"][0] == groups * (STEPS - 1)
    assert ct["udf.rows"] == n
    assert ct["udf.decode_tokens"] == n * (STEPS - 1)
    assert ct["udf.prefill_tokens"] == n * 3          # 3 channel tokens
    assert "device.mallocs" not in ct                  # CUDA only
    children = sum(sp[k][1] for k in ("udf.prompts", "udf.prefill",
                                      "udf.decode", "udf.sync",
                                      "udf.stamp"))
    assert children <= sp["udf.call"][1]
    for name, (count, seconds) in sp.items():
        assert count > 0 and seconds >= 0, name
    # the response's stats gain no key
    assert set(res[0]["stats"]) == {"matched", "failed", "duration_s"}


def test_a_streamed_query_copies_each_entity_alone(model_udf):
    eng = _engine()
    streamed = []
    try:
        for i, img in enumerate(_faces(4, seed=11)):
            eng.add_entity("image", img, {"group": 0})
        res = eng.submit(_query(0), on_entity=lambda e: streamed.append(
            type(e.data))).result(120)
        snap = eng.trace_stats()
    finally:
        eng.shutdown()
    assert res["stats"]["failed"] == 0
    assert streamed == [np.ndarray] * 4
    assert snap["spans"]["boundary.out"][0] == 4
    assert "boundary.out_copies" not in snap["counters"]


def test_the_route_reports_the_calls_it_served(model_udf):
    eng = _engine()
    try:
        for i, img in enumerate(_faces(8, seed=9)):
            eng.add_entity("image", img, {"group": i // 4})
        for g in range(2):
            assert eng.execute(_query(g), timeout=120)["stats"]["failed"] \
                == 0
    finally:
        eng.shutdown()
    calls = served_calls(UDF)
    assert sum(c["rows"] for c in calls) == 8
    for c in calls:
        rows = c["rows"]
        assert c["prompt"].shape == (rows, 3)
        assert c["tokens"].shape == (rows, STEPS)
        assert c["passes"] == [(rows, 3, 0, 1)] + [
            (rows, 1, 3 + i, 1) for i in range(STEPS - 1)]
    unregister_udf(UDF)
    assert served_calls(UDF) == []


def test_a_device_udf_outside_any_engine_records_nothing(model_udf):
    from repro_torch.core.udf import get_device_udf
    out = get_device_udf(UDF)([torch.tensor(f) for f in _faces(2)])
    assert len(out) == 2
    assert spans.current() is spans.NULL
    assert served_calls(UDF)[-1]["rows"] == 2


def test_a_static_engine_reports_no_dispatch_blocks():
    eng = VDMSAsyncEngine(device="cpu")
    try:
        eng.add_entity("image", _faces(1)[0], {"group": 0})
        eng.execute([{"FindImage": {"constraints": {"group": ["==", 0]}}}],
                    timeout=60)
        assert eng.dispatch_stats() == {"mode": "static"}
        snap = eng.trace_stats()
    finally:
        eng.shutdown()
    assert snap["spans"]["query.find"][0] == 1
    assert snap["spans"]["boundary.out"][0] == 1      # born done
    assert "boundary.out_copies" not in snap["counters"]  # a host blob
    assert "device.wait" not in snap["spans"]
