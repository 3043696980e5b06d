"""The port's async query sessions held against ``tests/test_sessions.py``:
the futures-based ``submit()``, per-query fair scheduling on the native
pool, cancellation and timeout cleanup, the chaos storm, and the
``FairQueue`` / ``BusyMeter`` plumbing.  Responses of fixed answer are
compared with the JAX package's engine (``torch_parity``)."""
import random
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from repro_torch.core.entity import Entity
from repro_torch.core.event_loop import BusyMeter, FairQueue
from repro_torch.core.udf import (register_batched_udf, register_udf,
                                  unregister_udf)
from torch_parity import (SLOW, TOL, add_images, assert_same, find,
                          port_engine, ref_engine, run, wait)

torch.set_num_threads(1)

PIPE = [
    {"type": "resize", "width": 24, "height": 24},
    {"type": "remote", "url": "http://s/box", "options": {"id": "facedetect_box"}},
    {"type": "threshold", "value": 0.4},
]

NATIVE_PIPE = [
    {"type": "resize", "width": 24, "height": 24},
    {"type": "grayscale"},
    {"type": "threshold", "value": 0.5},
]


def _add(eng, n=10, size=32, category="lfw"):
    """``tests/test_sessions.py::_add_images``."""
    return add_images(eng, n, size, category, seed=0,
                      props=lambda i: {"name": f"p{i}", "age": 20 + i})


def _find(category="lfw", ops=PIPE):
    return find(category, ops)


def _drained(eng, timeout=10.0):
    return wait(lambda: not eng.pool.inflight
                and eng.loop.queue1.qsize() == 0, timeout)


# --------------------------------------------------------------- futures
def test_submit_returns_immediately_and_matches_execute():
    eng = port_engine()
    try:
        _add(eng, 100)
        ref = eng.execute(_find(), timeout=120)
        t0 = time.monotonic()
        fut = eng.submit(_find())
        submit_s = time.monotonic() - t0
        assert submit_s < 0.1, f"submit took {submit_s:.3f}s for 100 entities"
        res = fut.result(timeout=120)
        assert fut.done() and not fut.cancelled()
        assert res["stats"]["matched"] == ref["stats"]["matched"] == 100
        assert res["stats"]["failed"] == 0
        assert_same(res, ref)
    finally:
        eng.shutdown()
    # the reference engine answers the same query with the same bytes
    want = run(ref_engine, lambda e: (_add(e, 100),
                                      e.execute(_find(), timeout=120))[1])
    assert want["stats"]["failed"] == 0
    assert_same(res, want)


def test_streaming_callback_fires_per_entity():
    eng = port_engine()
    try:
        _add(eng, 8)
        seen = []
        lock = threading.Lock()

        def on_entity(ent):
            with lock:
                seen.append(ent.eid)

        res = eng.submit(_find(), on_entity=on_entity).result(timeout=60)
        assert sorted(seen) == sorted(res["entities"])
        assert len(seen) == 8
    finally:
        eng.shutdown()


def test_concurrent_submits_from_many_threads():
    eng = port_engine(num_remote_servers=4)
    try:
        _add(eng, 10)
        futs = {}
        lock = threading.Lock()

        def client(cid):
            f = eng.submit(_find())
            with lock:
                futs[cid] = f

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(futs) == 8
        for f in futs.values():
            r = f.result(timeout=120)
            assert r["stats"]["matched"] == 10
            assert r["stats"]["failed"] == 0
        assert eng.active_sessions() == 0
    finally:
        eng.shutdown()


def _add_then_find():
    img = np.random.default_rng(7).uniform(0, 1, (30, 30, 3)).astype(np.float32)
    return [{"AddImage": {
        "properties": {"category": "new"}, "data": img,
        "operations": [{"type": "resize", "width": 10, "height": 10}]}},
        {"FindImage": {"constraints": {"category": ["==", "new"]},
                       "operations": []}}]


def test_done_callback_and_add_command_via_submit():
    eng = port_engine()
    try:
        fired = threading.Event()
        fut = eng.submit(_add_then_find())
        fut.add_done_callback(lambda f: fired.set())
        res = fut.result(timeout=60)
        assert fired.wait(5)
        # the Find phase ran after the Add barrier: it sees the processed blob
        (arr,) = list(res["entities"].values())
        assert np.asarray(arr).shape == (10, 10, 3)
    finally:
        eng.shutdown()
    want = run(ref_engine, lambda e: e.execute(_add_then_find(), timeout=60))
    assert_same(res, want, atol=TOL)


# -------------------------------------------------------------- fairness
def test_small_query_not_starved_by_huge_query():
    eng = port_engine(num_native_workers=1)   # single worker: worst case
    try:
        _add(eng, 500, size=16, category="big")
        _add(eng, 1, size=16, category="small")
        eng.execute(_find("small", NATIVE_PIPE), timeout=60)  # warmup
        big = eng.submit(_find("big", NATIVE_PIPE))
        small = eng.submit(_find("small", NATIVE_PIPE))
        res = small.result(timeout=60)
        assert res["stats"]["matched"] == 1
        # fair round-robin: the 1-entity query finishes long before the
        # 500-entity query ahead of it in arrival order has drained
        assert not big.done(), "fair scheduling failed: small query waited " \
                               "for the whole 500-entity query"
        big_res = big.result(timeout=120)
        assert big_res["stats"]["matched"] == 500
        assert big_res["stats"]["failed"] == 0
    finally:
        eng.shutdown()


# ---------------------------------------------------------- cancellation
def test_cancel_mid_pipeline_drops_inflight_work():
    eng = port_engine(num_remote_servers=1, transport=SLOW)
    try:
        _add(eng, 12)
        first = threading.Event()
        fut = eng.submit(_find(), on_entity=lambda e: first.set())
        assert first.wait(30), "no entity completed before cancel"
        assert fut.cancel()
        assert fut.cancelled() and fut.done()
        with pytest.raises(CancelledError):
            fut.result(timeout=5)
        assert eng.active_sessions() == 0
        # queued native work dropped; in-flight remote requests forgotten
        _drained(eng)
        assert not eng.pool.inflight, "cancelled query left inflight requests"
        assert eng.loop.queue1.qsize() == 0
        res = eng.execute(_find(), timeout=60)
        assert res["stats"]["matched"] == 12
        assert res["stats"]["failed"] == 0
    finally:
        eng.shutdown()


def test_cancel_after_done_returns_false():
    eng = port_engine()
    try:
        _add(eng, 2)
        fut = eng.submit(_find())
        fut.result(timeout=60)
        assert not fut.cancel()
        assert not fut.cancelled()
    finally:
        eng.shutdown()


def test_timeout_cancels_and_leaks_nothing():
    eng = port_engine(num_remote_servers=1, transport=SLOW)
    try:
        _add(eng, 16)
        with pytest.raises(TimeoutError):
            eng.execute(_find(), timeout=0.05)
        assert eng.active_sessions() == 0, "timed-out session leaked"
        _drained(eng)
        assert not eng.pool.inflight, "timed-out query left inflight requests"
        assert eng.loop.queue1.qsize() == 0
        res = eng.execute(_find("lfw", NATIVE_PIPE), timeout=60)
        assert res["stats"]["matched"] == 16
        assert res["stats"]["failed"] == 0
    finally:
        eng.shutdown()


# ------------------------------------------------------------- chaos
@pytest.fixture
def chaos_udf():
    register_udf("t_chaos_scale", lambda img, k=3.0: img * k)
    register_batched_udf("t_chaos_scale",
                         lambda imgs, k=3.0: [i * k for i in imgs])
    yield "t_chaos_scale"
    unregister_udf("t_chaos_scale")


def test_chaos_cancel_timeout_storm_mixed_backends(chaos_udf):
    """Seeded cancel/timeout storm against a mixed native + remote +
    batcher workload: survivors complete cleanly and nothing leaks."""
    mixed_pipe = [
        {"type": "resize", "width": 16, "height": 16},
        {"type": "remote", "url": "u", "options": {"id": "grayscale"}},
        {"type": "udf", "options": {"id": chaos_udf, "k": 3.0}},
        {"type": "threshold", "value": 0.4},
    ]
    eng = port_engine(
        dispatch="cost", num_native_workers=2,
        transport=dict(network_latency_s=0.001, service_time_s=0.01),
        cost_overrides={
            "grayscale": {"remote": 1e-6, "native": 10.0, "batcher": 10.0},
            chaos_udf: {"batcher": 1e-6, "native": 10.0, "remote": 10.0},
        })
    try:
        _add(eng, 6)
        eng.execute(_find(ops=mixed_pipe), timeout=60)   # warmup
        rng = random.Random(0xC0FFEE)
        outcomes = []
        lock = threading.Lock()

        def client(cid):
            fut = eng.submit(_find(ops=mixed_pipe))
            action = rng.random()   # seeded; races only affect WHICH
            if action < 0.4:        # branch wins, not the invariants
                time.sleep(rng.random() * 0.03)
                cancelled = fut.cancel()
                with lock:
                    outcomes.append(("cancel", fut, cancelled))
                return
            if action < 0.6:
                try:
                    res = fut.result(timeout=rng.random() * 0.02)
                    with lock:
                        outcomes.append(("done", fut, res))
                except TimeoutError:
                    fut.cancel()
                    with lock:
                        outcomes.append(("timeout", fut, None))
                return
            res = fut.result(timeout=120)
            with lock:
                outcomes.append(("done", fut, res))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(outcomes) == 24
        for kind, fut, payload in outcomes:
            if kind == "done":
                assert payload["stats"]["matched"] == 6
                assert payload["stats"]["failed"] == 0
                assert len(payload["entities"]) == 6
            # a cancel() that returned True must report cancelled
            if kind == "cancel" and payload and not fut.done():
                pytest.fail("cancelled future not done")
        wait(lambda: not (eng.pool.inflight or eng.loop.queue1.qsize()
                          or eng.batcher_backend.pending()
                          or eng.active_sessions()), 15)
        assert not eng.pool.inflight, "cancelled work left inflight requests"
        assert eng.loop.queue1.qsize() == 0, "Queue_1 lane leaked"
        assert eng.batcher_backend.pending() == 0, "batcher inbox leaked"
        assert eng.active_sessions() == 0, "session objects leaked"
        res = eng.execute(_find(ops=mixed_pipe), timeout=60)
        assert res["stats"]["matched"] == 6
        assert res["stats"]["failed"] == 0
    finally:
        eng.shutdown()


# ------------------------------------------------------- native pool knob
def test_worker_pool_matches_single_worker_results():
    eng1 = port_engine(num_native_workers=1)
    eng4 = port_engine(num_native_workers=4)
    try:
        _add(eng1, 12)
        _add(eng4, 12)
        r1 = eng1.execute(_find("lfw", NATIVE_PIPE), timeout=60)
        r4 = eng4.execute(_find("lfw", NATIVE_PIPE), timeout=60)
        assert_same(r4, r1)
    finally:
        eng1.shutdown()
        eng4.shutdown()
    want = run(lambda: ref_engine(num_native_workers=4),
               lambda e: (_add(e, 12),
                          e.execute(_find("lfw", NATIVE_PIPE), timeout=60))[1])
    assert_same(r1, want)


# --------------------------------------------------------------- plumbing
def test_fair_queue_round_robin_and_discard():
    q = FairQueue(fair=True)
    for i in range(3):
        q.put(Entity(f"a{i}", "image", None, query_id="A"))
    for i in range(2):
        q.put(Entity(f"b{i}", "image", None, query_id="B"))
    order = [q.get(timeout=1).query_id for _ in range(3)]
    assert order == ["A", "B", "A"]          # lanes alternate
    assert q.discard("A") == 1
    assert q.get(timeout=1).query_id == "B"
    assert q.qsize() == 0
    q.close()
    assert q.get() is None


def test_busy_meter_window_is_bounded():
    m = BusyMeter(window=8)
    for _ in range(100):
        m.start()
        m.stop()
    assert len(m.intervals) == 8             # rolling window only
    assert m.total_intervals == 100          # aggregate keeps counting
    assert m.busy_seconds() >= m.busy_seconds(since=time.monotonic())
    total = m.busy_seconds()
    assert total >= sum(b - a for a, b in m.intervals)
