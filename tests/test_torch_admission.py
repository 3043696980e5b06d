"""The port's admission control held against ``tests/test_admission.py``:
bounded in-flight entities, the shed and queue policies, priority
order, cancellation of pending admissions, the overload storm across
all four backends, shutdown determinism, the offload inboxes'
late-submit and drain rules, fair-queue accounting and the
snapshot-before-callback fan-out.  The bit-exact ``admission_none_hash``
workload (``benchmarks/admission_bench.py::run_static_hash``) must hash
to the digest recorded in ``benchmarks/admission_static_baseline.json``,
and the queue engine must return the identical arrays."""
import hashlib
import json
import os
import queue
import random
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from repro_torch.core.entity import ERD, Entity
from repro_torch.core.event_loop import EventLoop, FairQueue
from repro_torch.core.pipeline import make_op
from repro_torch.core.result_cache import ResultCache, prefix_signatures
from repro_torch.core.udf import (register_batched_udf, register_udf,
                                  unregister_udf)
from repro_torch.query.admission import AdmissionController, OverloadError
from torch_parity import (SLOW, add_images, assert_same, entities, find,
                          port_engine, ref_engine, run, wait)

torch.set_num_threads(1)

BASELINE = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "admission_static_baseline.json")

REMOTE_PIPE = [
    {"type": "resize", "width": 16, "height": 16},
    {"type": "remote", "url": "u", "options": {"id": "grayscale"}},
    {"type": "threshold", "value": 0.4},
]

SCALE = "t_adm_scale"


@pytest.fixture(scope="module", autouse=True)
def adm_scale():
    register_udf(SCALE, lambda img, k=2.0: img * k)
    register_batched_udf(SCALE, lambda imgs, k=2.0: [i * k for i in imgs])
    yield
    unregister_udf(SCALE)


def _add(eng, n=6, size=24, category="adm"):
    """``tests/test_admission.py::_add_images``."""
    return add_images(eng, n, size, category, seed=7)


def _find(category="adm", ops=REMOTE_PIPE):
    return find(category, ops)


# ------------------------------------------- the recorded static response
# benchmarks/admission_bench.py::run_static_hash
HASH_PIPE = [
    {"type": "crop", "x": 2, "y": 2, "width": 20, "height": 20},
    {"type": "remote", "url": "http://svc/flip", "options": {"id": "flip"}},
    {"type": "rotate", "k": 3},
    {"type": "threshold", "value": 0.5},
]
HASH_TRANSPORT = dict(network_latency_s=0.001, service_time_s=0.001)


def _hash_response(**kw):
    def scenario(e):
        add_images(e, 8, 28, "adm", seed=23)
        return e.execute(find("adm", HASH_PIPE), timeout=600)
    return run(lambda: port_engine(transport=HASH_TRANSPORT, **kw), scenario)


def _digest(ents: dict) -> str:
    h = hashlib.sha256()
    for eid, arr in ents.items():
        arr = np.ascontiguousarray(arr)
        h.update(eid.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def test_admission_none_hash_matches_recorded_baseline():
    with open(BASELINE) as f:
        recorded = json.load(f)["sha256"]
    ref = _hash_response()
    gated = _hash_response(admission="queue", max_inflight_entities=4)
    assert ref["stats"]["failed"] == gated["stats"]["failed"] == 0
    assert _digest(entities(ref)) == recorded
    assert_same(gated, ref)


# ------------------------------------------------------- knob validation
def test_admission_knob_validation_leaks_no_threads():
    before = threading.active_count()
    with pytest.raises(ValueError, match="admission must be"):
        port_engine(admission="drop")
    with pytest.raises(ValueError, match="max_inflight_entities requires"):
        port_engine(max_inflight_entities=8)
    with pytest.raises(ValueError, match="max_inflight_entities must be"):
        port_engine(admission="shed")
    with pytest.raises(ValueError, match="admission_queue_cap"):
        port_engine(admission="queue", max_inflight_entities=8,
                    admission_queue_cap=-1)
    assert threading.active_count() == before


def test_default_engine_has_no_controller_and_ignores_priority():
    eng = port_engine()
    try:
        assert eng.admission_ctl is None
        assert eng.admission_stats() == {"policy": "none"}
        _add(eng, 4)
        ref = eng.execute(_find(), timeout=60)
        res = eng.submit(_find(), priority=99).result(60)   # harmless
        assert_same(res, ref)
    finally:
        eng.shutdown()


def test_admission_queue_response_identical_to_unbounded():
    def scenario(e):
        _add(e, 6)
        return e.execute(_find(), timeout=60)

    ref = run(port_engine, scenario)
    out = run(lambda: port_engine(admission="queue",
                                  max_inflight_entities=2), scenario)
    assert_same(out, ref)
    assert ref["stats"]["matched"] == out["stats"]["matched"]
    assert ref["stats"]["failed"] == out["stats"]["failed"] == 0
    # and the reference's queue engine gives the same bytes
    want = run(lambda: ref_engine(admission="queue",
                                  max_inflight_entities=2), scenario)
    assert_same(out, want)


# ------------------------------------------------------------ shed policy
def test_shed_rejects_fast_with_retry_after_and_recovers():
    eng = port_engine(transport=SLOW, admission="shed",
                      max_inflight_entities=4)
    try:
        _add(eng, 4)
        f1 = eng.submit(_find())
        with pytest.raises(OverloadError) as ei:
            eng.submit(_find())
        assert ei.value.retry_after_s > 0
        assert ei.value.load.get("score", 0) > 0
        assert "inflight_frac" in ei.value.load
        assert eng.admission_stats()["shed"] >= 1
        assert f1.result(60)["stats"]["failed"] == 0
        assert eng.submit(_find()).result(60)["stats"]["failed"] == 0
        st = eng.admission_stats()
        assert st["inflight"] == 0 and st["pending"] == 0
        assert st["peak_inflight"] <= 4
    finally:
        eng.shutdown()


def test_shed_rejects_before_add_ingest_side_effects():
    eng = port_engine(transport=SLOW, admission="shed",
                      max_inflight_entities=2)
    try:
        _add(eng, 2)
        blocker = eng.submit(_find())
        assert wait(lambda: eng.admission_stats()["inflight"] > 0)
        img = np.zeros((8, 8, 3), np.float32)
        with pytest.raises(OverloadError):
            eng.submit([{"AddImage": {
                "properties": {"category": "shed-add"}, "data": img,
                "operations": [{"type": "grayscale"}]}}])
        # the shed Add must NOT have ingested its entity
        assert eng.meta.find_ids("image",
                                 {"category": ["==", "shed-add"]}) == []
        blocker.result(60)
    finally:
        eng.shutdown()


def test_saturated_shed_engine_still_serves_full_cache_hits():
    eng = port_engine(transport=SLOW, admission="shed",
                      max_inflight_entities=2, cache_capacity=32)
    try:
        _add(eng, 2)
        _add(eng, 2, category="cached")
        warm = eng.execute(_find(category="cached"), timeout=60)
        assert warm["stats"]["failed"] == 0
        blocker = eng.submit(_find())
        assert wait(lambda: eng.admission_stats()["inflight"] == 2)
        res = eng.submit(_find(category="cached")).result(10)
        assert res["stats"]["failed"] == 0
        assert res["stats"]["cache_full_hits"] == 2
        blocker.result(60)
    finally:
        eng.shutdown()


# ----------------------------------------------------------- queue policy
def test_queue_policy_bounds_inflight_and_drains_by_priority():
    eng = port_engine(transport=SLOW, admission="queue",
                      max_inflight_entities=1)
    try:
        _add(eng, 1)
        for cat in ("p0", "p1", "p5"):
            _add(eng, 1, category=cat)
        blocker = eng.submit(_find())
        assert wait(lambda: eng.admission_stats()["inflight"] == 1)
        order = []
        lock = threading.Lock()

        def _done(name):
            def cb(fut):
                with lock:
                    order.append(name)
            return cb

        futs = {}
        for name, pri in (("p0", 0), ("p1", 1), ("p5", 5)):
            futs[name] = eng.submit(_find(category=name), priority=pri)
            futs[name].add_done_callback(_done(name))
        assert eng.admission_stats()["pending"] == 3
        blocker.result(60)
        for f in futs.values():
            assert f.result(60)["stats"]["failed"] == 0
        assert order == ["p5", "p1", "p0"]
        st = eng.admission_stats()
        assert st["peak_inflight"] <= 1
        assert st["pending"] == 0 and st["inflight"] == 0
    finally:
        eng.shutdown()


def test_queue_cap_overflow_sheds():
    eng = port_engine(transport=SLOW, admission="queue",
                      max_inflight_entities=1, admission_queue_cap=1)
    try:
        _add(eng, 1)
        blocker = eng.submit(_find())
        assert wait(lambda: eng.admission_stats()["inflight"] == 1)
        queued = eng.submit(_find())          # fills the pending lane
        with pytest.raises(OverloadError, match="queue full"):
            eng.submit(_find())
        blocker.result(60)
        assert queued.result(60)["stats"]["failed"] == 0
    finally:
        eng.shutdown()


def test_cancelling_queued_query_drops_pending_admissions():
    eng = port_engine(transport=SLOW, admission="queue",
                      max_inflight_entities=1)
    try:
        _add(eng, 1)
        blocker = eng.submit(_find())
        assert wait(lambda: eng.admission_stats()["inflight"] == 1)
        parked = eng.submit(_find())
        assert eng.admission_stats()["pending"] == 1
        assert parked.cancel()
        assert eng.admission_stats()["pending"] == 0
        with pytest.raises(CancelledError):
            parked.result(5)
        assert blocker.result(60)["stats"]["failed"] == 0
        st = eng.admission_stats()
        assert st["inflight"] == 0 and st["dropped"] >= 1
    finally:
        eng.shutdown()


# --------------------------------------------- the 10x overload chaos storm
def _storm(policy, n_entities=4, max_inflight=8, clients=20):
    """``tests/test_admission.py::_storm``: submit() at ~10x capacity
    across all four backends with seeded random cancels."""
    pipe = [
        {"type": "resize", "width": 16, "height": 16},
        {"type": "remote", "url": "u", "options": {"id": "grayscale"}},
        {"type": "udf", "options": {"id": SCALE, "k": 2.0}},
        {"type": "blur", "ksize": 3, "sigma_x": 1.0},
        {"type": "threshold", "value": 0.4},
    ]
    eng = port_engine(
        dispatch="cost", num_native_workers=2, device_backend="cpu",
        transport=dict(network_latency_s=0.001, service_time_s=0.01),
        cache_capacity=64, coalesce_window_ms=2.0,
        cost_overrides={
            "grayscale": {"remote": 1e-6, "native": 10.0,
                          "batcher": 10.0, "device": 10.0},
            SCALE: {"batcher": 1e-6, "native": 10.0,
                    "remote": 10.0, "device": 10.0},
            "blur": {"device": 1e-6, "native": 10.0,
                     "remote": 10.0, "batcher": 10.0},
        },
        admission=policy, max_inflight_entities=max_inflight,
        admission_queue_cap=10_000)
    try:
        _add(eng, n_entities)
        eng.execute(_find(ops=pipe), timeout=120)
        # each client's priority, cancel draw and cancel delay, drawn
        # from the reference's seeded stream in client order up front:
        # drawn inside the threads (as the reference does), which client
        # gets which draw depends on how fast an admitted submit returns
        # against the other threads' sheds, and the two admitted queries
        # were both cancelled in about 1 run in 25 under -n 6
        rng = random.Random(0xADA)
        plans = [(rng.randrange(3), rng.random(), rng.random())
                 for _ in range(clients)]
        outcomes = []
        violations = []
        lock = threading.Lock()
        stop_sampling = threading.Event()

        def sampler():
            while not stop_sampling.is_set():
                st = eng.admission_stats()
                if st["inflight"] > max_inflight:
                    violations.append(st["inflight"])
                time.sleep(0.001)

        def client(cid):
            priority, cancel_draw, delay_draw = plans[cid]
            try:
                fut = eng.submit(_find(ops=pipe), cache=False,
                                 priority=priority)
            except OverloadError as e:
                with lock:
                    outcomes.append(("shed", e))
                return
            if cancel_draw < 0.25:
                time.sleep(delay_draw * 0.02)
                fut.cancel()
                with lock:
                    outcomes.append(("cancel", fut))
                return
            try:
                res = fut.result(timeout=120)
                with lock:
                    outcomes.append(("done", res))
            except CancelledError:
                with lock:
                    outcomes.append(("cancel", fut))

        s = threading.Thread(target=sampler, daemon=True)
        s.start()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop_sampling.set()
        s.join(5)
        assert len(outcomes) == clients
        assert not violations, \
            f"in-flight exceeded {max_inflight}: {violations[:5]}"
        st = eng.admission_stats()
        assert st["peak_inflight"] <= max_inflight, st
        for kind, res in outcomes:
            if kind == "done":
                assert res["stats"]["matched"] == n_entities
                assert res["stats"]["failed"] == 0
                assert len(res["entities"]) == n_entities
        assert wait(lambda: not eng.pool.inflight and
                    eng.loop.queue1.qsize() == 0 and
                    eng.batcher_backend.pending() == 0 and
                    eng.device_backend.pending() == 0 and
                    eng.active_sessions() == 0, timeout=20), \
            "storm leaked work"
        assert wait(lambda: eng.admission_stats()["inflight"] == 0 and
                    eng.admission_stats()["pending"] == 0, timeout=10)
        res = eng.execute(_find(ops=pipe), timeout=120)
        assert res["stats"]["failed"] == 0
        return outcomes, eng.admission_stats()
    finally:
        eng.shutdown()


def test_overload_storm_queue_policy_bounds_inflight():
    outcomes, st = _storm("queue")
    assert st["queued"] > 0
    assert not any(kind == "shed" for kind, _ in outcomes)
    assert any(kind == "done" for kind, _ in outcomes)


def test_overload_storm_shed_policy_bounds_inflight_and_sheds():
    outcomes, st = _storm("shed")
    sheds = [e for kind, e in outcomes if kind == "shed"]
    assert sheds, "10x storm shed nothing"
    assert all(e.retry_after_s > 0 for e in sheds)
    assert any(kind == "done" for kind, _ in outcomes)


# ------------------------------------------------------ shutdown semantics
def test_shutdown_with_inflight_sessions_is_deterministic():
    eng = port_engine(transport=SLOW, num_remote_servers=2)
    try:
        _add(eng, 8)
        futs = [eng.submit(_find()) for _ in range(4)]
        t0 = time.monotonic()
    finally:
        eng.shutdown()
    assert time.monotonic() - t0 < 30
    for f in futs:
        assert f.done()
        with pytest.raises(CancelledError):
            f.result(1)
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(_find())
    eng.shutdown()   # idempotent


def test_offload_backend_rejects_late_submit_and_drains_accepted_work():
    from repro_torch.serving.batcher import UDFBatcherBackend

    replies: queue.Queue = queue.Queue()
    be = UDFBatcherBackend(group_size=4, max_wait_s=0.01)
    be.bind(replies, lambda qid: False)
    op = make_op(SCALE, {"k": 2.0}, where="udf")
    ents = [Entity(eid=f"e{i}", kind="image",
                   data=torch.full((2, 2, 3), float(i)),
                   ops=[op], query_id="q") for i in range(3)]
    for e in ents:
        be.submit(e)
    # shutdown queues the poison pill then DRAINS the accepted work
    be.shutdown()
    got = {}
    while len(got) < 3:
        kind, ent, res, err = replies.get(timeout=5)
        assert kind == "batched" and err is None
        got[ent.eid] = res
    for i, e in enumerate(ents):
        torch.testing.assert_close(got[e.eid], torch.full((2, 2, 3), 2.0 * i))
    with pytest.raises(RuntimeError, match="shut down"):
        be.submit(ents[0])


def test_device_backend_rejects_late_submit_after_shutdown():
    from repro_torch.query.device_backend import DeviceBackend

    replies: queue.Queue = queue.Queue()
    be = DeviceBackend(batch_size=2, max_wait_s=0.01, calibrate=False,
                       device=torch.device("cpu"))
    be.bind(replies, lambda qid: False)
    ent = Entity(eid="d0", kind="image", data=torch.ones(4, 4, 3),
                 ops=[make_op("grayscale", {})], query_id="q")
    be.submit(ent)
    be.shutdown()
    kind, got, res, err, advance = replies.get(timeout=5)
    assert kind == "device" and err is None and got.eid == "d0"
    assert advance == 1
    with pytest.raises(RuntimeError, match="shut down"):
        be.submit(ent)


# ------------------------------------------------ fair-queue lane accounting
def test_fair_queue_lane_counts_stay_consistent_under_discard_race():
    q = FairQueue(fair=True)
    qids = [f"q{i}" for i in range(6)]
    stop = threading.Event()
    popped = []

    def producer():
        i = 0
        while not stop.is_set():
            qid = qids[i % len(qids)]
            q.put(Entity(eid=f"{qid}-{i}", kind="image", data=None,
                         ops=[], query_id=qid))
            i += 1

    def consumer():
        while not stop.is_set():
            ent = q.get(timeout=0.01)
            if ent is not None:
                popped.append(ent.eid)

    def discarder():
        rng = random.Random(5)
        while not stop.is_set():
            q.discard(rng.choice(qids))
            time.sleep(0.0005)

    threads = ([threading.Thread(target=producer)]
               + [threading.Thread(target=consumer) for _ in range(3)]
               + [threading.Thread(target=discarder) for _ in range(2)])
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(5)
    depths = q.depths()
    with q._cv:
        lanes = {qid: len(lane) for qid, lane in q._lanes.items()}
    assert depths == {k: v for k, v in lanes.items() if v > 0}
    assert sum(depths.values()) == q.qsize()
    q.put(Entity(eid="late", kind="image", data=None, ops=[],
                 query_id="late-query"))
    seen = set()
    for _ in range(q.qsize()):
        ent = q.get(timeout=1.0)
        assert ent is not None
        seen.add(ent.eid)
        if ent.eid == "late":
            break
    assert "late" in seen


# --------------------------------------------- snapshots before callbacks
def test_batched_fanout_records_all_snapshots_despite_raising_callback():
    """A client callback that raises while a coalesced batch fans out
    must not skip the cache snapshots, or the completions, of the rest
    of the group."""

    class _StubPool:
        def handle_response(self, tag, req, payload):
            return ("done", payload)

        def reissue_stragglers(self):
            pass

    rc = ResultCache(capacity=16)
    raised = []

    def boom(ent):
        raised.append(ent.eid)
        raise RuntimeError("client callback exploded")

    loop = EventLoop(_StubPool(), ERD(), num_native_workers=1,
                     on_entity_done=boom, result_cache=rc)
    try:
        op = make_op("grayscale", {}, where="remote")
        sigs = prefix_signatures([op])
        ents = []
        for i in range(4):
            e = Entity(eid=f"c{i}", kind="image", data=torch.ones(2, 2, 3),
                       ops=[op], query_id="q", cacheable=True)
            e.cache_sigs = sigs
            ents.append(e)

        class _Req:
            entity = ents

        results = [torch.full((2, 2), 0.5) for _ in ents]
        loop._handle_response("ok", _Req(), results)
        assert raised == [e.eid for e in ents]   # every member completed
        for e in ents:
            k, cached = rc.longest_cached_prefix(e.eid, sigs)
            assert k == 1, f"snapshot skipped for {e.eid}"
            torch.testing.assert_close(cached, results[0])
    finally:
        loop.shutdown()


# ------------------------------------- review-sweep regression coverage
def test_reserve_claims_capacity_atomically_before_ingest():
    ctl = AdmissionController(max_inflight=2, policy="shed")

    class _E:
        def __init__(self, qid):
            self.query_id = qid

    ctl.reserve("a", 2, first_phase=True)
    assert ctl.stats()["reserved"] == 2
    with pytest.raises(OverloadError):
        ctl.reserve("b", 1, first_phase=True)
    with pytest.raises(OverloadError):
        ctl.admit_phase("c", [_E("c")], 0, first_phase=True)
    admitted = ctl.admit_phase("a", [_E("a"), _E("a")], 0, first_phase=True)
    assert len(admitted) == 2
    st = ctl.stats()
    assert st["inflight"] == 2 and st["reserved"] == 0
    assert st["peak_inflight"] <= 2
    ctl.reserve("d", 0, first_phase=True)   # no-op claim
    ctl.drop_query("a")
    ctl.reserve("e", 2, first_phase=True)
    ctl.drop_query("e")
    assert ctl.stats()["reserved"] == 0 and ctl.inflight() == 0


def test_cancel_racing_admission_never_leaks_inflight_slots():
    eng = port_engine(transport=SLOW, admission="shed",
                      max_inflight_entities=4)
    try:
        _add(eng, 2)
        fut = eng.submit(_find())
        qid = fut._session.qid
        assert fut.cancel()
        assert wait(lambda: eng.admission_stats()["inflight"] == 0)
        # replay the racy interleaving: drop_query already ran; now the
        # stale phase launch arrives
        op = make_op("grayscale", {}, where="native")
        stale = [Entity(eid=f"s{i}", kind="image", data=torch.ones(4, 4, 3),
                        ops=[op], query_id=qid) for i in range(3)]
        eng._launch(stale, priority=0, first_phase=True)
        st = eng.admission_stats()
        assert st["inflight"] == 0 and st["pending"] == 0, st
        assert eng.submit(_find()).result(60)["stats"]["failed"] == 0
    finally:
        eng.shutdown()


def test_store_write_back_failure_fails_entity_not_hangs_session():
    eng = port_engine()
    try:
        def boom(ent):
            raise IOError("blob store full")
        eng._store_result = boom
        seen = []
        fut = eng.submit([{"AddImage": {
            "properties": {"category": "wb-fail"},
            "data": np.zeros((8, 8, 3), np.float32),
            "operations": [{"type": "grayscale"}]}}], on_entity=seen.append)
        res = fut.result(30)   # completes, no hang
        assert len(res["entities"]) == 1
        (ent,) = seen          # streamed after the failed write-back
        assert "store write-back failed" in ent.failed
    finally:
        eng.shutdown()
