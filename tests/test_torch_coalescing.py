"""The port's cross-session remote coalescing held against
``tests/test_coalescing.py``: window batching, reply fan-out, per-query
cancellation inside shared batches, and batch-aware remote accounting
(``cost_batch``, the entity-weighted ``RemoteServer.pending_load``, the
reference's ``load``, and the straggler estimate).  Coalesced responses
are also compared with the reference engine's per-entity ones, byte for
byte.

As in the reference, grouping is decided by explicit flushes against a
window no test waits out: poll ``pending_coalesced()`` until the
expected entities are buffered, then ``flush_coalesced()``."""
import queue
from concurrent.futures import CancelledError

import pytest
import torch

from repro_torch.core.entity import Entity
from repro_torch.core.pipeline import make_op
from repro_torch.core.remote import (RemoteServerPool, TransportModel,
                                     _batch_size)
from torch_parity import (add_images, assert_same, find, port_engine,
                          ref_engine, run, wait)

torch.set_num_threads(1)

NEVER_MS = 600_000.0

REMOTE_PIPE = [
    {"type": "resize", "width": 24, "height": 24},
    {"type": "remote", "url": "http://s/box", "options": {"id": "facedetect_box"}},
    {"type": "threshold", "value": 0.4},
]


def _add(eng, n=8, size=32, category="lfw"):
    """``tests/test_coalescing.py::_add_images``."""
    return add_images(eng, n, size, category, seed=0)


def _find(category="lfw", ops=REMOTE_PIPE):
    return find(category, ops)


def _flush_at(eng, expect: int, timeout: float = 30.0):
    """Wait until exactly ``expect`` entities sit in open coalescing
    groups, then force-dispatch them."""
    wait(lambda: eng.pending_coalesced() >= expect, timeout)
    assert eng.pending_coalesced() == expect, \
        f"buffered {eng.pending_coalesced()}, expected {expect}"
    eng.flush_coalesced()


def _execute_flushed(eng, query, expect: int, timeout: float = 60.0, **kw):
    fut = eng.submit(query, **kw)
    _flush_at(eng, expect, timeout)
    return fut.result(timeout=timeout)


def _per_entity(n):
    def scenario(e):
        _add(e, n)
        return e.execute(_find(), timeout=60), e.utilization()
    return scenario


# ------------------------------------------------------------ coalescing
def test_coalesced_results_match_per_entity_dispatch():
    r_per, u_per = run(port_engine, _per_entity(16))
    eng_co = port_engine(coalesce_window_ms=NEVER_MS)
    try:
        _add(eng_co, 16)
        r_co = _execute_flushed(eng_co, _find(), expect=16)
        u = eng_co.utilization()
    finally:
        eng_co.shutdown()
    assert_same(r_co, r_per)
    # exactly one flush of all 16: one batched request
    assert u["coalesced_batches"] == 1
    assert u["coalesced_entities"] == 16
    assert u["remote_dispatched"] == 1
    assert u_per["remote_dispatched"] == 16
    want, _ = run(ref_engine, _per_entity(16))
    assert_same(r_co, want)


def test_window_off_by_default_keeps_per_entity_dispatch():
    _, u = run(port_engine, _per_entity(6))
    assert u["coalesced_batches"] == 0
    assert u["remote_dispatched"] == 6      # one request per entity


def test_window_expiry_flushes_without_explicit_flush():
    r_per, _ = run(port_engine, _per_entity(6))
    r, _ = run(lambda: port_engine(coalesce_window_ms=10), _per_entity(6))
    assert r["stats"]["failed"] == 0
    assert_same(r, r_per)


def test_flush_coalesced_with_nothing_buffered_is_harmless():
    eng = port_engine(coalesce_window_ms=NEVER_MS)
    try:
        _add(eng, 4)
        eng.flush_coalesced()                  # empty flush: no-op
        assert eng.pending_coalesced() == 0
        r = _execute_flushed(eng, _find(), expect=4)
        assert r["stats"]["failed"] == 0
    finally:
        eng.shutdown()


def test_max_batch_flushes_before_any_window():
    eng = port_engine(coalesce_window_ms=NEVER_MS, coalesce_max_batch=4)
    try:
        _add(eng, 8)
        r = eng.execute(_find(), timeout=60)
        assert r["stats"]["failed"] == 0
        u = eng.utilization()
        assert u["coalesced_batches"] == 2
        assert u["coalesced_entities"] == 8
        assert u["remote_dispatched"] == 2
    finally:
        eng.shutdown()


def test_entities_from_different_sessions_share_one_batch():
    eng = port_engine(coalesce_window_ms=NEVER_MS, coalesce_max_batch=64)
    try:
        _add(eng, 4)
        _execute_flushed(eng, _find(), expect=4, cache=False)   # warmup
        base = eng.utilization()["coalesced_entities"]
        futs = [eng.submit(_find()) for _ in range(2)]
        _flush_at(eng, expect=8)       # both sessions buffered together
        for f in futs:
            assert f.result(timeout=60)["stats"]["failed"] == 0
        grouped = eng.utilization()["coalesced_entities"] - base
        assert grouped == 8            # one batch mixed the two sessions
    finally:
        eng.shutdown()


def test_cancel_drops_only_that_querys_members_from_shared_batch():
    eng = port_engine(num_remote_servers=1,
                      coalesce_window_ms=NEVER_MS, coalesce_max_batch=64)
    try:
        _add(eng, 6)
        doomed = eng.submit(_find())
        kept = eng.submit(_find())
        wait(lambda: eng.pending_coalesced() >= 12, 30)
        assert eng.pending_coalesced() == 12
        assert doomed.cancel()
        with pytest.raises(CancelledError):
            doomed.result(timeout=5)
        eng.flush_coalesced()
        r = kept.result(timeout=60)
        assert r["stats"]["matched"] == 6
        assert r["stats"]["failed"] == 0
        assert eng.utilization()["coalesced_entities"] == 6  # kept's only
        wait(lambda: not eng.pool.inflight)
        assert not eng.pool.inflight
        r2 = _execute_flushed(eng, _find(), expect=6)
        assert r2["stats"]["failed"] == 0
    finally:
        eng.shutdown()


def test_coalescing_composes_with_result_cache():
    eng = port_engine(coalesce_window_ms=NEVER_MS, cache_capacity=256)
    try:
        _add(eng, 8)
        r1 = _execute_flushed(eng, _find(), expect=8)   # populates cache
        r2 = eng.execute(_find(), timeout=60)           # full hits: no
        assert r2["stats"]["cache_full_hits"] == 8      # remote work at all
        assert eng.pending_coalesced() == 0
        assert_same(r2, r1)
    finally:
        eng.shutdown()


# ------------------------------------- batch-aware remote accounting
def _ents(n, shape=(4, 4, 3)):
    op = make_op("grayscale")
    return op, [Entity(str(i), "image", torch.zeros(shape), ops=[op])
                for i in range(n)]


def test_batched_request_sleeps_cost_batch_not_cost_sum():
    t = TransportModel(network_latency_s=0.05, service_time_s=0.001,
                       execute_ops=False)
    pool = RemoteServerPool(1, t)
    try:
        op, ents = _ents(4, (8, 8, 3))
        reply: queue.Queue = queue.Queue()
        pool.dispatch(ents, op, reply)
        tag, req, payload = reply.get(timeout=10)
        assert tag == "ok" and len(payload) == 4
        server = pool.servers[0]
        per_payload_sum = sum(t.cost(e.data.nbytes) for e in ents)
        batch_cost = t.cost_batch([e.data.nbytes for e in ents])
        assert abs(server.transport_busy_s - batch_cost) < 1e-9
        # the amortization is real: one latency, not four
        assert server.transport_busy_s < per_payload_sum - 0.1
    finally:
        pool.shutdown()


def test_server_load_counts_entities_not_requests():
    pool = RemoteServerPool(1, TransportModel(network_latency_s=0.2,
                                              execute_ops=False))
    try:
        op, batch = _ents(5)
        reply: queue.Queue = queue.Queue()
        pool.dispatch(batch, op, reply)
        pool.dispatch(Entity("s", "image", torch.zeros(4, 4, 3), ops=[op]),
                      op, reply)
        assert pool.servers[0].pending_load() == 6   # 5 + 1 entities
        for _ in range(2):
            reply.get(timeout=10)
        wait(lambda: not pool.servers[0].pending_load(), 5)
        assert pool.servers[0].pending_load() == 0
    finally:
        pool.shutdown()


def test_straggler_estimate_amortizes_batches():
    pool = RemoteServerPool(1, TransportModel(network_latency_s=0.0,
                                              service_time_s=0.01,
                                              execute_ops=False))
    try:
        op, batch = _ents(8)
        reply: queue.Queue = queue.Queue()
        assert _batch_size(pool.inflight[pool.dispatch(batch, op, reply)]) == 8
        tag, req, payload = reply.get(timeout=10)
        est_before = pool._lat_est
        pool.handle_response(tag, req, payload)
        # the batch took ~8x service time; the estimate moves toward the
        # amortized per-entity latency, not the batch wall
        assert pool._lat_est <= 0.9 * est_before + 0.1 * 0.05
    finally:
        pool.shutdown()
