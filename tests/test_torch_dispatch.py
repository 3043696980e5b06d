"""The port's cost-model dispatch held against ``tests/test_dispatch.py``:
router placement under forced cost regimes, segment handoffs,
cache-resume-aware routing, the batcher backend, and the static mode's
byte identity.  Engine responses and the router's placement counts of
fixed answer are compared with the JAX package's engine on the same
data (``torch_parity``)."""
import threading
import time

import numpy as np
import pytest
import torch

import repro.core.udf as ref_udf
from repro_torch.core import pipeline as tpipe
from repro_torch.core.pipeline import make_op, parse_operations, run_op
from repro_torch.core.remote import RemoteServerPool, TransportModel
from repro_torch.core.udf import (register_batched_udf, register_udf,
                                  unregister_udf)
from repro_torch.query.dispatch import (BATCHER, NATIVE, REMOTE, Backend,
                                        BackendRouter, NativeBackend,
                                        OpCostTracker, RemoteBackend,
                                        StaticRouter)
from torch_parity import (SLOW, TOL, add_images, assert_same, entities,
                          find, port_engine, ref_engine, run, wait)

torch.set_num_threads(1)

DOUBLE = "t_dsp_double"


@pytest.fixture(scope="module", autouse=True)
def dsp_double():
    """A cheap batchable UDF in both packages: per-entity and batched
    variants are result-equivalent by construction."""
    register_udf(DOUBLE, lambda img, factor=2.0: img * factor)
    register_batched_udf(DOUBLE,
                         lambda imgs, factor=2.0: [i * factor for i in imgs])
    ref_udf.register_udf(DOUBLE,
                         lambda img, factor=2.0: np.asarray(img) * factor)
    ref_udf.register_batched_udf(
        DOUBLE, lambda imgs, factor=2.0: [np.asarray(i) * factor
                                          for i in imgs])
    yield
    unregister_udf(DOUBLE)


MIXED_PIPE = [
    {"type": "resize", "width": 16, "height": 16},
    {"type": "remote", "url": "u", "options": {"id": "grayscale"}},
    {"type": "udf", "options": {"id": DOUBLE, "factor": 2.0}},
    {"type": "threshold", "value": 0.4},
]

SPLIT_OVERRIDES = {
    # transport-bound regime for grayscale (remote forced cheap), model
    # regime for the UDF (batcher forced cheap): the chain splits
    # native -> remote -> batcher -> native
    "grayscale": {"remote": 1e-6, "native": 10.0, "batcher": 10.0},
    DOUBLE: {"batcher": 1e-6, "native": 10.0, "remote": 10.0},
}


def _add(eng, n=6, size=24, category="dsp"):
    """``tests/test_dispatch.py::_add_images``."""
    return add_images(eng, n, size, category, seed=3)


def _find(category="dsp", ops=MIXED_PIPE):
    return find(category, ops)


def _both(scenario, **kw):
    """``scenario(engine)`` on a port and a reference engine with the
    same knobs: (port's, reference's)."""
    return (run(lambda: port_engine(**kw), scenario),
            run(lambda: ref_engine(**kw), scenario))


def _routing(stats):
    return {k: stats[k] for k in ("placements", "chains_routed",
                                  "handoffs", "segments")}


# ----------------------------------------------------- static byte-identity
def test_default_engine_is_static_with_no_router():
    eng = port_engine()
    try:
        assert eng.dispatch == "static"
        assert eng.router is None
        assert eng.batcher_backend is None
        assert eng.cost_tracker is None
        assert eng.dispatch_stats() == {"mode": "static"}
    finally:
        eng.shutdown()


def test_static_response_identical_to_default_engine():
    eng_def = port_engine()
    eng_sta = port_engine(dispatch="static")
    try:
        _add(eng_def)
        _add(eng_sta)
        r_def = eng_def.execute(_find(), timeout=60)
        r_sta = eng_sta.execute(_find(), timeout=60)
        assert_same(r_def, r_sta)
        assert r_def["stats"]["matched"] == r_sta["stats"]["matched"]
        assert r_def["stats"]["failed"] == r_sta["stats"]["failed"] == 0
        for rec in eng_sta.erd.snapshot().values():
            assert rec["failed"] is None
    finally:
        eng_def.shutdown()
        eng_sta.shutdown()
    want = run(ref_engine, lambda e: (_add(e), e.execute(_find(), timeout=60))[1])
    assert_same(r_sta, want)


def test_dispatch_knob_validation():
    with pytest.raises(ValueError, match="dispatch"):
        port_engine(dispatch="bogus")


def test_cost_overrides_validation_leaks_no_threads():
    before = threading.active_count()
    with pytest.raises(ValueError, match="unknown"):
        port_engine(dispatch="cost",
                    cost_overrides={"grayscale": {"gpu": 1e-6}})
    with pytest.raises(ValueError, match="must be a dict"):
        port_engine(dispatch="cost", cost_overrides={"grayscale": 1e-6})
    assert threading.active_count() == before


def test_batched_udf_result_count_contract():
    # a batched UDF returning fewer results than inputs must surface as
    # per-entity failures, never strand entities (the query would hang)
    register_udf("t_dsp_short", lambda img: img)
    register_batched_udf("t_dsp_short", lambda imgs: [])   # always short
    eng = port_engine(dispatch="cost", batcher_max_wait_ms=100.0,
                      cost_overrides={"t_dsp_short": {"batcher": 1e-9,
                                                      "native": 10.0,
                                                      "remote": 10.0}})
    try:
        _add(eng, n=4)
        res = eng.execute(_find(ops=[
            {"type": "udf", "options": {"id": "t_dsp_short"}}]), timeout=30)
        assert res["stats"]["failed"] == 4
        assert eng.dispatch_stats()["batcher"]["errors"] >= 1
    finally:
        eng.shutdown()
        unregister_udf("t_dsp_short")


# ------------------------------------------------- forced cost regimes
def test_cost_dispatch_matches_static_results():
    def scenario(e):
        _add(e)
        return e.execute(_find(), timeout=60), _routing(e.dispatch_stats())

    r_sta = run(port_engine, lambda e: (_add(e),
                                        e.execute(_find(), timeout=60))[1])
    (r_cost, routed), (want, want_routed) = _both(
        scenario, dispatch="cost", cost_overrides=SPLIT_OVERRIDES)
    assert r_cost["stats"]["failed"] == 0
    assert_same(r_cost, r_sta)
    # the reference's cost engine answers and routes the same way
    assert_same(r_cost, want)
    assert routed == want_routed


def test_transport_bound_regime_remote_wins():
    # native forced expensive, remote cheap: the remote-tagged op AND the
    # native-tagged grayscale both offload
    eng = port_engine(dispatch="cost", cost_overrides={
        "grayscale": {"remote": 1e-6, "native": 10.0, "batcher": 10.0}})
    try:
        _add(eng)
        res = eng.execute(_find(ops=[{"type": "grayscale"}]), timeout=60)
        assert res["stats"]["failed"] == 0
        stats = eng.dispatch_stats()
        assert stats["placements"]["remote"] == 6
        assert stats["placements"]["native"] == 0
        assert eng.utilization()["remote_dispatched"] >= 6
    finally:
        eng.shutdown()


def test_compute_bound_regime_native_wins():
    # a remote-TAGGED op whose round trip dwarfs its compute stays local
    eng = port_engine(dispatch="cost",
                      transport=dict(network_latency_s=5.0,
                                     service_time_s=0.0))
    try:
        _add(eng)
        ops = [{"type": "remote", "url": "u", "options": {"id": "grayscale"}}]
        res = eng.execute(_find(ops=ops), timeout=60)
        assert res["stats"]["failed"] == 0
        stats = eng.dispatch_stats()
        assert stats["placements"]["native"] == 6
        assert stats["placements"]["remote"] == 0
        assert eng.utilization()["remote_dispatched"] == 0
    finally:
        eng.shutdown()


def test_model_ops_route_to_batcher_once_calibrated():
    eng = port_engine(dispatch="cost")
    try:
        _add(eng)
        # calibrate: the tracker knows this op is expensive natively, so
        # the batcher's group amortization wins without any override
        op = make_op(DOUBLE, {"factor": 2.0}, where="udf")
        eng.cost_tracker.observe(op, 0.5)
        res = eng.execute(_find(ops=[
            {"type": "udf", "options": {"id": DOUBLE, "factor": 2.0}}]),
            timeout=60)
        assert res["stats"]["failed"] == 0
        stats = eng.dispatch_stats()
        assert stats["placements"]["batcher"] == 6
        assert stats["batcher"]["entities_run"] == 6
        assert stats["batcher"]["groups_run"] >= 1
    finally:
        eng.shutdown()


# -------------------------------------------------- segment handoffs
def test_segment_handoff_native_remote_batcher_chain():
    def scenario(e):
        _add(e, n=4)
        res = e.execute(_find(), timeout=60)
        return (res, e.dispatch_stats(),
                e.utilization()["remote_dispatched"])

    (res, stats, remote), (want, want_stats, _) = _both(
        scenario, dispatch="cost", cost_overrides=SPLIT_OVERRIDES)
    assert res["stats"]["failed"] == 0
    # per chain: native(resize) -> remote(grayscale) ->
    # batcher(udf) -> native(threshold) = 4 segments, 3 handoffs
    assert stats["chains_routed"] == 4
    assert stats["handoffs"] == 12
    assert stats["segments"] == 16
    assert stats["placements"] == {"native": 8, "remote": 4, "batcher": 4}
    assert remote == 4
    assert stats["batcher"]["entities_run"] == 4
    assert _routing(stats) == _routing(want_stats)
    assert_same(res, want)


def test_handoff_data_correct_across_backends():
    img = np.random.default_rng(5).uniform(0, 1, (24, 24, 3)).astype(np.float32)

    def scenario(e):
        e.add_entity("image", img, {"category": "dsp"})
        return e.execute(_find(), timeout=60)

    res, want = _both(scenario, dispatch="cost",
                      cost_overrides=SPLIT_OVERRIDES)
    (got,) = entities(res).values()
    # the same pipeline run inline, op by op
    inline = torch.from_numpy(img)
    for op in parse_operations(MIXED_PIPE):
        inline = run_op(op, inline)
    np.testing.assert_array_equal(got, inline.numpy())
    assert_same(res, want)


def test_route_respects_cache_prefix_resume():
    eng = port_engine(dispatch="cost", cache_capacity=64,
                      cost_overrides=SPLIT_OVERRIDES)
    try:
        _add(eng, n=3)
        eng.execute(_find(ops=MIXED_PIPE[:2]), timeout=60)  # caches prefix
        before = eng.dispatch_stats()
        res = eng.execute(_find(ops=MIXED_PIPE), timeout=60)
        assert res["stats"]["cache_prefix_hits"] == 3
        after = eng.dispatch_stats()
        placed = {b: after["placements"][b] - before["placements"][b]
                  for b in after["placements"]}
        # only ops AFTER the resume point were routed
        assert placed == {"native": 3, "remote": 0, "batcher": 3}
        assert after["chains_routed"] - before["chains_routed"] == 3
    finally:
        eng.shutdown()


def test_full_cache_hits_are_not_routed():
    eng = port_engine(dispatch="cost", cache_capacity=64)
    try:
        _add(eng, n=4)
        eng.execute(_find(ops=MIXED_PIPE[:1]), timeout=60)
        before = eng.dispatch_stats()["chains_routed"]
        res = eng.execute(_find(ops=MIXED_PIPE[:1]), timeout=60)
        assert res["stats"]["cache_full_hits"] == 4
        assert eng.dispatch_stats()["chains_routed"] == before
    finally:
        eng.shutdown()


# ----------------------------------------------------- dispatch="native"
def test_dispatch_native_forces_everything_onto_native_pool():
    eng = port_engine(dispatch="native")
    try:
        _add(eng)
        res = eng.execute(_find(), timeout=60)
        assert res["stats"]["failed"] == 0
        stats = eng.dispatch_stats()
        assert stats["placements"] == {"native": 24}
        assert stats["handoffs"] == 0
        assert eng.utilization()["remote_dispatched"] == 0
    finally:
        eng.shutdown()


def test_fusion_composes_with_routing(monkeypatch):
    # fuse_native keeps fusing native runs under dispatch != "static";
    # the port runs a fused run through pipeline.run_native_chain (the
    # reference's jitted _fused_chain), counted here by a spy
    native_pipe = [{"type": "resize", "width": 16, "height": 16},
                   {"type": "grayscale"},
                   {"type": "threshold", "value": 0.5}]
    from repro_torch.core import event_loop
    calls = []

    def spy(ops, img):
        calls.append(len(ops))
        return tpipe.run_native_chain(ops, img)

    monkeypatch.setattr(event_loop, "run_native_chain", spy)
    r_ref = run(port_engine, lambda e: (_add(e), e.execute(
        _find(ops=native_pipe), timeout=60))[1])
    assert not calls                       # unfused engine: no chain call
    r = run(lambda: port_engine(dispatch="native", fuse_native=True),
            lambda e: (_add(e), e.execute(_find(ops=native_pipe),
                                          timeout=60))[1])
    assert r["stats"]["failed"] == 0
    # eager PyTorch runs the same ops fused or not: equal bytes
    assert_same(r, r_ref)
    assert calls and max(calls) == 3       # the whole run in one call
    want = run(lambda: ref_engine(dispatch="native", fuse_native=True),
               lambda e: (_add(e), e.execute(_find(ops=native_pipe),
                                             timeout=60))[1])
    assert_same(r, want, atol=TOL)


def test_payload_estimate_threads_through_chain():
    # a post-downscale op is costed on the observed intermediate size,
    # not the entry payload
    tracker = OpCostTracker()
    resize_op = make_op("resize", {"width": 8, "height": 8}, where="native")
    tracker.observe(resize_op, 1e-4, out_bytes=8 * 8 * 3 * 4)
    t = TransportModel(network_latency_s=0.0, bandwidth_bytes_s=1e6)
    pool = RemoteServerPool(1, t)
    try:
        rb = RemoteBackend(pool, tracker)
        router = BackendRouter(
            [_FixedBackend(NATIVE, 1.0), rb], tracker=tracker, handoff_s=0.0)
        tail = make_op("grayscale", {}, where="remote")
        route = router.route([resize_op, tail], payload_bytes=1_000_000)
        assert route[1] == REMOTE
        route2 = router.route([tail], payload_bytes=1_000_000)
        assert route2[0] == NATIVE
    finally:
        pool.shutdown()


# --------------------------------------------------------- router units
class _FixedBackend(Backend):
    def __init__(self, name, cost, runnable=True):
        self.name = name
        self._cost = cost
        self._runnable = runnable
        self.placed = []

    def can_run(self, op):
        return self._runnable

    def estimate(self, op, payload_bytes):
        return self._cost

    def queue_depth(self):
        return 0

    def note_placed(self, op):
        self.placed.append(op.name)


def _ops(*names):
    return [make_op(n, {}, where="native") for n in names]


def test_router_handoff_penalty_prevents_thrashing():
    router = BackendRouter([_FixedBackend(NATIVE, 1.00),
                            _FixedBackend(REMOTE, 0.99)], handoff_s=0.1)
    assert router.route(_ops("a", "b", "c", "d")) == [NATIVE] * 4
    assert router.stats()["handoffs"] == 0


def test_router_switches_when_savings_exceed_penalty():
    router = BackendRouter([_FixedBackend(NATIVE, 1.0),
                            _FixedBackend(REMOTE, 0.1)], handoff_s=0.01)
    assert router.route(_ops("a", "b", "c")) == [REMOTE] * 3
    assert router.stats()["handoffs"] == 0
    assert router.stats()["segments"] == 1


def test_router_start_offset_routes_only_the_tail():
    router = BackendRouter([_FixedBackend(NATIVE, 1.0),
                            _FixedBackend(REMOTE, 0.1)], handoff_s=0.0)
    route = router.route(_ops("a", "b", "c"), start=2)
    assert len(route) == 3
    assert route[2] == REMOTE
    assert router.stats()["placements"][REMOTE] == 1
    assert router.route(_ops("a"), start=1) is None   # nothing to place
    assert sum(router.stats()["placements"].values()) == 1


def test_router_overrides_never_bypass_can_run():
    batcher = _FixedBackend(BATCHER, 1e-9, runnable=False)
    router = BackendRouter([_FixedBackend(NATIVE, 1.0), batcher],
                           overrides={"a": {BATCHER: 1e-12}}, handoff_s=0.0)
    assert router.route(_ops("a")) == [NATIVE]
    assert batcher.placed == []


def test_static_router_counts_placements():
    r = StaticRouter(NATIVE)
    assert r.route(_ops("a", "b")) == [NATIVE, NATIVE]
    assert r.stats()["placements"] == {NATIVE: 2}
    assert r.stats()["handoffs"] == 0


# ------------------------------------------------------ cost-model units
def test_op_cost_tracker_ewma_and_kinds():
    t = OpCostTracker(default_s=0.5, alpha=0.5)
    op = make_op("x", {}, where="native")
    assert t.estimate(op) == 0.5
    assert not t.known(op)
    t.observe(op, 1.0)
    assert t.estimate(op) == 1.0
    t.observe(op, 0.0)
    assert t.estimate(op) == pytest.approx(0.5)
    assert not t.known(op, kind="batched")
    t.observe(op, 0.125, kind="batched")
    assert t.estimate(op, kind="batched") == 0.125
    assert t.estimate(op) == pytest.approx(0.5)
    # the mean over the ops seen (the reference's mean_estimate)
    assert t.mean_cost_estimate() == pytest.approx(0.5)


def test_native_backend_estimate_grows_with_projected_load():
    class _Loop:
        num_native_workers = 2

        class t2_meter:
            @staticmethod
            def busy_seconds(since=0.0):
                return 0.0

            @staticmethod
            def utilization(*, workers, window_s=0.25):
                return 0.0

        class queue1:
            @staticmethod
            def qsize():
                return 0

    nb = NativeBackend(_Loop(), OpCostTracker(default_s=0.1))
    op = make_op("x", {}, where="native")
    base = nb.estimate(op, 0)
    for _ in range(8):
        nb.note_placed(op)
    assert nb.estimate(op, 0) > base    # backlog ledger pushes it up
    assert nb.can_run(op)


def test_remote_backend_transport_term_and_dead_pool():
    t = TransportModel(network_latency_s=0.05, bandwidth_bytes_s=1e6)
    pool = RemoteServerPool(1, t)
    try:
        rb = RemoteBackend(pool, OpCostTracker(default_s=0.0))
        op = make_op("x", {}, where="remote")
        small = rb.estimate(op, 0)
        big = rb.estimate(op, 1_000_000)
        assert small >= t.network_latency_s
        assert big > small + 1.0        # 2 MB over 1 MB/s round trip
        pool.kill_server(0)
        assert not rb.can_run(op)
        assert rb.estimate(op, 0) == float("inf")
    finally:
        pool.shutdown()


# ------------------------------------------------ batcher-backend engine
def test_batcher_groups_respect_group_size():
    eng = port_engine(dispatch="cost", batcher_group_size=4,
                      batcher_max_wait_ms=200.0,
                      cost_overrides={DOUBLE: {"batcher": 1e-9,
                                               "native": 10.0,
                                               "remote": 10.0}})
    try:
        _add(eng, n=8)
        res = eng.execute(_find(ops=[
            {"type": "udf", "options": {"id": DOUBLE, "factor": 2.0}}]),
            timeout=60)
        assert res["stats"]["failed"] == 0
        b = eng.dispatch_stats()["batcher"]
        assert b["entities_run"] == 8
        assert b["groups_run"] >= 2       # 8 entities, groups capped at 4
        assert b["pending"] == 0
    finally:
        eng.shutdown()


def test_cancel_with_batcher_routed_work_leaks_nothing():
    eng = port_engine(dispatch="cost", batcher_max_wait_ms=100.0,
                      cost_overrides=SPLIT_OVERRIDES,
                      transport=dict(SLOW))
    try:
        _add(eng, n=10)
        fut = eng.submit(_find())
        time.sleep(0.02)          # let some entities reach the backends
        assert fut.cancel()
        wait(lambda: not (eng.pool.inflight or eng.loop.queue1.qsize()
                          or eng.batcher_backend.pending()))
        assert not eng.pool.inflight
        assert eng.loop.queue1.qsize() == 0
        assert eng.batcher_backend.pending() == 0
        assert eng.active_sessions() == 0
        res = eng.execute(_find(), timeout=60)
        assert res["stats"]["matched"] == 10
        assert res["stats"]["failed"] == 0
    finally:
        eng.shutdown()


def test_cost_dispatch_composes_with_coalescing():
    eng = port_engine(dispatch="cost", coalesce_window_ms=60_000,
                      cost_overrides=SPLIT_OVERRIDES)
    try:
        _add(eng, n=6)
        fut = eng.submit(_find())
        wait(lambda: eng.pending_coalesced() >= 6, 30)
        assert eng.pending_coalesced() == 6   # all remote segments buffered
        eng.flush_coalesced()
        res = fut.result(timeout=60)
        assert res["stats"]["failed"] == 0
        assert eng.utilization()["coalesced_entities"] == 6
    finally:
        eng.shutdown()
    r_sta = run(port_engine, lambda e: (_add(e, n=6),
                                        e.execute(_find(), timeout=60))[1])
    assert_same(r_sta, res)
    want = run(ref_engine, lambda e: (_add(e, n=6),
                                      e.execute(_find(), timeout=60))[1])
    assert_same(res, want)
