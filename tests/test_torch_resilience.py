"""The port's fault tolerance held against ``tests/test_resilience.py``:
the seeded ``FaultInjector`` (its fault streams equal the reference's,
draw for draw), circuit breakers, the router's health veto, retry,
backoff and deadline rules in the remote pool, server death on every
backend path, the heartbeat monitor, and seeded chaos storms that must
degrade, never fail, under admission control.  The fault-off engine's
stats are compared with the reference engine's."""
import queue
import time

import pytest
import torch

from repro.distributed.fault import FaultInjector as RefFaultInjector
from repro_torch.core.entity import Entity
from repro_torch.core.pipeline import make_op
from repro_torch.core.remote import RemoteServerPool, TransportModel
from repro_torch.core.udf import (register_batched_udf, register_udf,
                                  unregister_udf)
from repro_torch.distributed.fault import (DeadlineExceeded, FaultInjector,
                                           NoLiveServersError,
                                           PermanentError, TransientError)
from repro_torch.query.dispatch import NATIVE, REMOTE, Backend, BackendRouter
from repro_torch.query.health import (CLOSED, HALF_OPEN, OPEN,
                                      CircuitBreaker, HealthRegistry)
from torch_parity import (FAST, add_images, assert_same, find, port_engine,
                          ref_engine, run)

torch.set_num_threads(1)

DOUBLE = "t_res_double"


@pytest.fixture(scope="module", autouse=True)
def res_double():
    register_udf(DOUBLE, lambda img, factor=2.0: img * factor)
    register_batched_udf(DOUBLE,
                         lambda imgs, factor=2.0: [i * factor for i in imgs])
    yield
    unregister_udf(DOUBLE)


REMOTE_PIPE = [
    {"type": "resize", "width": 16, "height": 16},
    {"type": "remote", "url": "u", "options": {"id": "grayscale"}},
    {"type": "threshold", "value": 0.4},
]


def _add(eng, n=6, size=24, category="res"):
    """``tests/test_resilience.py::_add_images``."""
    return add_images(eng, n, size, category, seed=5)


def _find(category="res", ops=REMOTE_PIPE):
    return find(category, ops)


def _transport(**kw):
    return TransportModel(**{**FAST, **kw})


# ------------------------------------------------------ injector units
INJECTOR_RATES = dict(error_rate=0.2, crash_rate=0.1, latency_rate=0.1,
                      die_rate=0.05, hang_rate=0.05, death_budget=100)


def _stream(fi, n=200):
    return [None if f is None else (f.kind, f.latency_s)
            for f in (fi.decide("remote:0") for _ in range(n))]


def test_fault_injector_is_deterministic_per_seed_and_site():
    a = FaultInjector(seed=42, **INJECTOR_RATES)
    b = FaultInjector(seed=42, **INJECTOR_RATES)
    seq_a = _stream(a)
    # interleave another site's draws in b: site streams are independent
    seq_b = []
    for _ in range(200):
        b.decide("backend:device")
        seq_b.extend(_stream(b, 1))
    assert seq_a == seq_b
    assert _stream(FaultInjector(seed=43, **INJECTOR_RATES)) != seq_a
    # one seed replays the reference's fault stream draw for draw
    assert seq_a == _stream(RefFaultInjector(seed=42, **INJECTOR_RATES))


def test_fault_injector_scripting_and_death_budget():
    fi = FaultInjector(seed=0, death_budget=1)   # all rates 0
    fi.at("remote:1", 0, "error").at("remote:1", 2, "die")
    fi.at("remote:1", 3, "hang")
    assert fi.decide("remote:1").kind == "error"
    assert fi.decide("remote:1") is None         # unscripted, rates 0
    assert fi.decide("remote:1").kind == "die"   # consumes the budget
    assert fi.decide("remote:1") is None         # hang suppressed
    assert fi.stats()["suppressed_deaths"] == 1
    assert fi.stats()["death_budget_left"] == 0


def test_fault_injector_validates_rates():
    with pytest.raises(ValueError):
        FaultInjector(error_rate=1.5)
    with pytest.raises(ValueError):
        FaultInjector(error_rate=0.6, crash_rate=0.6)
    with pytest.raises(ValueError):
        FaultInjector().at("s", 0, "explode")


# ------------------------------------------------------- breaker units
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_breaker_full_cycle_closed_open_halfopen_closed():
    clock = _Clock()
    b = CircuitBreaker("remote", failure_threshold=0.5, min_samples=3,
                       open_s=1.0, half_open_probes=2, clock=clock)
    assert b.state() == CLOSED and b.routable()
    assert b.penalty() == 1.0
    for _ in range(5):
        b.record_failure()
    assert b.state() == OPEN
    assert not b.routable()
    assert b.stats()["trips"] == 1
    assert b.penalty() > 1.0
    clock.t = 1.5
    assert b.state() == HALF_OPEN
    assert b.routable()
    b.note_probe()
    b.note_probe()
    assert not b.routable()                 # probe slots exhausted
    b.record_success()
    assert b.state() == CLOSED
    assert b.penalty() == 1.0
    assert b.stats()["recoveries"] == 1


def test_breaker_halfopen_failure_reopens():
    clock = _Clock()
    b = CircuitBreaker("remote", min_samples=2, open_s=1.0, clock=clock)
    for _ in range(4):
        b.record_failure()
    clock.t = 1.5
    assert b.state() == HALF_OPEN
    b.record_failure()
    assert b.state() == OPEN
    assert b.stats()["trips"] == 2
    clock.t = 2.0
    assert b.state() == OPEN


def test_native_breaker_never_opens():
    reg = HealthRegistry(["native", "remote"], min_samples=1)
    for _ in range(50):
        reg.record_failure("native")
    assert reg.routable("native")
    assert reg.penalty("native") > 1.0
    assert reg.routable("mystery") and reg.penalty("mystery") == 1.0


# ---------------------------------------------------- router DP health
class _FixedBackend(Backend):
    def __init__(self, name, cost):
        self.name = name
        self._cost = cost
        self.placed = []

    def can_run(self, op):
        return True

    def estimate(self, op, payload_bytes):
        return self._cost

    def queue_depth(self):
        return 0

    def note_placed(self, op):
        self.placed.append(op.name)


def _ops(*names):
    return [make_op(n, {}, where="native") for n in names]


def test_router_health_veto_and_recovery():
    clock = _Clock()
    reg = HealthRegistry([NATIVE, REMOTE], min_samples=3, open_s=1.0,
                         half_open_probes=1, clock=clock)
    router = BackendRouter([_FixedBackend(NATIVE, 1.0),
                            _FixedBackend(REMOTE, 0.1)],
                           handoff_s=0.0, health=reg)
    assert router.route(_ops("a")) == [REMOTE]
    for _ in range(5):
        reg.record_failure(REMOTE)
    assert router.route(_ops("a", "b")) == [NATIVE, NATIVE]
    clock.t = 1.5
    assert router.route(_ops("a")) == [REMOTE]      # the probe placement
    assert router.route(_ops("b")) == [NATIVE]      # probe slot consumed
    reg.record_success(REMOTE)
    assert router.route(_ops("c")) == [REMOTE]      # recovered


def test_router_health_penalty_drains_before_trip():
    reg = HealthRegistry([NATIVE, REMOTE], min_samples=100)
    router = BackendRouter([_FixedBackend(NATIVE, 1.0),
                            _FixedBackend(REMOTE, 0.9)],
                           handoff_s=0.0, health=reg)
    assert router.route(_ops("a")) == [REMOTE]
    for _ in range(10):
        reg.record_failure(REMOTE)
    assert router.route(_ops("a")) == [NATIVE]


def test_router_health_scales_pinned_overrides_too():
    reg = HealthRegistry([NATIVE, REMOTE], min_samples=100)
    router = BackendRouter([_FixedBackend(NATIVE, 1.0),
                            _FixedBackend(REMOTE, 5.0)],
                           overrides={"a": {REMOTE: 0.9}},
                           handoff_s=0.0, health=reg)
    assert router.route(_ops("a")) == [REMOTE]
    for _ in range(10):
        reg.record_failure(REMOTE)
    assert router.route(_ops("a")) == [NATIVE]


# ----------------------------------------------------- pool retry units
def _drive(pool, ents, timeout=10.0):
    """Dispatch entities and pump replies through handle_response until
    every one resolves; returns {eid: (status, payload)}."""
    reply: queue.Queue = queue.Queue()
    op = ents[0].ops[0]
    for e in ents:
        pool.dispatch(e, op, reply)
    out = {}
    deadline = time.monotonic() + timeout
    while len(out) < len(ents) and time.monotonic() < deadline:
        due = pool.next_retry_due()
        if due is not None and due <= time.monotonic():
            pool.flush_due_retries()
        try:
            tag, req, payload = reply.get(timeout=0.05)
        except queue.Empty:
            continue
        status, result = pool.handle_response(tag, req, payload)
        if status in ("done", "failed"):
            out[req.entity.eid] = (status, result)
    return out


def _ents(n, op_name="grayscale"):
    op = make_op(op_name)
    return [Entity(str(i), "image", torch.zeros(4, 4, 3), ops=[op])
            for i in range(n)]


def test_retry_goes_to_a_different_server():
    fi = FaultInjector(seed=0).at("remote:0", 0, "error")
    pool = RemoteServerPool(2, _transport(), fault_injector=fi)
    try:
        out = _drive(pool, _ents(1))
        assert out["0"][0] == "done"
        assert pool.retried == 1
        assert pool.servers[1].processed == 1
        assert pool.servers[0].processed == 0
    finally:
        pool.shutdown()


def test_pick_excludes_failed_server_unless_last_alive():
    pool = RemoteServerPool(3, _transport())
    try:
        for _ in range(6):
            assert pool._pick(exclude=1).sid != 1
        pool.kill_server(0)
        pool.kill_server(2)
        assert pool._pick(exclude=1).sid == 1    # only live: no choice
        pool.kill_server(1)
        with pytest.raises(NoLiveServersError):
            pool._pick()
    finally:
        pool.shutdown()


def test_backoff_delays_retry_through_the_heap():
    fi = FaultInjector(seed=0).at("remote:0", 0, "error")
    pool = RemoteServerPool(1, _transport(), fault_injector=fi,
                            retry_backoff_base_s=0.02,
                            retry_backoff_max_s=0.02)
    try:
        (e,) = _ents(1)
        reply: queue.Queue = queue.Queue()
        pool.dispatch(e, e.ops[0], reply)
        tag, req, payload = reply.get(timeout=5)
        assert tag == "error" and isinstance(payload, TransientError)
        status, _ = pool.handle_response(tag, req, payload)
        assert status == "requeued"
        assert pool.retries_delayed == 1
        due = pool.next_retry_due()
        assert due is not None and due <= time.monotonic() + 0.02
        pool.flush_due_retries()                 # too early: no resubmit
        time.sleep(max(0.0, due - time.monotonic()) + 0.005)
        pool.flush_due_retries()
        tag, req, payload = reply.get(timeout=5)
        assert pool.handle_response(tag, req, payload)[0] == "done"
    finally:
        pool.shutdown()


def test_retry_never_outlives_the_deadline():
    fi = FaultInjector(seed=0).at("remote:0", 0, "error")
    pool = RemoteServerPool(1, _transport(), fault_injector=fi)
    try:
        (e,) = _ents(1)
        e.deadline = time.monotonic() - 1.0      # budget already spent
        status, payload = _drive(pool, [e])["0"]
        assert status == "failed"
        assert isinstance(payload, DeadlineExceeded)
        assert pool.deadline_exhausted == 1
        assert pool.retried == 0
    finally:
        pool.shutdown()


def test_permanent_error_skips_retries():
    pool = RemoteServerPool(2, _transport())
    try:
        (e,) = _ents(1)
        reply: queue.Queue = queue.Queue()
        pool.dispatch(e, e.ops[0], reply)
        _, req, _ = reply.get(timeout=5)         # real (ok) reply
        status, payload = pool.handle_response(
            "error", req, PermanentError("malformed op"))
        assert status == "failed"
        assert isinstance(payload, PermanentError)
        assert pool.retried == 0
    finally:
        pool.shutdown()


def test_reissue_rechecks_inflight_after_concurrent_cancel():
    pool = RemoteServerPool(
        2, TransportModel(network_latency_s=0.0, service_time_s=0.2))
    try:
        op = make_op("grayscale")
        a = Entity("a", "image", torch.zeros(4, 4, 3), ops=[op],
                   query_id="qA")
        b = Entity("b", "image", torch.zeros(4, 4, 3), ops=[op],
                   query_id="qB")
        reply: queue.Queue = queue.Queue()
        pool.dispatch(a, op, reply)
        pool.dispatch(b, op, reply)
        pool._lat_samples = 100                  # warmed estimate
        pool._lat_est = 1e-4
        pool.straggler_factor = 1e-6             # everything looks slow
        time.sleep(0.01)
        orig_pick = pool._pick
        raced = []

        def racing_pick(exclude=None):
            if not raced:                        # during A's reissue...
                raced.append(1)
                pool.drop_query("qB")            # ...B gets cancelled
            return orig_pick(exclude)

        pool._pick = racing_pick
        pool.reissue_stragglers()
        assert pool.reissued == 1                # A only; B skipped
        assert pool.cancelled_dropped == 1
    finally:
        pool.shutdown()


# --------------------------------------- server death, every backend path
def test_kill_server_mid_query_remote_path():
    eng = port_engine(transport=dict(network_latency_s=0.002,
                                     service_time_s=0.02))
    try:
        _add(eng, n=8)
        fut = eng.submit(_find())
        time.sleep(0.03)                         # mid-flight
        eng.pool.kill_server(0)
        res = fut.result(timeout=60)
        assert res["stats"]["failed"] == 0
        assert len(res["entities"]) == 8
    finally:
        eng.shutdown()


def test_kill_server_mid_query_coalesced_batch_path():
    eng = port_engine(num_remote_servers=3,
                      transport=dict(network_latency_s=0.002,
                                     service_time_s=0.02),
                      coalesce_window_ms=20.0, coalesce_max_batch=4)
    try:
        _add(eng, n=8)
        fut = eng.submit(_find())
        time.sleep(0.04)
        eng.pool.kill_server(0)
        res = fut.result(timeout=60)
        assert res["stats"]["failed"] == 0
        assert len(res["entities"]) == 8
    finally:
        eng.shutdown()


PIN_BATCHER = {DOUBLE: {"batcher": 1e-9, "native": 10.0, "remote": 10.0}}


@pytest.mark.parametrize("fallback", ["native", "none"])
def test_injected_fault_batcher_path(fallback):
    """``test_injected_fault_batcher_path_falls_back_to_native`` and
    ``..._fails_without_fallback``: one scripted error on the batcher's
    first group; native absorbs it, or the whole group fails."""
    fi = FaultInjector(seed=0).at("backend:batcher", 0, "error")
    eng = port_engine(dispatch="cost", fallback=fallback, fault_injector=fi,
                      batcher_max_wait_ms=20.0, cost_overrides=PIN_BATCHER)
    try:
        _add(eng, n=4)
        res = eng.execute(_find(ops=[
            {"type": "udf", "options": {"id": DOUBLE}}]), timeout=60)
        ds = eng.dispatch_stats()
        if fallback == "native":
            assert res["stats"]["failed"] == 0
            assert ds["batcher"]["errors"] >= 1  # the fault really fired
            assert ds["fallbacks"] >= 1          # and native absorbed it
        else:
            assert res["stats"]["failed"] == 4   # whole group, no rescue
    finally:
        eng.shutdown()


def test_injected_fault_device_path_falls_back_to_native():
    fi = FaultInjector(seed=0).at("backend:device", 0, "error")
    eng = port_engine(dispatch="cost", device_backend="cpu",
                      fallback="native", fault_injector=fi,
                      device_max_wait_ms=20.0,
                      cost_overrides={"blur": {
                          "device": 1e-9, "native": 10.0,
                          "remote": 10.0, "batcher": 10.0}})
    try:
        _add(eng, n=4)
        res = eng.execute(_find(ops=[
            {"type": "blur", "ksize": 3, "sigma_x": 1.0}]), timeout=120)
        assert res["stats"]["failed"] == 0
        ds = eng.dispatch_stats()
        assert ds["device"]["errors"] >= 1
        assert ds["fallbacks"] >= 1
    finally:
        eng.shutdown()


def test_heartbeat_detects_hung_server_and_requeues():
    # a hang is SILENT: only the heartbeat monitor (driven from
    # Thread_3's tick) can find it
    fi = FaultInjector(seed=0, death_budget=1).at("remote:0", 0, "hang")
    eng = port_engine(heartbeat_timeout_s=0.15, fault_injector=fi)
    try:
        _add(eng, n=6)
        res = eng.execute(_find(), timeout=60)
        assert res["stats"]["failed"] == 0
        assert len(res["entities"]) == 6
        pool_stats = eng.dispatch_stats()["pool"]
        assert pool_stats["beat_deaths"] == 1
        assert pool_stats["live"] == 1
    finally:
        eng.shutdown()


@pytest.mark.parametrize("fallback", ["native", "none"])
def test_all_servers_dead(fallback):
    """``test_all_servers_dead_falls_back_to_native`` and
    ``..._fails_without_fallback``."""
    eng = port_engine(fallback=fallback)
    try:
        _add(eng, n=4)
        eng.pool.kill_server(0)
        eng.pool.kill_server(1)
        res = eng.execute(_find(), timeout=60)
        if fallback == "native":
            assert res["stats"]["failed"] == 0   # degraded, not failed
            assert len(res["entities"]) == 4
            assert eng.dispatch_stats()["fallbacks"] >= 4
        else:
            assert res["stats"]["failed"] == 4
    finally:
        eng.shutdown()


# ------------------------------------------------------- engine wiring
def test_fault_knob_validation():
    with pytest.raises(ValueError, match="fallback"):
        port_engine(fallback="bogus")
    with pytest.raises(ValueError, match="max_retries"):
        port_engine(max_retries=0)
    with pytest.raises(ValueError, match="breaker_enabled requires"):
        port_engine(breaker_enabled=True)         # needs dispatch="cost"
    with pytest.raises(ValueError, match="breaker_open_s requires"):
        port_engine(breaker_open_s=1.0)


def test_default_engine_stats_stay_byte_identical():
    # the whole fault-tolerance layer is invisible by default, in both
    # packages: no pool/breaker/fallback blocks in the stats surface
    got = run(port_engine, lambda e: e.dispatch_stats())
    want = run(ref_engine, lambda e: e.dispatch_stats())
    assert got == want == {"mode": "static"}


# --------------------------------------------------------- chaos storms
@pytest.fixture(scope="module")
def fault_free():
    """The storm query's fault-free response, equal to the reference
    engine's byte for byte."""
    def scenario(e):
        _add(e, n=6)
        return e.execute(_find(), timeout=60)
    got = run(lambda: port_engine(num_remote_servers=3), scenario)
    want = run(lambda: ref_engine(num_remote_servers=3), scenario)
    assert_same(got, want)
    return got


@pytest.mark.parametrize("seed", range(10))
def test_seeded_chaos_storm_degrades_never_fails(seed, fault_free):
    fi = FaultInjector(seed=seed, error_rate=0.15, crash_rate=0.05,
                       latency_rate=0.05, latency_s=0.01,
                       die_rate=0.01, death_budget=1)
    eng = port_engine(num_remote_servers=3,
                      admission="queue", max_inflight_entities=8,
                      max_retries=4,
                      retry_backoff_base_s=0.002, retry_backoff_max_s=0.02,
                      heartbeat_timeout_s=0.2,
                      fallback="native", fault_injector=fi)
    try:
        _add(eng, n=6)
        futs = [eng.submit(_find()) for _ in range(5)]
        for fut in futs:
            res = fut.result(timeout=120)
            assert res["stats"]["failed"] == 0   # faults degrade, never fail
            assert len(res["entities"]) == 6
            assert_same(res, fault_free)         # ... and change no byte
        adm = eng.admission_stats()
        assert adm["inflight"] == 0
        assert adm["pending"] == 0
        assert adm["peak_inflight"] <= 8
    finally:
        eng.shutdown()
