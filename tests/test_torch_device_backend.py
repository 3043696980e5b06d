"""The port's device backend held against ``tests/test_device_backend.py``:
placement only when the transfer- and compile-amortized estimate wins,
forced device regimes, micro-batch limits, the device-UDF result-count
contract, video fallback, cancellation drains, the cost-model units and
the device-off engine's byte identity with static dispatch.  Every
engine response is also compared with the JAX package's engine on the
same data, byte for byte (``EXACT_PIPE`` holds index and comparison ops
only), and the router's placement counts with the reference's.

On the CPU the backend runs with ``device_backend="cpu"``; on the card
the same scenarios run in ``tests/test_torch_cuda.py`` and phase 20 of
``chip_smoke.py``.  Eager PyTorch builds no program per shape: the
"compile" term (``DeviceCostModel.observe_compile``) is the EWMA of
first-run walls of a (segment, batch shape), which on the card holds the
kernel build and lazy CUDA set-up."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.pipeline import make_op
from repro_torch.core.result_cache import op_signature
from repro_torch.core.udf import (register_device_udf, register_udf,
                                  unregister_udf)
from repro_torch.query.device_backend import DeviceBackend, DeviceCostModel
from repro_torch.query.dispatch import Backend, BackendRouter, OpCostTracker
from torch_parity import (add_images, assert_same, find, port_engine,
                          ref_engine, run, wait)

torch.set_num_threads(1)

# index-permutation and comparison ops: bit-exact under any execution
# strategy, so responses compare byte for byte across backends and
# across the two packages
EXACT_PIPE = [
    {"type": "crop", "x": 2, "y": 2, "width": 16, "height": 16},
    {"type": "rotate", "k": 1},
    {"type": "flip", "axis": "horizontal"},
    {"type": "threshold", "value": 0.5},
]

# pin the rotate op onto the device; everything else stays native
DEVICE_PIN = {
    "rotate": {"device": 1e-9, "native": 10.0, "remote": 10.0,
               "batcher": 10.0},
}


def _add(eng, n=6, size=24, category="dev"):
    """``tests/test_device_backend.py::_add_images``."""
    return add_images(eng, n, size, category, seed=5)


def _find(category="dev", ops=EXACT_PIPE, kind="FindImage"):
    return find(category, ops, kind)


def _both(scenario, **kw):
    """``scenario(engine)`` on a port and a reference engine with the
    same knobs (``device_backend="cpu"`` in both, where asked)."""
    return (run(lambda: port_engine(**kw), scenario),
            run(lambda: ref_engine(**kw), scenario))


def _query(n=6, ops=EXACT_PIPE):
    def scenario(e):
        _add(e, n)
        return e.execute(_find(ops=ops), timeout=60), e.dispatch_stats()
    return scenario


# ------------------------------------------------------ knob validation
def test_device_backend_requires_cost_dispatch():
    before = threading.active_count()
    with pytest.raises(ValueError, match="device_backend"):
        port_engine(device_backend="cpu")                  # static default
    with pytest.raises(ValueError, match="device_backend"):
        port_engine(dispatch="native", device_backend="cpu")
    assert threading.active_count() == before


def test_device_override_rejected_without_device_backend():
    before = threading.active_count()
    with pytest.raises(ValueError, match="device"):
        port_engine(dispatch="cost", cost_overrides=DEVICE_PIN)
    assert threading.active_count() == before


def test_device_off_cost_engine_matches_static():
    r_sta, _ = run(port_engine, _query())
    eng_cost = port_engine(dispatch="cost")
    try:
        assert eng_cost.device_backend is None
        assert "device" not in eng_cost.router.placements
        r_cost, stats = _query()(eng_cost)
        assert "device" not in stats
    finally:
        eng_cost.shutdown()
    assert_same(r_cost, r_sta)
    want, _ = run(ref_engine, _query())
    assert_same(r_sta, want)


# ------------------------------------------------- forced device regime
def test_forced_device_regime_routes_and_matches_static():
    # fusion is the default: once the pinned rotate enters the device,
    # residency pricing keeps flip and threshold there too, so the
    # segment is rotate-onward, 3 of the 4 ops per entity
    r_sta, _ = run(port_engine, _query())
    (r_dev, stats), (want, want_stats) = _both(
        _query(), dispatch="cost", device_backend="cpu",
        cost_overrides=DEVICE_PIN, device_max_wait_ms=50.0)
    assert r_dev["stats"]["failed"] == 0
    assert_same(r_dev, r_sta)
    assert_same(r_dev, want)
    assert stats["placements"]["device"] == 18   # rotate+flip+threshold
    assert stats["placements"] == want_stats["placements"]
    d = stats["device"]
    assert d["entities_run"] == 6
    assert d["ops_run"] == 18
    assert d["fused_segments"] >= 1
    assert d["groups_run"] >= 1
    assert d["pending"] == 0
    assert d["compiles"] >= 1
    assert d["h2d_bytes"] > 0 and d["d2h_bytes"] > 0
    assert d["platform"] == want_stats["device"]["platform"] == "cpu"


def test_fusion_off_reproduces_per_op_placement_and_results():
    # device_fuse_segments=False prices every device op cold, so only
    # the pinned rotate lands there, each op its own device group
    r_sta, _ = run(port_engine, _query())
    (r_dev, stats), (want, want_stats) = _both(
        _query(), dispatch="cost", device_backend="cpu",
        device_fuse_segments=False, cost_overrides=DEVICE_PIN,
        device_max_wait_ms=50.0)
    assert r_dev["stats"]["failed"] == 0
    assert_same(r_dev, r_sta)
    assert_same(r_dev, want)
    assert stats["placements"]["device"] == 6    # rotate, per entity
    assert stats["placements"] == want_stats["placements"]
    d = stats["device"]
    assert d["entities_run"] == 6
    assert d["ops_run"] == 6
    assert d["fused_segments"] == 0


def test_device_microbatches_respect_batch_size():
    eng = port_engine(dispatch="cost", device_backend="cpu",
                      device_batch_size=4, device_max_wait_ms=200.0,
                      cost_overrides=DEVICE_PIN)
    try:
        _add(eng, n=8)
        res = eng.execute(_find(ops=[{"type": "rotate", "k": 1}]),
                          timeout=60)
        assert res["stats"]["failed"] == 0
        d = eng.dispatch_stats()["device"]
        assert d["entities_run"] == 8
        assert d["groups_run"] >= 2       # 8 entities, groups capped at 4
    finally:
        eng.shutdown()


def test_device_udf_result_count_contract():
    register_udf("t_dev_short", lambda img: img)
    register_device_udf("t_dev_short", lambda imgs: [])     # always short
    eng = port_engine(dispatch="cost", device_backend="cpu",
                      device_max_wait_ms=100.0,
                      cost_overrides={"t_dev_short": {"device": 1e-9,
                                                      "native": 10.0,
                                                      "remote": 10.0}})
    try:
        _add(eng, n=4)
        res = eng.execute(_find(ops=[
            {"type": "udf", "options": {"id": "t_dev_short"}}]), timeout=30)
        assert res["stats"]["failed"] == 4
        assert eng.dispatch_stats()["device"]["errors"] >= 1
    finally:
        eng.shutdown()
        unregister_udf("t_dev_short")


def test_video_entities_fall_back_without_failing():
    # (T,H,W,C) payloads take the host path inside the device worker;
    # results match the static engine, and the reference's, exactly
    clip = np.random.default_rng(9).uniform(0, 1, (3, 16, 16, 3)).astype(
        np.float32)
    q = _find("vid", ops=[{"type": "rotate", "k": 1}], kind="FindVideo")

    def scenario(e):
        e.add_entity("video", clip.copy(), {"category": "vid"})
        return e.execute(q, timeout=60), e.dispatch_stats()

    r_sta, _ = run(port_engine, scenario)
    (r_dev, stats), (want, _) = _both(
        scenario, dispatch="cost", device_backend="cpu",
        cost_overrides=DEVICE_PIN, device_max_wait_ms=50.0)
    assert r_dev["stats"]["failed"] == 0
    assert_same(r_dev, r_sta)
    assert_same(r_dev, want)
    assert stats["device"]["entities_run"] == 1


# -------------------------------------------- cancellation drains clean
def test_cancel_drains_inflight_device_microbatches():
    eng = port_engine(dispatch="cost", device_backend="cpu",
                      device_max_wait_ms=100.0, cost_overrides=DEVICE_PIN)
    try:
        _add(eng, n=10)
        fut = eng.submit(_find())
        time.sleep(0.02)          # let some entities reach the device
        assert fut.cancel()
        wait(lambda: not (eng.pool.inflight or eng.loop.queue1.qsize()
                          or eng.device_backend.pending()))
        assert not eng.pool.inflight
        assert eng.loop.queue1.qsize() == 0
        assert eng.device_backend.pending() == 0
        assert eng.active_sessions() == 0
        res = eng.execute(_find(), timeout=60)
        assert res["stats"]["matched"] == 10
        assert res["stats"]["failed"] == 0
    finally:
        eng.shutdown()


# --------------------------------------------------- cost-model units
class _FixedBackend(Backend):
    def __init__(self, name, cost):
        self.name = name
        self.cost = cost
        self.placed = []

    def can_run(self, op):
        return True

    def estimate(self, op, payload_bytes):
        return self.cost

    def queue_depth(self):
        return 0

    def note_placed(self, op):
        self.placed.append(op.name)


def _unbound_device(**kw):
    """A DeviceBackend used purely as a cost model (never bound, no
    worker thread) with a deterministic, uncalibrated transfer model."""
    kw.setdefault("cost_model", DeviceCostModel(
        h2d_bytes_s=1e9, d2h_bytes_s=1e9, dispatch_latency_s=1e-4,
        compile_default_s=0.05))
    kw.setdefault("batch_size", 8)
    kw.setdefault("max_wait_s", 0.002)
    return DeviceBackend(calibrate=False, device=torch.device("cpu"), **kw)


def test_compile_amortization_decays_with_runs():
    dev = _unbound_device(tracker=OpCostTracker())
    op = make_op("blur", {"ksize": 5})
    cold = dev.estimate(op, payload_bytes=1000)
    dev._runs[op_signature(op)] = 9          # ten runs in: 0.05 -> 0.005
    warm = dev.estimate(op, payload_bytes=1000)
    assert cold - warm == pytest.approx(0.05 - 0.005, rel=1e-6)
    # the term's magnitude is the first-run wall once one was observed
    dev.cost_model.observe_compile(0.2)
    assert dev.cost_model.compile_s() == 0.2
    assert dev.estimate(op, 1000) - warm == pytest.approx(0.02 - 0.005,
                                                          rel=1e-6)


def test_transfer_term_scales_with_payload():
    dev = _unbound_device()
    op = make_op("blur", {"ksize": 5})
    small = dev.estimate(op, payload_bytes=1_000)
    large = dev.estimate(op, payload_bytes=100_000_000)   # 100 MB
    # 100 MB over 1 GB/s both ways = 0.2 s of pure transfer
    assert large - small == pytest.approx(0.2, rel=1e-2)


def test_router_places_device_only_when_amortized_estimate_wins():
    tracker = OpCostTracker()
    dev = _unbound_device(tracker=tracker)
    router = BackendRouter([_FixedBackend("native", 0.05), dev],
                           tracker=tracker)
    op = make_op("blur", {"ksize": 5})
    # cold device: the full 50 ms compile surcharge makes device lose
    assert router.route([op], payload_bytes=1000) == ["native"]
    # steady state: compile amortized away, device EWMA fast
    dev._runs[op_signature(op)] = 500
    tracker.observe(op, 1e-4, kind="device")
    assert router.route([op], payload_bytes=1000) == ["device"]
    # a huge payload makes the transfer term dominate
    assert router.route([op], payload_bytes=500_000_000) == ["native"]


def test_device_prior_amortizes_native_estimate_over_batch():
    tracker = OpCostTracker()
    dev = _unbound_device(tracker=tracker, batch_size=8)
    op = make_op("blur", {"ksize": 5})
    tracker.observe(op, 0.8, kind="native")
    assert dev.estimate(op, payload_bytes=0) == pytest.approx(
        0.002 / 2          # wait/2
        + 1e-4 / 8         # dispatch latency amortized over the batch
        + 0.8 / 8          # native estimate / batch_size prior
        + 0.05,            # cold compile surcharge
        rel=1e-3)


def test_can_run_native_table_and_device_udfs_only():
    dev = _unbound_device()
    assert dev.can_run(make_op("rotate", {"k": 1}))          # native table
    assert not dev.can_run(make_op("facedetect_box", {}, where="remote"))
    register_device_udf("t_dev_canrun", lambda imgs: list(imgs))
    try:
        assert dev.can_run(make_op("t_dev_canrun", {}, where="udf"))
    finally:
        unregister_udf("t_dev_canrun")


def test_bad_platform_string_fails_before_any_thread_spawns():
    before = threading.active_count()
    with pytest.raises(RuntimeError):
        port_engine(dispatch="cost", device_backend="no_such_platform")
    assert threading.active_count() == before


def test_explicit_cpu_platform_string_resolves():
    eng = port_engine(dispatch="cost", device_backend="cpu",
                      cost_overrides=DEVICE_PIN)
    try:
        assert eng.device_backend.device.type == "cpu"
        assert eng.dispatch_stats()["device"]["platform"] == "cpu"
        _add(eng, n=2)
        res = eng.execute(_find(), timeout=60)
        assert res["stats"]["failed"] == 0
    finally:
        eng.shutdown()


def test_device_override_rejected_under_native_dispatch_too():
    before = threading.active_count()
    with pytest.raises(ValueError, match="device"):
        port_engine(dispatch="native", cost_overrides=DEVICE_PIN)
    assert threading.active_count() == before


def test_first_device_run_does_not_poison_the_device_ewma():
    # the first run of an op on the device is first-run-contaminated and
    # must NOT seed the kind="device" EWMA; it feeds the compile term
    eng = port_engine(dispatch="cost", device_backend="cpu",
                      device_max_wait_ms=50.0, cost_overrides=DEVICE_PIN)
    try:
        _add(eng, n=4)
        ops = [{"type": "rotate", "k": 1}]
        eng.execute(_find(ops=ops), timeout=60)       # first run
        op = make_op("rotate", {"k": 1})
        assert not eng.cost_tracker.known(op, kind="device")
        dev = eng.device_backend
        compiles = dev.compiles
        assert compiles >= 1 and dev.cost_model._compile_est is not None
        eng.execute(_find(ops=ops), timeout=60)       # warm run: observed
        assert eng.cost_tracker.known(op, kind="device")
        assert eng.cost_tracker.estimate(op, kind="device") \
            < dev.cost_model.compile_s()
    finally:
        eng.shutdown()
