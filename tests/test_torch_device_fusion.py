"""The port's device-resident segment fusion held against
``tests/test_device_fusion.py``: fused, per-op and native results equal,
prefix resume at a segment boundary, the residency-priced router, the
bounded program cache (``_jit_cache``), padding-waste accounting,
several device workers, and the fused preprocess chain that
``DEVICE_BATCH_PATHS`` sends to K2 (and ``blur`` to K1; their plain
versions on the CPU).  Engine responses are also compared with the JAX
package's engine: byte for byte on ``EXACT_PIPE``, within ``TOL`` on the
float chain ``PREPROCESS_PIPE``."""
import queue
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.entity import Entity
from repro_torch.core.pipeline import make_op
from repro_torch.core.result_cache import op_signature
from repro_torch.kernels import ops as kops
from repro_torch.query.device_backend import (DeviceBackend, DeviceCostModel,
                                              MultiDeviceBackend)
from repro_torch.query.dispatch import Backend, BackendRouter, OpCostTracker
from repro_torch.visual.ops import crop, normalize, resize
from torch_parity import (TOL, add_images, assert_same, find, port_engine,
                          ref_engine, run, wait)

torch.set_num_threads(1)
CPU = torch.device("cpu")

# index/comparison ops only: bit-exact under any execution strategy
EXACT_PIPE = [
    {"type": "crop", "x": 2, "y": 2, "width": 16, "height": 16},
    {"type": "rotate", "k": 1},
    {"type": "flip", "axis": "horizontal"},
    {"type": "threshold", "value": 0.5},
]

# the fused-preprocessing prefix + a float tail: compares allclose
PREPROCESS_PIPE = [
    {"type": "resize", "width": 20, "height": 24},
    {"type": "crop", "x": 2, "y": 3, "width": 12, "height": 10},
    {"type": "normalize", "mean": 0.4, "std": 0.25},
    {"type": "blur", "ksize": 3, "sigma_x": 1.0},
]


def _pin(pipe):
    return {o["type"]: {"device": 1e-9, "native": 10.0, "remote": 10.0,
                        "batcher": 10.0} for o in pipe}


ALL_DEVICE = _pin(EXACT_PIPE)
ALL_DEVICE_PRE = _pin(PREPROCESS_PIPE)
DEVICE = dict(dispatch="cost", device_backend="cpu", device_max_wait_ms=50.0)


def _add(eng, n=6, size=24, category="fuse", seed=5):
    """``tests/test_device_fusion.py::_add_images``."""
    return add_images(eng, n, size, category, seed=seed)


def _find(category="fuse", ops=EXACT_PIPE):
    return find(category, ops)


def _query(n=6, size=24, ops=EXACT_PIPE):
    def scenario(e):
        _add(e, n, size)
        return e.execute(_find(ops=ops), timeout=60), e.dispatch_stats()
    return scenario


# --------------------------------------------------- result equivalence
def test_fused_segment_matches_per_op_and_native_byte_identically():
    r_nat, _ = run(port_engine, _query())
    r_per, per = run(lambda: port_engine(device_fuse_segments=False,
                                         cost_overrides=ALL_DEVICE,
                                         **DEVICE), _query())
    r_fus, fus = run(lambda: port_engine(cost_overrides=ALL_DEVICE,
                                         **DEVICE), _query())
    assert r_fus["stats"]["failed"] == 0
    assert_same(r_per, r_nat)
    assert_same(r_fus, r_nat)
    d = fus["device"]
    assert d["entities_run"] == 6          # one reply per entity
    assert d["ops_run"] == 24
    assert d["fused_segments"] >= 1
    # fusion collapses transfers: once per segment, not once per op
    assert d["h2d_bytes"] < per["device"]["h2d_bytes"]
    want, _ = run(lambda: ref_engine(cost_overrides=ALL_DEVICE, **DEVICE),
                  _query())
    assert_same(r_fus, want)


def test_fused_preprocess_chain_matches_native_allclose():
    # resize->crop->normalize takes the chain fast path (K2 on the card,
    # its plain version here), blur the K1 path
    r_nat, _ = run(port_engine, _query(size=32, ops=PREPROCESS_PIPE))
    r_fus, st = run(lambda: port_engine(cost_overrides=ALL_DEVICE_PRE,
                                        **DEVICE),
                    _query(size=32, ops=PREPROCESS_PIPE))
    assert r_fus["stats"]["failed"] == 0
    assert_same(r_fus, r_nat, atol=1e-5)
    assert st["device"]["fused_segments"] >= 1
    want, _ = run(lambda: ref_engine(cost_overrides=ALL_DEVICE_PRE,
                                     **DEVICE),
                  _query(size=32, ops=PREPROCESS_PIPE))
    assert_same(r_fus, want, atol=TOL)


# ------------------------------------------------ segment-grouped inbox
def test_run_groups_partitions_by_segment_and_advances_whole_run():
    replies: queue.Queue = queue.Queue()
    dev = DeviceBackend(calibrate=False, fuse_segments=True, device=CPU)
    dev._reply_to = replies
    ops2 = [make_op("rotate", {"k": 1}),
            make_op("flip", {"axis": "horizontal"})]
    ops1 = [make_op("rotate", {"k": 3})]
    rng = np.random.default_rng(3)

    def img():
        return torch.from_numpy(
            rng.uniform(0, 1, (8, 8, 3)).astype(np.float32))

    ents = []
    for i in range(2):
        e = Entity(eid=f"a{i}", kind="image", data=img(), ops=list(ops2),
                   query_id="q")
        e.route = ["device", "device"]
        ents.append(e)
    lone = Entity(eid="b0", kind="image", data=img(), ops=list(ops1),
                  query_id="q")
    lone.route = ["device"]
    dev._run_groups(ents + [lone])
    got = {}
    for _ in range(3):
        kind, ent, res, err, advance = replies.get(timeout=5)
        assert kind == "device" and err is None
        got[ent.eid] = (res.numpy(), advance)
    for e in ents:
        res, advance = got[e.eid]
        assert advance == 2
        np.testing.assert_array_equal(
            res, np.rot90(e.data.numpy(), k=1)[:, ::-1])
    res, advance = got["b0"]
    assert advance == 1
    np.testing.assert_array_equal(res, np.rot90(lone.data.numpy(), k=3))
    assert dev.groups_run == 2
    assert dev.fused_segments == 1
    assert dev.ops_run == 5


# --------------------------------------------- prefix resume at boundary
def test_prefix_resume_enters_mid_pipeline_device_segment():
    pins = _pin(EXACT_PIPE[2:])
    r_nat, _ = run(port_engine, _query(n=4))
    eng = port_engine(cache_capacity=64, cost_overrides=pins, **DEVICE)
    try:
        _add(eng, n=4)
        r_a = eng.execute(_find(ops=EXACT_PIPE[:2]), timeout=60)
        assert r_a["stats"]["failed"] == 0
        r_b = eng.execute(_find(), timeout=60)
        assert r_b["stats"]["failed"] == 0
        assert r_b["stats"]["cache_prefix_hits"] == 4
        assert eng.dispatch_stats()["device"]["fused_segments"] >= 1
    finally:
        eng.shutdown()
    assert_same(r_b, r_nat)
    want, _ = run(ref_engine, _query(n=4))
    assert_same(r_b, want)


def test_fused_snapshot_lands_at_segment_boundary_only():
    eng = port_engine(cache_capacity=64, cost_overrides=ALL_DEVICE, **DEVICE)
    try:
        _add(eng, n=3)
        eng.execute(_find(), timeout=60)
        entries_after_first = eng.cache_stats()["size"]
        r2 = eng.execute(_find(), timeout=60)
        assert r2["stats"]["cache_full_hits"] == 3
        # one boundary snapshot per entity, not one per op
        assert entries_after_first == 3
    finally:
        eng.shutdown()


# ------------------------------------------------- cancellation drains
def test_cancel_mid_fused_batch_drains_and_releases_admission_slots():
    eng = port_engine(dispatch="cost", device_backend="cpu",
                      cost_overrides=ALL_DEVICE, device_max_wait_ms=100.0,
                      admission="shed", max_inflight_entities=16)
    try:
        _add(eng, n=10)
        fut = eng.submit(_find())
        time.sleep(0.02)          # let entities reach the device inbox
        assert fut.cancel()
        wait(lambda: not (eng.loop.queue1.qsize()
                          or eng.device_backend.pending()
                          or eng.admission_stats()["inflight"]))
        assert eng.device_backend.pending() == 0
        assert eng.admission_stats()["inflight"] == 0   # no leaked slots
        res = eng.execute(_find(), timeout=60)
        assert res["stats"]["matched"] == 10
        assert res["stats"]["failed"] == 0
    finally:
        eng.shutdown()


# --------------------------------------------------- residency-priced DP
class _FixedBackend(Backend):
    def __init__(self, name, cost):
        self.name = name
        self.cost = cost

    def can_run(self, op):
        return True

    def estimate(self, op, payload_bytes):
        return self.cost

    def queue_depth(self):
        return 0


def _warm_device(tracker, ops, *, fuse):
    dev = DeviceBackend(
        calibrate=False, tracker=tracker, batch_size=8, max_wait_s=0.002,
        fuse_segments=fuse, device=CPU,
        cost_model=DeviceCostModel(h2d_bytes_s=1e9, d2h_bytes_s=1e9,
                                   dispatch_latency_s=1e-4,
                                   compile_default_s=0.05))
    for op in ops:
        dev._runs[op_signature(op)] = 500      # first run long amortized
        tracker.observe(op, 1e-4, kind="device")
    return dev


def test_fusion_flips_placement_the_per_op_model_gives_to_native():
    ops = [make_op("rotate", {"k": 1}),
           make_op("flip", {"axis": "horizontal"}),
           make_op("threshold", {"value": 0.5})]
    pb = 8_000_000
    tracker = OpCostTracker()
    router = BackendRouter([_FixedBackend("native", 0.01),
                            _warm_device(tracker, ops, fuse=False)],
                           tracker=tracker)
    assert router.route(ops, payload_bytes=pb) == ["native"] * 3
    tracker2 = OpCostTracker()
    router2 = BackendRouter([_FixedBackend("native", 0.01),
                             _warm_device(tracker2, ops, fuse=True)],
                            tracker=tracker2)
    assert router2.route(ops, payload_bytes=pb) == ["device"] * 3


def test_estimate_resident_is_pure_marginal_compute():
    tracker = OpCostTracker()
    op = make_op("rotate", {"k": 1})
    dev = _warm_device(tracker, [op], fuse=True)
    assert dev.resident_capable
    assert dev.estimate_resident(op, 8_000_000) == pytest.approx(1e-4)
    assert dev.estimate(op, 8_000_000) > dev.estimate_resident(op, 8_000_000)
    assert not _warm_device(OpCostTracker(), [op], fuse=False).resident_capable


# ----------------------------------------------------- bounded program cache
def test_jit_cache_is_lru_bounded_with_eviction_counter():
    dev = DeviceBackend(calibrate=False, jit_cache_cap=2, device=CPU)
    a, b, c = object(), object(), object()
    assert dev._jit_lookup("ka", lambda: a) is a
    assert dev._jit_lookup("kb", lambda: b) is b
    dev._compiled.add(("ka", (4, 8, 8, 3)))
    assert dev._jit_lookup("ka", lambda: object()) is a   # hit, touched
    assert dev._jit_lookup("kc", lambda: c) is c          # evicts kb (LRU)
    assert dev.jit_evictions == 1
    assert set(dev._jit_cache) == {"ka", "kc"}
    assert dev._jit_lookup("ka", lambda: object()) is a   # survived, MRU
    dev._jit_lookup("kd", lambda: object())               # evicts kc
    dev._jit_lookup("ke", lambda: object())               # evicts ka
    assert dev.jit_evictions == 3
    # evicting a key also drops its per-shape first-run marks
    assert not any(ck[0] == "ka" for ck in dev._compiled)
    assert set(dev._jit_cache) == {"kd", "ke"}
    assert dev.stats()["jit_entries"] == 2
    assert dev.stats()["jit_evictions"] == 3


# -------------------------------------------------- padding accounting
def test_padding_waste_accounted_and_singletons_skip_padding():
    dev = DeviceBackend(calibrate=False, device=CPU)
    op = make_op("rotate", {"k": 1})
    rng = np.random.default_rng(7)

    def ent(i):
        return Entity(eid=f"p{i}", kind="image", data=torch.from_numpy(
            rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)),
            ops=[op], query_id="q")

    res, _ = dev._run_native_batch(op, [ent(i) for i in range(3)])
    assert len(res) == 3
    assert dev.stacked_rows == 3 and dev.pad_rows == 1
    assert dev.stats()["padding_waste_frac"] == pytest.approx(0.25)
    res, _ = dev._run_native_batch(op, [ent(9)])
    assert len(res) == 1
    assert dev.stacked_rows == 4 and dev.pad_rows == 1
    assert dev.stats()["padding_waste_frac"] == pytest.approx(0.2)


# -------------------------------------------------------- multi-device
def test_multi_device_engine_spreads_and_aggregates_stats():
    r_nat, _ = run(port_engine, _query(n=8))
    eng = port_engine(num_device_workers=2, cost_overrides=ALL_DEVICE,
                      **DEVICE)
    try:
        assert isinstance(eng.device_backend, MultiDeviceBackend)
        res, stats = _query(n=8)(eng)
    finally:
        eng.shutdown()
    assert res["stats"]["failed"] == 0
    assert_same(res, r_nat)
    d = stats["device"]
    assert len(d["per_device"]) == 2
    assert d["entities_run"] == 8
    assert d["entities_run"] == sum(p["entities_run"] for p in d["per_device"])
    assert d["ops_run"] == 32
    for key in ("groups_run", "compiles", "h2d_bytes", "padding_waste_frac"):
        assert key in d["per_device"][0]
    want, _ = run(lambda: ref_engine(num_device_workers=2,
                                     cost_overrides=ALL_DEVICE, **DEVICE),
                  _query(n=8))
    assert_same(res, want)


def test_multi_device_submit_prefers_least_backlogged_worker():
    replies: queue.Queue = queue.Queue()
    w0 = DeviceBackend(calibrate=False, device=CPU)
    w1 = DeviceBackend(calibrate=False, device=CPU)
    multi = MultiDeviceBackend([w0, w1])
    w0._reply_to = w1._reply_to = replies     # no worker threads
    w0.ledger.add(5.0)                        # w0 heavily backlogged
    op = make_op("rotate", {"k": 1})
    multi.submit(Entity(eid="m0", kind="image", data=torch.zeros(4, 4, 3),
                        ops=[op], query_id="q"))
    assert w1.pending() == 1 and w0.pending() == 0
    assert multi.queue_depth() == 1
    multi.note_placed(op)                     # charges the cheapest worker
    assert w1.ledger.backlog_s() > 0


# ------------------------------------------------------ knob validation
def test_fusion_and_worker_knobs_require_device_backend():
    before = threading.active_count()
    with pytest.raises(ValueError, match="device_fuse_segments"):
        port_engine(dispatch="cost", device_fuse_segments=True)
    with pytest.raises(ValueError, match="device_fuse_segments"):
        port_engine(device_fuse_segments=False)
    with pytest.raises(ValueError, match="num_device_workers"):
        port_engine(dispatch="cost", num_device_workers=2)
    with pytest.raises(ValueError, match="num_device_workers"):
        port_engine(dispatch="cost", device_backend="cpu",
                    num_device_workers=0)
    assert threading.active_count() == before


# ----------------------------------------------- fused preprocess chain
PRE_KW = dict(resize_h=24, resize_w=20, crop_x=2, crop_y=3,
              crop_w=12, crop_h=10, mean=0.4, std=0.25)


def _ref_fused(img, **kw):
    from repro.kernels.ops import fused_preprocess
    return np.asarray(fused_preprocess(img, impl="ref", **kw))


def test_fused_preprocess_ref_is_exactly_the_composed_ops():
    img = np.random.default_rng(0).uniform(0, 1, (3, 32, 28, 3)).astype(
        np.float32)
    fused = kops.fused_preprocess(torch.from_numpy(img), **PRE_KW).numpy()

    def one(im):
        im = resize(im, width=20, height=24)
        im = crop(im, x=2, y=3, width=12, height=10)
        return normalize(im, mean=0.4, std=0.25)

    composed = torch.stack([one(torch.from_numpy(im)) for im in img])
    np.testing.assert_array_equal(fused, composed.numpy())
    np.testing.assert_allclose(fused, _ref_fused(img, **PRE_KW),
                               atol=TOL, rtol=0)


def test_fused_preprocess_clamps_out_of_range_crop_as_the_reference():
    # the reference's test_fused_preprocess_pallas_matches_ref_in_
    # interpret_mode; the port's plain version against the Pallas kernel
    # in interpret mode is test_torch_kernels.py::
    # test_fused_preprocess_plain_matches_pallas (a clamped crop too)
    img = np.random.default_rng(1).uniform(0, 1, (2, 32, 28, 3)).astype(
        np.float32)
    for kw in (PRE_KW, dict(PRE_KW, crop_x=18, crop_w=12)):  # x+w > width
        got = kops.fused_preprocess(torch.from_numpy(img), **kw).numpy()
        want = _ref_fused(img, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
