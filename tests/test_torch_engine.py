"""The PyTorch port's query engine held against the JAX package's, end
to end on the CPU (``device="cpu"``, ``device_backend="cpu"``).

Both engines hold the same data: the port's engine ingests the JAX
engine's state through ``repro_torch.interop`` (same eids, same blobs),
so one query must give the same response.

Tolerances: the static-hash workload is bit-exact (its sha256 is
recorded in ``benchmarks/dispatch_static_baseline.json``); pipelines
with arithmetic (resize, normalize, blur, face detection) are compared
with an absolute tolerance of 1e-5 on float32 values of magnitude <= 3.
"""
import hashlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.engine import VDMSAsyncEngine as JaxEngine
from repro.core.remote import TransportModel as JaxTransport
from repro_torch.core.engine import VDMSAsyncEngine
from repro_torch.core.remote import TransportModel
from repro_torch.core.result_cache import ResultCache
from repro_torch.interop import engine_state, ingest_reference_state

torch.set_num_threads(1)

TOL = 1e-5
BASELINE = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "dispatch_static_baseline.json")

STATIC_PIPE = [
    {"type": "crop", "x": 4, "y": 4, "width": 24, "height": 24},
    {"type": "remote", "url": "http://svc/flip", "options": {"id": "flip"}},
    {"type": "rotate", "k": 1},
    {"type": "threshold", "value": 0.5},
]
# benchmarks/dispatch_bench.py: run_device and run_device_fused
DEVICE_PIPES = {
    "run_device": [
        {"type": "resize", "width": 64, "height": 64},
        {"type": "blur", "ksize": 9, "sigma_x": 2.0},
    ],
    "run_device_fused": [
        {"type": "resize", "width": 64, "height": 64},
        {"type": "crop", "x": 8, "y": 8, "width": 48, "height": 48},
        {"type": "normalize", "mean": 0.45, "std": 0.22},
        {"type": "blur", "ksize": 9, "sigma_x": 2.0},
    ],
}
# benchmarks/common.py: image_c2_pipeline
C2_PIPE = [
    {"type": "resize", "width": 48, "height": 48},
    {"type": "remote", "url": "u", "options": {"id": "facedetect_box"}},
    {"type": "remote", "url": "u", "options": {"id": "manipulation"}},
    {"type": "rotate", "k": 1},
]
PINNED = {op: {"device": 1e-6, "native": 10.0, "remote": 10.0,
               "batcher": 10.0}
          for op in ("resize", "crop", "normalize", "blur")}


def _find(ops, category="dsp"):
    return [{"FindImage": {"constraints": {"category": ["==", category]},
                           "operations": ops}}]


def _fill(eng, n, size, category="dsp"):
    """``benchmarks/dispatch_bench.py::_fill``."""
    rng = np.random.default_rng(11)
    for i in range(n):
        img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        eng.add_entity("image", img, {"category": category, "idx": i})


def _digest(entities) -> str:
    h = hashlib.sha256()
    for eid in entities:
        arr = np.ascontiguousarray(np.asarray(entities[eid]))
        h.update(eid.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _assert_close(got: dict, want: dict):
    assert list(got) == list(want)
    for eid in want:
        g, w = got[eid], np.asarray(want[eid])
        assert isinstance(g, np.ndarray)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


def _transport(cls):
    return cls(network_latency_s=0.001, service_time_s=0.0005)


@pytest.mark.parametrize("fuse_native", [False, True])
def test_static_hash_matches_recorded_baseline(fuse_native):
    with open(BASELINE) as f:
        recorded = json.load(f)["sha256"]
    eng = VDMSAsyncEngine(device="cpu", num_remote_servers=2,
                          fuse_native=fuse_native,
                          transport=_transport(TransportModel))
    try:
        _fill(eng, 8, 32)
        res = eng.execute(_find(STATIC_PIPE), timeout=120)
    finally:
        eng.shutdown()
    assert res["stats"]["failed"] == 0
    assert _digest(res["entities"]) == recorded


@pytest.fixture(scope="module")
def jax_device_engine():
    """A JAX engine routing every op of DEVICE_PIPES to its device
    backend, holding 8 seeded 72x72 images; yields (engine, responses)."""
    eng = JaxEngine(num_remote_servers=1, transport=_transport(JaxTransport),
                    num_native_workers=2, dispatch="cost",
                    device_backend=True, device_batch_size=8,
                    device_max_wait_ms=20.0, cost_overrides=PINNED)
    try:
        _fill(eng, 8, 72)
        responses = {name: eng.execute(_find(pipe), timeout=300)
                     for name, pipe in DEVICE_PIPES.items()}
        yield eng, responses
    finally:
        eng.shutdown()


@pytest.mark.parametrize("name", sorted(DEVICE_PIPES))
@pytest.mark.parametrize("fuse", [True, False])
def test_device_backend_pipelines_match_jax(jax_device_engine, name, fuse):
    jax_eng, responses = jax_device_engine
    eng = VDMSAsyncEngine(device="cpu", num_remote_servers=1,
                          transport=_transport(TransportModel),
                          num_native_workers=2, dispatch="cost",
                          device_backend="cpu", device_fuse_segments=fuse,
                          device_batch_size=8, device_max_wait_ms=20.0,
                          cost_overrides=PINNED)
    try:
        eids = ingest_reference_state(eng, engine_state(jax_eng))
        assert eids == sorted(jax_eng.meta.find("image"))
        res = eng.execute(_find(DEVICE_PIPES[name]), timeout=300)
        stats = eng.dispatch_stats()
    finally:
        eng.shutdown()
    assert res["stats"]["failed"] == 0
    _assert_close(res["entities"], responses[name]["entities"])
    n_ops = len(DEVICE_PIPES[name])
    assert stats["placements"]["device"] == 8 * n_ops
    dev = stats["device"]
    assert dev["platform"] == "cpu" and dev["errors"] == 0
    assert dev["ops_run"] == 8 * n_ops
    assert (dev["fused_segments"] > 0) == fuse


def test_c2_pipeline_matches_jax():
    jax_eng = JaxEngine(num_remote_servers=2,
                        transport=_transport(JaxTransport))
    try:
        _fill(jax_eng, 6, 64)
        from repro.dataio.synthetic import synthetic_faces
        for i, img in enumerate(synthetic_faces(4, 64, seed=9)):
            jax_eng.add_entity("image", img, {"category": "dsp", "idx": 100 + i})
        want = jax_eng.execute(_find(C2_PIPE), timeout=300)
        state = list(engine_state(jax_eng))
    finally:
        jax_eng.shutdown()
    eng = VDMSAsyncEngine(device="cpu", num_remote_servers=2,
                          transport=_transport(TransportModel))
    try:
        ingest_reference_state(eng, state)
        got = eng.execute(_find(C2_PIPE), timeout=300)
    finally:
        eng.shutdown()
    assert got["stats"]["failed"] == want["stats"]["failed"] == 0
    _assert_close(got["entities"], want["entities"])


def test_cached_results_stay_private():
    eng = VDMSAsyncEngine(device="cpu", cache_capacity=16,
                          transport=_transport(TransportModel))
    try:
        _fill(eng, 3, 24)
        query = _find([{"type": "resize", "width": 16, "height": 16},
                       {"type": "rotate", "k": 1}])
        first = eng.execute(query, timeout=60)
        snapshot = {k: v.copy() for k, v in first["entities"].items()}
        for v in first["entities"].values():
            v[...] = -1.0          # a client scribbling on its response
        warm = eng.execute(query, timeout=60)
        assert warm["stats"]["cache_full_hits"] == 3
        for k, v in warm["entities"].items():
            np.testing.assert_array_equal(v, snapshot[k])
    finally:
        eng.shutdown()
    # the cache itself hands out clones of tensors, never its own
    cache = ResultCache(capacity=4)
    t = torch.ones(2, 2)
    cache.put("e", "s", t)
    t.zero_()
    hit, got = cache.get("e", "s")
    assert hit and torch.equal(got, torch.ones(2, 2))
    got.zero_()
    k, again = cache.longest_cached_prefix("e", ["s"])
    assert k == 1 and torch.equal(again, torch.ones(2, 2))


def test_add_with_operations_writes_host_array_back():
    eng = VDMSAsyncEngine(device="cpu")
    try:
        img = np.random.default_rng(1).uniform(0, 1, (10, 12, 3)).astype(np.float32)
        eng.execute([{"AddImage": {"properties": {"category": "a"},
                                   "operations": [{"type": "flip"}],
                                   "data": img}}], timeout=60)
        (eid,) = eng.meta.find_ids("image")
        stored = eng.store.get(eid)
        assert isinstance(stored, np.ndarray)
        np.testing.assert_array_equal(stored, img[:, ::-1])
        # a strided host view (negative strides) crosses in at launch
        eng.add_entity("image", img[::-1, ::2], {"category": "b"})
        res = eng.execute(_find([{"type": "rotate", "k": 1}], "b"),
                          timeout=60)
        (got,) = res["entities"].values()
        np.testing.assert_array_equal(got, np.rot90(img[::-1, ::2]))
    finally:
        eng.shutdown()


def test_no_thread_leaks_after_shutdown():
    before = set(threading.enumerate())
    eng = VDMSAsyncEngine(device="cpu", num_remote_servers=2,
                          transport=_transport(TransportModel),
                          num_native_workers=3, dispatch="cost",
                          device_backend="cpu", cost_overrides=PINNED)
    _fill(eng, 4, 32)
    eng.execute(_find(DEVICE_PIPES["run_device_fused"] + STATIC_PIPE[1:]),
                timeout=120)
    assert len(set(threading.enumerate()) - before) >= 6
    eng.shutdown()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        leaked = [t for t in set(threading.enumerate()) - before
                  if t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, leaked
