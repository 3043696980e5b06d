"""The host boundary's way out (``repro_torch.core.boundary``) on the
CPU: ``to_host_many`` held against the per-entity ``to_host``, and an
engine whose queries bring their results to the host together, held
against the same engine bringing them one entity at a time: responses,
streams, the write-back of an Add with operations, and a cancelled
query, and a large fan-out whose held results stay under the copy's
cap.  The CUDA side (a pinned copy queued behind the kernels that
write its tensors) is ``tests/test_torch_cuda.py``'s."""
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from repro_torch.core import boundary
from repro_torch.core import engine as engine_mod
from repro_torch.core.boundary import to_host, to_host_many
from repro_torch.core.engine import VDMSAsyncEngine
from repro_torch.core.udf import (register_device_udf, register_udf,
                                  unregister_udf)

DEVICE = {"device": 1e-9, "native": 10.0, "remote": 10.0, "batcher": 10.0}
ENGINES = {
    "native": {},
    "device": dict(dispatch="cost", device_backend="cpu",
                   device_max_wait_ms=20.0,
                   cost_overrides={"resize": DEVICE, "blur": DEVICE}),
}
PIPE = [{"type": "resize", "width": 12, "height": 12},
        {"type": "blur", "ksize": 3, "sigma_x": 1.0}]
# two commands whose results differ in shape: two runs, two copies
QUERY = [{"FindImage": {"constraints": {"category": ["==", "b"]},
                        "operations": PIPE}},
         {"FindImage": {"constraints": {"category": ["==", "c"]},
                        "operations": [{"type": "resize", "width": 8,
                                        "height": 8}]}}]


def _tensor(dtype, shape, seed, specials=True):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        t = torch.randn(shape, generator=g, dtype=dtype)
        if specials:
            t.view(-1)[:3] = torch.tensor([float("nan"), -0.0, float("inf")])
        return t
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=g, dtype=dtype)


def _assert_same_array(got, want):
    assert type(got) is np.ndarray
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == object:
        np.testing.assert_array_equal(got, want)
    else:
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8, torch.int32])
def test_arrays_are_the_per_entity_copies_bit_for_bit(dtype):
    ts = [_tensor(dtype, (5, 7, 3), seed) for seed in range(6)]
    got, copies = to_host_many(ts)
    assert len(got) == len(ts)
    for g, t in zip(got, ts):
        _assert_same_array(g, to_host(t))
        assert g.flags.c_contiguous and g.flags.writeable
    assert copies == 1


def test_mixed_runs_and_non_tensors_keep_their_order():
    a = [_tensor(torch.float32, (4, 4, 3), seed) for seed in range(3)]
    b = [_tensor(torch.float32, (2, 6, 3), seed) for seed in range(2)]
    host = np.arange(6.0).reshape(2, 3)
    grad = torch.ones(4, 4, 3, requires_grad=True) * 2
    datas = [a[0], b[0], host, _tensor(torch.int32, (4, 4, 3), 9), a[1],
             [1, 2, 3], torch.arange(12.0).reshape(3, 4).t(), None, b[1],
             2.5, a[2], grad, torch.tensor(7)]
    got, copies = to_host_many(datas)
    assert len(got) == len(datas)
    for g, d in zip(got, datas):
        _assert_same_array(g, to_host(d))
    assert got[2] is host                    # np.asarray, as to_host
    # runs: (4,4,3) float32 (a and grad), (2,6,3) float32, int32, the
    # transposed (4,3) float32, the 0-d int64
    assert copies == 5


def test_a_write_into_one_array_reaches_no_other_and_no_source():
    ts = [_tensor(torch.float32, (3, 5), seed, specials=False)
          for seed in range(4)]
    sources = [t.clone() for t in ts]
    got, _ = to_host_many(ts)
    before = [g.copy() for g in got]
    got[1][...] = 42.0
    for k, (g, b) in enumerate(zip(got, before)):
        if k != 1:
            np.testing.assert_array_equal(g, b)
    assert (got[1] == 42.0).all()
    for t, s in zip(ts, sources):
        assert torch.equal(t, s)
    for i in range(len(got)):
        for j in range(i + 1, len(got)):
            assert not np.shares_memory(got[i], got[j])


def test_an_empty_list_copies_nothing():
    assert to_host_many([]) == ([], 0)


@pytest.mark.parametrize("n,max_bytes,copies", [
    (10, 3 * 420, 4),     # stacks of 3, 3, 3 and 1
    (4, 420, 4),          # one tensor a stack, at the cap exactly
    (3, 100, 3),          # each tensor above the cap: a stack of its own
    (5, 10 * 420, 1),     # all under the cap: one stack
])
def test_a_run_is_cut_into_stacks_under_the_cap(n, max_bytes, copies,
                                                 monkeypatch):
    monkeypatch.setattr(boundary, "OUT_COPY_BYTES", max_bytes)
    ts = [_tensor(torch.float32, (5, 7, 3), seed) for seed in range(n)]
    got, made = to_host_many(ts)
    assert made == copies
    for g, t in zip(got, ts):
        _assert_same_array(g, to_host(t))
    for i in range(n):       # no array reaches past its own row
        for j in range(i + 1, n):
            assert not np.shares_memory(got[i], got[j])


def _faces(eng, n, size, seed, category):
    rng = np.random.default_rng(seed)
    return [eng.add_entity("image",
                           rng.uniform(0, 1, (size, size, 3)).astype(
                               np.float32), {"category": category, "i": i})
            for i in range(n)]


def _per_entity(datas):
    return [to_host(d) for d in datas], 0


def _answer(kind, query, **submit):
    eng = VDMSAsyncEngine(device="cpu", **ENGINES[kind])
    try:
        _faces(eng, 6, 16, 3, "b")
        _faces(eng, 3, 10, 4, "c")
        res = eng.submit(query, **submit).result(60)
        return res, eng.trace_stats(), eng.dispatch_stats()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kind", list(ENGINES))
def test_responses_equal_the_per_entity_way(kind, monkeypatch):
    got, trace, stats = _answer(kind, QUERY)
    monkeypatch.setattr(engine_mod, "to_host_many", _per_entity)
    want, trace_want, _ = _answer(kind, QUERY)
    assert "boundary.out_copies" not in trace_want["counters"]
    assert got["stats"]["failed"] == 0 and got["stats"]["matched"] == 9
    assert list(got["entities"]) == list(want["entities"])
    for eid, w in want["entities"].items():
        _assert_same_array(got["entities"][eid], w)
    assert trace["spans"]["boundary.out"][0] == 9         # one an image
    assert trace["counters"]["boundary.out_copies"] == 2  # one a shape
    if kind == "device":
        assert stats["device"]["entities_run"] >= 9


@pytest.mark.parametrize("kind", list(ENGINES))
def test_a_large_fan_out_holds_no_more_than_the_cap(kind, monkeypatch):
    """64 results of 1,728 bytes under a cap of four: the session brings
    them over four at a time as they finish, so the results it holds on
    the device, and each stacked copy, stay within the cap (one more
    result a native worker thread finishing at the same time)."""
    one = 12 * 12 * 3 * 4
    cap = 4 * one
    want, _, _ = _fan_out(kind)
    monkeypatch.setattr(boundary, "OUT_COPY_BYTES", cap)
    calls = []
    inner = VDMSAsyncEngine._to_host_many

    def spy(self, qid, datas):
        session = self._sessions[qid]
        held = sum(v.nbytes for r in session._ent_results.values()
                   for v in r.values() if isinstance(v, torch.Tensor))
        calls.append((sum(d.nbytes for d in datas), held))
        return inner(self, qid, datas)

    monkeypatch.setattr(VDMSAsyncEngine, "_to_host_many", spy)
    got, trace, workers = _fan_out(kind)
    assert list(got["entities"]) == list(want["entities"])
    for eid, w in want["entities"].items():
        _assert_same_array(got["entities"][eid], w)
    room = cap + (workers - 1) * one if kind == "native" else cap
    assert sum(n for n, _ in calls) == 64 * one
    assert max(held for _, held in calls) <= room
    assert max(n for n, _ in calls) <= room
    assert len(calls) >= 64 * one // room
    assert trace["spans"]["boundary.out"][0] == 64
    assert trace["counters"]["boundary.out_copies"] >= 16


def _fan_out(kind):
    eng = VDMSAsyncEngine(device="cpu", **ENGINES[kind])
    try:
        _faces(eng, 64, 16, 8, "b")
        res = eng.submit(QUERY[:1]).result(60)
        return res, eng.trace_stats(), eng.num_native_workers
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kind", list(ENGINES))
def test_a_stream_gets_a_host_array_for_each_entity_as_it_finishes(kind):
    seen = []
    res, trace, _ = _answer(kind, QUERY[:1],
                            on_entity=lambda e: seen.append((e.eid, e.data)))
    assert sorted(eid for eid, _ in seen) == sorted(res["entities"])
    for eid, arr in seen:
        assert type(arr) is np.ndarray
        assert arr is res["entities"][eid]    # no second copy at the end
    assert trace["spans"]["boundary.out"][0] == 6
    assert "boundary.out_copies" not in trace["counters"]


@pytest.mark.parametrize("kind", list(ENGINES))
def test_an_add_with_operations_writes_host_arrays_back(kind):
    img = np.random.default_rng(7).uniform(0, 1, (30, 30, 3)).astype(
        np.float32)
    query = [{"AddImage": {"properties": {"category": "new"}, "data": img,
                           "operations": [{"type": "resize", "width": 10,
                                           "height": 10}]}}]
    eng = VDMSAsyncEngine(device="cpu", **ENGINES[kind])
    try:
        res = eng.execute(query, timeout=60)
        ((eid, arr),) = res["entities"].items()
        stored = eng.store.get(eid)
        found = eng.execute([{"FindImage": {
            "constraints": {"category": ["==", "new"]}}}], timeout=60)
    finally:
        eng.shutdown()
    assert type(arr) is np.ndarray and arr.shape == (10, 10, 3)
    assert type(stored) is np.ndarray
    np.testing.assert_array_equal(stored, arr)
    np.testing.assert_array_equal(found["entities"][eid], arr)


@pytest.fixture
def gated_udf():
    """A device UDF that lets its first two groups through and holds
    the rest until the gate opens."""
    name = "t_boundary_gated"
    calls = []
    gate = threading.Event()

    def device_fn(imgs, **_):
        calls.append(len(imgs))
        if len(calls) > 2:
            assert gate.wait(60)
        return [i * 2 for i in imgs]

    register_udf(name, lambda img, **_: img * 2)
    register_device_udf(name, device_fn)
    try:
        yield name, calls, gate
    finally:
        gate.set()
        unregister_udf(name)


def test_a_cancelled_query_converts_nothing(gated_udf):
    name, calls, gate = gated_udf
    eng = VDMSAsyncEngine(device="cpu", dispatch="cost", device_backend="cpu",
                          device_batch_size=1, device_max_wait_ms=0.0,
                          cost_overrides={name: DEVICE})
    try:
        _faces(eng, 6, 8, 5, "g")
        fut = eng.submit([{"FindImage": {
            "constraints": {"category": ["==", "g"]},
            "operations": [{"type": "udf", "options": {"id": name}}]}}])
        session = fut._session
        for _ in range(600):     # two entities done, the third held
            if len(calls) >= 3 and session._pending <= 4:
                break
            time.sleep(0.05)
        assert len(calls) >= 3 and session._pending == 4
        assert fut.cancel()
        gate.set()
        with pytest.raises(CancelledError):
            fut.result(5)
        assert len(session._ent_results[0]) == 2   # kept on the device
        assert all(isinstance(v, torch.Tensor)
                   for v in session._ent_results[0].values())
        trace = eng.trace_stats()
    finally:
        gate.set()
        eng.shutdown()
    assert "boundary.out" not in trace["spans"]
    assert "boundary.out_copies" not in trace["counters"]
