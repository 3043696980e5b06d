"""``tests/test_system.py`` on the port: the engine end to end — query
execution, pipeline order, concurrent clients, a killed server and
elastic scale-out, and the architecture-comparison invariants — with
the reference's seeds, function by function under the same names.

The port's engine runs on the CPU (``device="cpu"``).  Where the answer
is fixed, the JAX package's engine (or executor) runs the same scenario
beside it (``tests/torch_parity.py``): bytes for index and comparison
pipelines (a threshold after a resize compares values a resize sums in
another order, so those are held within ``TOL``), 1e-5 for float
chains, and the reference's own 1e-6 between two systems of the port.
"""
import threading
import time

import numpy as np

from repro.core.entity import Entity as RefEntity
from repro.core.executors import FrameExecutor as RefFrame
from repro.core.executors import SyncExecutor as RefSync
from repro.core.pipeline import make_op as ref_make_op
from repro.core.remote import RemoteServerPool as RefPool
from repro.core.remote import TransportModel as RefTransport
from repro_torch.core.entity import Entity
from repro_torch.core.executors import FrameExecutor, SyncExecutor
from repro_torch.core.pipeline import make_op
from repro_torch.core.remote import RemoteServerPool, TransportModel
from torch_parity import (FAST, TOL, assert_same, entities, port_engine,
                          ref_engine)

SAME = 1e-6    # the reference's tolerance between two systems


def _add_images(eng, n=10, size=32):
    rng = np.random.default_rng(0)
    ids = []
    for i in range(n):
        img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        ids.append(eng.add_entity("image", img, {
            "category": "lfw", "name": f"p{i}", "age": 20 + i}))
    return ids


PIPE = [
    {"type": "resize", "width": 24, "height": 24},
    {"type": "remote", "url": "http://s/box",
     "options": {"id": "facedetect_box"}},
    {"type": "threshold", "value": 0.4},
]
LFW = [{"FindImage": {"constraints": {"category": ["==", "lfw"]},
                      "operations": PIPE}}]


def _both(scenario, **kw):
    """``scenario(engine)`` on the port's engine and on the reference's,
    each shut down after."""
    out = []
    for make in (port_engine, ref_engine):
        eng = make(**kw)
        try:
            out.append(scenario(eng))
        finally:
            eng.shutdown()
    return out


def test_query_returns_all_matching_entities():
    def scenario(eng):
        _add_images(eng, 10)
        return eng.execute(LFW, timeout=60)

    res, ref = _both(scenario)
    assert res["stats"]["matched"] == 10
    assert res["stats"]["failed"] == 0
    assert len(res["entities"]) == 10
    for arr in res["entities"].values():
        assert np.asarray(arr).shape == (24, 24, 3)
        vals = np.unique(np.asarray(arr).round(3))
        assert set(vals).issubset({0.0, 1.0})
    assert_same(res, ref, atol=TOL)


def test_constraint_filtering():
    def scenario(eng):
        _add_images(eng, 10)
        res = eng.execute([{"FindImage": {
            "constraints": {"age": [">=", 25, "<", 28]},
            "operations": [{"type": "grayscale"}]}}], timeout=30)
        return res, sorted(eng.meta.get(e)["age"] for e in res["entities"])

    (res, ages), (ref, ref_ages) = _both(scenario)
    assert res["stats"]["matched"] == 3  # ages 25,26,27
    assert ages == ref_ages == [25, 26, 27]
    assert_same(res, ref, atol=TOL)


def test_pipeline_order_preserved():
    """resize->crop != crop->resize; the engine keeps the user's order."""
    def scenario(eng):
        rng = np.random.default_rng(1)
        img = rng.uniform(0, 1, (40, 40, 3)).astype(np.float32)
        eng.add_entity("image", img, {"category": "x"})
        return eng.execute([{"FindImage": {
            "constraints": {"category": ["==", "x"]},
            "operations": [{"type": "resize", "width": 20, "height": 20},
                           {"type": "crop", "x": 0, "y": 0,
                            "width": 10, "height": 10}]}}], timeout=30)

    r1, ref = _both(scenario)
    (arr1,) = list(r1["entities"].values())
    assert np.asarray(arr1).shape == (10, 10, 3)
    assert_same(r1, ref, atol=TOL)


def test_multi_client_concurrent_queries():
    eng = port_engine(num_remote_servers=4)
    try:
        _add_images(eng, 12)
        results = {}

        def client(cid):
            results[cid] = eng.execute(LFW, timeout=120)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(results) == 4
        for r in results.values():
            assert r["stats"]["matched"] == 12
            assert r["stats"]["failed"] == 0
            assert_same(r, results[0])
    finally:
        eng.shutdown()


def test_failure_retry_and_elastic_scale():
    def scenario(eng):
        _add_images(eng, 8)

        def killer():
            time.sleep(0.02)
            eng.pool.kill_server(0)

        th = threading.Thread(target=killer)
        th.start()
        res = eng.execute(LFW, timeout=120)
        th.join()
        assert res["stats"]["failed"] == 0
        assert eng.pool.live_count() == 2
        eng.scale_remote(5)
        assert eng.pool.live_count() == 5
        res2 = eng.execute(LFW, timeout=120)
        assert res2["stats"]["failed"] == 0
        return res, res2

    (res, res2), (ref, ref2) = _both(scenario, num_remote_servers=3)
    assert_same(res, res2)               # the kill changed no answer
    assert_same(res2, ref2, atol=TOL)


def _imgs(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
            for _ in range(n)]


def test_async_matches_sync_results():
    """The event-driven engine gives the synchronous VDMS baseline's
    results, and both the reference's sync baseline's."""
    imgs = _imgs(2, 6)
    spec = [("resize", {"width": 24, "height": 24}, "native"),
            ("facedetect_box", {}, "remote"), ("grayscale", {}, "native")]
    pool = RemoteServerPool(2, TransportModel(**FAST))
    try:
        sync_ents = [Entity(str(i), "image", img.copy(),
                            ops=[make_op(n, kw, where=w) for n, kw, w
                                 in spec]) for i, img in enumerate(imgs)]
        SyncExecutor(pool, device="cpu").run(sync_ents)
    finally:
        pool.shutdown()
    ref_pool = RefPool(2, RefTransport(**FAST))
    try:
        ref_ents = [RefEntity(str(i), "image", img.copy(),
                              ops=[ref_make_op(n, kw, where=w) for n, kw, w
                                   in spec]) for i, img in enumerate(imgs)]
        RefSync(ref_pool).run(ref_ents)
    finally:
        ref_pool.shutdown()

    eng = port_engine(num_remote_servers=2)
    try:
        for i, img in enumerate(imgs):
            eng.add_entity("image", img, {"category": "c", "idx": i})
        res = eng.execute([{"FindImage": {
            "constraints": {"category": ["==", "c"]},
            "operations": [
                {"type": "resize", "width": 24, "height": 24},
                {"type": "remote", "url": "u",
                 "options": {"id": "facedetect_box"}},
                {"type": "grayscale"}]}}], timeout=60)
        by_idx = {eng.meta.get(eid)["idx"]: arr
                  for eid, arr in res["entities"].items()}
        for i, (ent, ref) in enumerate(zip(sync_ents, ref_ents)):
            np.testing.assert_allclose(np.asarray(by_idx[i]),
                                       np.asarray(ent.data), atol=SAME)
            np.testing.assert_allclose(np.asarray(ent.data),
                                       np.asarray(ref.data), atol=TOL)
    finally:
        eng.shutdown()


def test_fused_pipeline_matches_unfused():
    q = [{"FindImage": {"constraints": {"category": ["==", "z"]},
                        "operations": [
                            {"type": "resize", "width": 16, "height": 16},
                            {"type": "grayscale"},
                            {"type": "threshold", "value": 0.5}]}}]
    img = np.random.default_rng(3).uniform(0, 1, (32, 32, 3)).astype(
        np.float32)
    out = {}
    for name, make, fuse in (("fused", port_engine, True),
                             ("unfused", port_engine, False),
                             ("ref", ref_engine, True)):
        eng = make(fuse_native=fuse)
        try:
            eng.add_entity("image", img, {"category": "z"})
            (out[name],) = entities(eng.execute(q, timeout=30)).values()
        finally:
            eng.shutdown()
    np.testing.assert_allclose(out["fused"], out["unfused"], atol=SAME)
    np.testing.assert_allclose(out["fused"], out["ref"], atol=TOL)


def test_video_pipeline_executors_agree():
    rng = np.random.default_rng(4)
    vid = rng.uniform(0, 1, (4, 24, 24, 3)).astype(np.float32)
    spec = [("grayscale", {}), ("threshold", {"value": 0.5})]
    pool = RemoteServerPool(2, TransportModel(**FAST))
    try:
        ops = [make_op(n, kw) for n, kw in spec]
        e1 = Entity("v1", "video", vid.copy(), ops=list(ops))
        e2 = Entity("v2", "video", vid.copy(), ops=list(ops))
        SyncExecutor(pool, device="cpu").run([e1])
        FrameExecutor(pool, workers=2, device="cpu").run([e2])
    finally:
        pool.shutdown()
    np.testing.assert_allclose(np.asarray(e1.data), np.asarray(e2.data),
                               atol=SAME)
    ref_pool = RefPool(2, RefTransport(**FAST))
    try:
        r = RefEntity("v1", "video", vid.copy(),
                      ops=[ref_make_op(n, kw) for n, kw in spec])
        RefFrame(ref_pool, workers=2).run([r])
    finally:
        ref_pool.shutdown()
    np.testing.assert_array_equal(np.asarray(e2.data), np.asarray(r.data))


def test_add_image_with_operations():
    def scenario(eng):
        rng = np.random.default_rng(5)
        img = rng.uniform(0, 1, (30, 30, 3)).astype(np.float32)
        res = eng.execute([{"AddImage": {
            "properties": {"category": "new"},
            "data": img,
            "operations": [{"type": "resize", "width": 10,
                            "height": 10}]}}], timeout=30)
        found = eng.execute([{"FindImage": {
            "constraints": {"category": ["==", "new"]},
            "operations": []}}], timeout=30)
        return res, found

    (res, found), (ref, ref_found) = _both(scenario)
    (arr,) = list(res["entities"].values())
    assert np.asarray(arr).shape == (10, 10, 3)
    # the stored entity is the processed one
    (arr2,) = list(found["entities"].values())
    assert np.asarray(arr2).shape == (10, 10, 3)
    assert_same(found, res)
    assert_same(found, ref_found, atol=TOL)
