"""The port's baseline executors (sync/VDMS, pooled/PostgreSQL,
frame-graph/Scanner) held against the port's engine and against the JAX
package's executors, on the CPU (``device="cpu"``): the scenarios of
``tests/test_system.py::test_async_matches_sync_results`` and
``::test_video_pipeline_executors_agree``, with their seeds.

Tolerances, absolute, on float32 values in [0, 1]: 1e-6 between two
port systems (the same ops on the same device; the reference's own
tolerance for these comparisons), and 1e-5 between the port and the JAX
package (a resize's interpolation sums in another library's order).
"""
import threading

import numpy as np
import pytest
import torch

from repro.core.entity import Entity as JaxEntity
from repro.core.executors import FrameExecutor as JaxFrame
from repro.core.executors import SyncExecutor as JaxSync
from repro.core.pipeline import make_op as jax_make_op
from repro.core.remote import RemoteServerPool as JaxPool
from repro.core.remote import TransportModel as JaxTransport
from repro_torch.core.engine import VDMSAsyncEngine
from repro_torch.core.entity import ERD, Entity
from repro_torch.core.executors import (FrameExecutor, PooledExecutor,
                                        SyncExecutor)
from repro_torch.core.pipeline import make_op
from repro_torch.core.remote import RemoteServerPool, TransportModel

FAST = dict(network_latency_s=0.001, service_time_s=0.002)
SAME, REF_TOL = 1e-6, 1e-5

OPS = [("resize", {"width": 24, "height": 24}, "native"),
       ("facedetect_box", {}, "remote"),
       ("grayscale", {}, "native")]
QUERY = [{"FindImage": {"constraints": {"category": ["==", "c"]},
                        "operations": [
                            {"type": "resize", "width": 24, "height": 24},
                            {"type": "remote", "url": "u",
                             "options": {"id": "facedetect_box"}},
                            {"type": "grayscale"}]}}]


def _images(seed=2, n=6):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
            for _ in range(n)]


def _ops(make):
    return [make(name, kw, where=where) for name, kw, where in OPS]


def _engine_response(imgs):
    """The port's engine on the same images: its arrays by ingest idx."""
    eng = VDMSAsyncEngine(device="cpu", num_remote_servers=2,
                          transport=TransportModel(**FAST))
    try:
        for i, img in enumerate(imgs):
            eng.add_entity("image", img, {"category": "c", "idx": i})
        res = eng.execute(QUERY, timeout=60)
        return {eng.meta.get(eid)["idx"]: arr
                for eid, arr in res["entities"].items()}
    finally:
        eng.shutdown()


def _jax_sync(imgs):
    pool = JaxPool(2, JaxTransport(**FAST))
    try:
        ents = [JaxEntity(str(i), "image", img.copy(), ops=_ops(jax_make_op))
                for i, img in enumerate(imgs)]
        JaxSync(pool).run(ents)
        return [np.asarray(e.data) for e in ents]
    finally:
        pool.shutdown()


def test_async_matches_sync_results():
    """The event-driven engine produces the synchronous VDMS baseline's
    results, and the port's sync baseline the JAX package's."""
    imgs = _images()
    pool = RemoteServerPool(2, TransportModel(**FAST))
    try:
        ents = [Entity(str(i), "image", img.copy(), ops=_ops(make_op))
                for i, img in enumerate(imgs)]
        erd = ERD()
        SyncExecutor(pool, device="cpu").run(ents, erd)
    finally:
        pool.shutdown()
    by_idx = _engine_response(imgs)
    ref = _jax_sync(imgs)
    for i, ent in enumerate(ents):
        assert isinstance(ent.data, np.ndarray)   # back through the host
        assert ent.op_index == len(OPS)
        np.testing.assert_allclose(by_idx[i], ent.data, atol=SAME, rtol=0)
        np.testing.assert_allclose(ref[i], ent.data, atol=REF_TOL, rtol=0)


@pytest.mark.parametrize("system", ["pool", "frame"])
def test_pooled_and_frame_executors_match_the_engine(system):
    imgs = _images()
    pool = RemoteServerPool(2, TransportModel(**FAST))
    try:
        ents = [Entity(str(i), "image", img.copy(), ops=_ops(make_op))
                for i, img in enumerate(imgs)]
        cls = PooledExecutor if system == "pool" else FrameExecutor
        ex = cls(pool, workers=3, device="cpu")
        ex.run(ents)
    finally:
        pool.shutdown()
    assert ex.meter.busy_seconds() > 0
    by_idx = _engine_response(imgs)
    for i, ent in enumerate(ents):
        assert isinstance(ent.data, np.ndarray)
        assert ent.op_index == len(OPS)
        np.testing.assert_allclose(by_idx[i], ent.data, atol=SAME, rtol=0)


def test_video_pipeline_executors_agree():
    rng = np.random.default_rng(4)
    vid = rng.uniform(0, 1, (4, 24, 24, 3)).astype(np.float32)
    pool = RemoteServerPool(2, TransportModel(**FAST))
    try:
        ops = [make_op("grayscale"), make_op("threshold", {"value": 0.5})]
        e1 = Entity("v1", "video", vid.copy(), ops=list(ops))
        e2 = Entity("v2", "video", vid.copy(), ops=list(ops))
        SyncExecutor(pool, device="cpu").run([e1])
        FrameExecutor(pool, workers=2, device="cpu").run([e2])
    finally:
        pool.shutdown()
    np.testing.assert_allclose(e1.data, e2.data, atol=SAME, rtol=0)
    assert e2.data.shape[0] == 4
    jpool = JaxPool(2, JaxTransport(**FAST))
    try:
        jops = [jax_make_op("grayscale"),
                jax_make_op("threshold", {"value": 0.5})]
        j1 = JaxEntity("v1", "video", vid.copy(), ops=list(jops))
        j2 = JaxEntity("v2", "video", vid.copy(), ops=list(jops))
        JaxSync(jpool).run([j1])
        JaxFrame(jpool, workers=2).run([j2])
    finally:
        jpool.shutdown()
    np.testing.assert_allclose(np.asarray(j1.data), e1.data, atol=REF_TOL,
                               rtol=0)
    np.testing.assert_allclose(np.asarray(j2.data), e2.data, atol=REF_TOL,
                               rtol=0)


def test_executors_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    pool = RemoteServerPool(1, TransportModel(**FAST))
    try:
        before = set(threading.enumerate())
        for make in (lambda: SyncExecutor(pool),      # "cuda" by default
                     lambda: PooledExecutor(pool),
                     lambda: FrameExecutor(pool)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        assert set(threading.enumerate()) == before
    finally:
        pool.shutdown()
