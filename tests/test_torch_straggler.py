"""The port's straggler reissue held against ``tests/test_straggler.py``:
the first response wins and a duplicate never surfaces, and reissue
waits for a warmed latency estimate and happens at most once per
request.  Each result is also held against the op run inline."""
import queue
import time

import numpy as np
import torch

from repro_torch.core.entity import Entity
from repro_torch.core.pipeline import make_op, run_op
from repro_torch.core.remote import RemoteServerPool, TransportModel

torch.set_num_threads(1)


def test_straggler_reissue_first_response_wins():
    pool = RemoteServerPool(
        2, TransportModel(network_latency_s=0.001, service_time_s=0.002),
        straggler_factor=2.0)
    try:
        pool._lat_samples = 100          # pretend the estimate warmed up
        pool._lat_est = 0.005
        op = make_op("grayscale")
        reply: queue.Queue = queue.Queue()
        rng = np.random.default_rng(0)
        ents = [Entity(str(i), "image", torch.from_numpy(
            rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)), ops=[op])
            for i in range(6)]
        for e in ents:                   # round robin over both servers
            pool.dispatch(e, op, reply)
        time.sleep(0.05)
        pool.reissue_stragglers()
        done = {}
        deadline = time.time() + 10
        while len(done) < len(ents) and time.time() < deadline:
            try:
                tag, req, payload = reply.get(timeout=5)
            except queue.Empty:
                break
            status, result = pool.handle_response(tag, req, payload)
            if status == "done":
                eid = req.entity.eid
                assert eid not in done, "duplicate completion surfaced"
                done[eid] = result
        assert len(done) == len(ents)
        assert pool.duplicates_dropped >= 0
        for e in ents:
            torch.testing.assert_close(done[e.eid], run_op(op, e.data),
                                       rtol=0, atol=0)
    finally:
        pool.shutdown()


def test_reissue_requires_warmup_and_is_capped():
    pool = RemoteServerPool(
        2, TransportModel(network_latency_s=0.0, service_time_s=0.2),
        straggler_factor=0.001)  # absurdly aggressive
    try:
        op = make_op("grayscale")
        reply: queue.Queue = queue.Queue()
        pool.dispatch(Entity("x", "image", torch.zeros(4, 4, 3), ops=[op]),
                      op, reply)
        pool.reissue_stragglers()          # cold estimate -> no reissue
        assert pool.reissued == 0
        pool._lat_samples = 100
        time.sleep(0.01)
        pool.reissue_stragglers()
        pool.reissue_stragglers()          # capped at one reissue per request
        assert pool.reissued <= 1
    finally:
        pool.shutdown()
