"""The port's wire front end held against the JAX package's, on the CPU
(``device="cpu"``): the scenarios of ``tests/test_frontend.py``, with its
seeds and parameters.

Conformance reads the reference's golden transcripts in
``tests/wire_golden/``: the port's frames, normalized as the reference
normalizes them (durations, retry estimates and load snapshots
canonicalized), must equal them byte for byte, base64 entity payloads
included.  A missing golden file fails; this file never writes one.

The chaos half storms the port's frontend with clients that disconnect
mid-stream (and, in front of the port's ShardedEngine, lose a shard
mid-query): survivors get the exact in-process results, no admission
slot leaks, inflight stays bounded.  The admission v2 units (tenant fair
shares, cost-aware charging) run each scenario on the port's controller
and on the reference's and require the same answers.  A hypothesis
property holds the port's codec to any chunking of the stream, 0-d
arrays and tensors included (the reference's codec turns a 0-d array
one-dimensional), and the network launcher serves on the CPU.

Tolerance: exact everywhere (index permutations, base64 bytes, counts).
"""
from __future__ import annotations

import difflib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core.engine import VDMSAsyncEngine as JaxEngine
from repro.core.remote import TransportModel as JaxTransport
from repro.query.admission import AdmissionController as JaxController
from repro.query.admission import OverloadError as JaxOverload
from repro.serving.wire import to_jsonable as jax_to_jsonable
from repro_torch.cluster.engine import ShardedEngine
from repro_torch.core.engine import VDMSAsyncEngine
from repro_torch.core.remote import TransportModel
from repro_torch.query.admission import AdmissionController, OverloadError
from repro_torch.serving.frontend import WireClient, WireFrontend
from repro_torch.serving.wire import (FrameDecoder, encode_frame,
                                      from_jsonable, reassemble, to_jsonable)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "wire_golden")
FAST = TransportModel(network_latency_s=0.0005, service_time_s=0.0005)
SLOW = TransportModel(network_latency_s=0.005, service_time_s=0.05)

# deterministic server shape for every golden transcript: one native
# worker + FIFO scheduling means entity frames arrive in enqueue order
DET = dict(num_remote_servers=1, num_native_workers=1,
           fair_scheduling=False, transport=FAST, device="cpu")


def _fill(eng, n=3, size=8, seed=7):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        eng.add_entity(
            "image",
            rng.integers(0, 255, (size, size, 3)).astype(np.float32),
            {"category": "wire"})


def _find(ops=({"type": "flip", "axis": "vertical"},)):
    return [{"FindImage": {"constraints": {"category": ["==", "wire"]},
                           "operations": list(ops)}}]


REMOTE_FLIP = ({"type": "remote", "url": "u", "options": {"id": "flip"}},)


def _same_entities(got, want):
    assert list(got["entities"]) == list(want["entities"])
    for eid, arr in want["entities"].items():
        arr = np.asarray(arr)
        w = got["entities"][eid]
        assert w.dtype == arr.dtype and w.shape == arr.shape
        assert np.array_equal(w, arr)


# ------------------------------------------------- transcript machinery
_RETRY_RE = re.compile(r"retry_after_s=[^\s)]+")


def _normalize(frames):
    """The reference's canonicalization of the volatile parts of a
    transcript: wall-clock durations, retry estimates and load
    snapshots.  Everything else must match the golden byte for byte."""
    out = []
    for event, payload in frames:
        p = json.loads(json.dumps(payload))
        if isinstance(p.get("stats"), dict) and "duration_s" in p["stats"]:
            p["stats"]["duration_s"] = 0.0
        if "retry_after_s" in p:
            p["retry_after_s"] = ("<positive>" if p["retry_after_s"] > 0
                                  else p["retry_after_s"])
        p.pop("load", None)
        if isinstance(p.get("message"), str):
            p["message"] = _RETRY_RE.sub("retry_after_s=<n>", p["message"])
        out.append([event, p])
    return out


def _check_golden(name: str, frames):
    got = json.dumps(_normalize(frames), indent=1, sort_keys=True) + "\n"
    path = os.path.join(GOLDEN_DIR, name + ".json")
    assert os.path.exists(path), f"golden transcript {path} is missing"
    with open(path) as f:
        want = f.read()
    if got != want:
        diff = "\n".join(difflib.unified_diff(
            want.splitlines(), got.splitlines(),
            fromfile=f"wire_golden/{name}.json", tofile="observed",
            lineterm=""))
        pytest.fail(f"wire transcript diverged from golden:\n{diff}")


def _serve(engine):
    return WireFrontend(engine).start()


# ============================================ golden conformance suite
def test_golden_submit_stream_complete():
    eng = VDMSAsyncEngine(**DET)
    try:
        _fill(eng, n=3)
        front = _serve(eng)
        try:
            with WireClient(front.address) as c:
                one = c.submit(_find(), rid="q-stream")
                one.wait_terminal(30)
                # two commands in one query: entity frames carry
                # cmd_index, the complete frame carries final key order
                two = c.submit(
                    [{"FindImage": {"constraints": {"category":
                                                    ["==", "wire"]},
                      "operations": [{"type": "flip", "axis": "vertical"}]}},
                     {"FindImage": {"constraints": {"category":
                                                    ["==", "wire"]},
                      "operations": [{"type": "rotate", "k": 1}]}}],
                    rid="q-two-cmds")
                two.wait_terminal(30)
            _check_golden("submit_stream_complete", one.frames + two.frames)
        finally:
            front.close()
    finally:
        eng.shutdown()


def test_golden_error_frames():
    eng = VDMSAsyncEngine(**dict(DET, transport=SLOW))
    try:
        _fill(eng, n=1)
        front = _serve(eng)
        try:
            with WireClient(front.address) as c:
                # a query the engine cannot parse: error frame, conn lives
                bad_cmd = c.submit([{"ExplodeImage": {}}], rid="q-bad-cmd")
                bad_cmd.wait_terminal(30)
                # well-formed submit missing its query: rejected by rid
                c.send_raw(b'event: submit\n'
                           b'data: {"rid": "q-no-query"}\n\n')
                no_query = c.next_orphan(timeout=10)
                # rid reuse while the first query is still in flight
                slow = c.submit(_find(ops=REMOTE_FLIP), rid="q-dup")
                c.send_raw(b'event: submit\n'
                           b'data: {"query": [], "rid": "q-dup"}\n\n')
                ev, _ = slow.wait_terminal(30)
                assert ev == "error"   # the collision poisons only q-dup
                assert c.ping(), "semantic rejections keep the connection"
            _check_golden("error_frames",
                          bad_cmd.frames + [no_query] + slow.frames)
        finally:
            front.close()
    finally:
        eng.shutdown()


def test_golden_overload_429():
    """The saturated engine answers over the wire with the 429 frame +
    retry-after; once capacity frees, the same query completes."""
    eng = VDMSAsyncEngine(**DET, admission="shed", max_inflight_entities=2)
    try:
        _fill(eng, n=2)
        # deterministically saturate the ledger: a pre-ingest claim holds
        # both slots without any racing in-flight work
        eng.admission_ctl.reserve("hold", 2, first_phase=True)
        front = _serve(eng)
        try:
            with WireClient(front.address) as c:
                shed = c.submit(_find(), rid="q-shed")
                shed.wait_terminal(30)
                eng.admission_ctl.drop_query("hold")
                retry = c.submit(_find(), rid="q-retry")
                retry.wait_terminal(30)
            _check_golden("overload_429", shed.frames + retry.frames)
            # and the client rebuilds the typed exception
            with pytest.raises(OverloadError) as ei:
                shed.result(1)
            assert ei.value.retry_after_s > 0
        finally:
            front.close()
    finally:
        eng.shutdown()


def test_golden_tenant_quota():
    """Per-tenant quota exhaustion: bronze (weight 1 of 4 → 2 of 8
    slots) is rejected with the tenant-tagged 429 while gold's share
    still admits."""
    eng = VDMSAsyncEngine(**DET, admission="shed", max_inflight_entities=8,
                          admission_tenants={"gold": 3.0, "bronze": 1.0})
    try:
        _fill(eng, n=2)
        eng.admission_ctl.reserve("hold", 3, first_phase=True,
                                  tenant="bronze")
        front = _serve(eng)
        try:
            with WireClient(front.address) as c:
                bronze = c.submit(_find(), tenant="bronze", rid="q-bronze")
                bronze.wait_terminal(30)
                gold = c.submit(_find(), tenant="gold", rid="q-gold")
                gold.wait_terminal(30)
            _check_golden("tenant_quota", bronze.frames + gold.frames)
            assert bronze.frames[-1][0] == "overload"
            assert bronze.frames[-1][1]["tenant"] == "bronze"
            assert gold.frames[-1][0] == "complete"
        finally:
            front.close()
    finally:
        eng.shutdown()


def test_golden_malformed_frames():
    """Grammar violations are answered with an error frame, then the
    connection is dropped; a well-formed but invalid frame keeps it."""
    eng = VDMSAsyncEngine(**DET)
    try:
        front = _serve(eng)
        collected = []
        try:
            for raw in (b"event: nonsense\ndata: {}\n\n",
                        b"event: submit\ndata: not json at all\n\n",
                        b"no grammar here whatsoever\n\n"):
                c = WireClient(front.address)
                c.send_raw(raw)
                collected.append(c.next_orphan(timeout=10))
                assert c.disconnected.wait(10), \
                    "grammar violation must drop the connection"
                c.close()
            c = WireClient(front.address)
            c.send_raw(b'event: submit\ndata: {"query": []}\n\n')
            collected.append(c.next_orphan(timeout=10))
            assert c.ping(), "semantic rejection must keep the connection"
            c.close()
            _check_golden("malformed_frames", collected)
        finally:
            front.close()
    finally:
        eng.shutdown()


# =============================================== live serving contract
def test_wire_result_byte_identical_to_inprocess():
    eng = VDMSAsyncEngine(**DET)
    ref = JaxEngine(num_remote_servers=1, num_native_workers=1,
                    fair_scheduling=False,
                    transport=JaxTransport(network_latency_s=0.0005,
                                           service_time_s=0.0005))
    try:
        _fill(eng, n=4)
        _fill(ref, n=4)
        want = eng.execute(_find())
        front = _serve(eng)
        try:
            with WireClient(front.address) as c:
                fut = c.submit(_find())
                got = fut.result(30)
        finally:
            front.close()
        assert [e for e, _ in fut.frames][:1] == ["submitted"]
        _same_entities(got, want)
        _same_entities(got, ref.execute(_find()))   # and the JAX engine's
    finally:
        eng.shutdown()
        ref.shutdown()


def test_cancel_frame_reaches_session():
    eng = VDMSAsyncEngine(**dict(DET, transport=SLOW))
    try:
        _fill(eng, n=6)
        front = _serve(eng)
        try:
            with WireClient(front.address) as c:
                fut = c.submit(_find(ops=REMOTE_FLIP))
                time.sleep(0.05)
                fut.cancel()
                terminal, _ = fut.wait_terminal(30)
                assert terminal == "cancelled"
        finally:
            front.close()
        # the engine is healthy afterwards: nothing leaked
        assert len(eng.execute(_find())["entities"]) == 6
    finally:
        eng.shutdown()


def _drained(eng, timeout=10):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = eng.admission_ctl.stats()
        if (st["inflight"], st["pending"], st["reserved"]) == (0, 0, 0):
            break
        time.sleep(0.01)
    return eng.admission_ctl.stats()


def test_disconnect_cancels_and_frees_admission_slots():
    """A client that dies mid-stream must not leak admission slots:
    disconnect → cancel → drop_query zeroes the ledger."""
    eng = VDMSAsyncEngine(**dict(DET, transport=SLOW), admission="shed",
                          max_inflight_entities=6)
    try:
        _fill(eng, n=6)
        front = _serve(eng)
        try:
            c = WireClient(front.address)
            c.submit(_find(ops=REMOTE_FLIP))
            time.sleep(0.08)          # mid-stream: remote ops in flight
            c.drop()
            st = _drained(eng)
            assert (st["inflight"], st["pending"], st["reserved"]) \
                == (0, 0, 0), f"leaked admission ledger: {st}"
            # full capacity is usable again
            assert len(eng.execute(_find())["entities"]) == 6
        finally:
            front.close()
    finally:
        eng.shutdown()


def test_saturated_engine_still_serves_cache_hits():
    """While the ledger is saturated, a cache-servable query completes
    over the wire and a cache-bypassing one gets the 429."""
    eng = VDMSAsyncEngine(**DET, cache_capacity=64, admission="shed",
                          max_inflight_entities=4)
    try:
        _fill(eng, n=3)
        front = _serve(eng)
        try:
            with WireClient(front.address) as c:
                warm = c.submit(_find()).result(30)       # populate cache
                eng.admission_ctl.reserve("hold", 4, first_phase=True)
                served = c.submit(_find()).result(30)     # cache-served
                assert served["stats"]["cache_full_hits"] == 3
                for eid in warm["entities"]:
                    assert np.array_equal(served["entities"][eid],
                                          warm["entities"][eid])
                with pytest.raises(OverloadError) as ei:
                    c.submit(_find(), cache=False).result(30)
                assert ei.value.retry_after_s > 0
        finally:
            front.close()
    finally:
        eng.shutdown()


def test_frontend_fronts_sharded_engine():
    eng = ShardedEngine(num_shards=3, replica_factor=2, **DET)
    try:
        _fill(eng, n=6)
        want = eng.execute(_find())
        front = _serve(eng)
        try:
            with WireClient(front.address) as c:
                got = c.execute(_find(), timeout=30)
            _same_entities(got, want)
        finally:
            front.close()
    finally:
        eng.shutdown()


# ======================================================== chaos storms
@pytest.mark.parametrize("seed", range(3))
def test_chaos_storm_disconnects_never_leak_slots(seed):
    """Seeded storm: concurrent wire clients, a subset dying abruptly
    mid-stream.  Survivors get the exact in-process result, the
    admission ledger drains to zero, and inflight never exceeded the
    cap."""
    rng = np.random.default_rng(seed)
    eng = VDMSAsyncEngine(
        device="cpu", num_remote_servers=2, num_native_workers=2,
        fair_scheduling=True,
        transport=TransportModel(network_latency_s=0.002,
                                 service_time_s=0.004),
        admission="queue", max_inflight_entities=8,
        admission_queue_cap=4096)
    try:
        _fill(eng, n=6, seed=seed)
        q = _find(ops=REMOTE_FLIP)
        ref = eng.execute(q)
        front = _serve(eng)
        clients, droppers, results, errors = [], [], {}, []
        try:
            n_clients = 10
            drop_idx = set(rng.choice(n_clients, size=4, replace=False)
                           .tolist())
            barrier = threading.Barrier(n_clients)

            def run(i):
                try:
                    c = WireClient(front.address)
                    clients.append(c)
                    barrier.wait(timeout=10)
                    fut = c.submit(q)
                    if i in drop_idx:
                        time.sleep(float(rng.uniform(0.0, 0.05)))
                        c.drop()
                        droppers.append(i)
                        return
                    results[i] = fut.result(60)
                    c.close()
                except Exception as e:  # noqa: BLE001 — collected below
                    errors.append((i, e))

            threads = [threading.Thread(target=run, args=(i,), daemon=True)
                       for i in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert not errors, f"surviving clients failed: {errors}"
            assert len(droppers) == 4 and len(results) == 6
            for res in results.values():
                _same_entities(res, ref)
            st = _drained(eng, timeout=15)
            assert (st["inflight"], st["pending"], st["reserved"]) \
                == (0, 0, 0), f"leaked admission ledger: {st}"
            assert st["peak_inflight"] <= 8
        finally:
            front.close()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("seed", range(2))
def test_chaos_storm_sharded_kill_shard_mid_query(seed):
    """Clients storm the wire while a shard dies mid-query (and two
    clients drop).  At replica_factor=2 every surviving client still
    gets the full, exact result set."""
    rng = np.random.default_rng(100 + seed)
    eng = ShardedEngine(
        device="cpu", num_shards=3, replica_factor=2, num_remote_servers=1,
        num_native_workers=1, fair_scheduling=False,
        transport=TransportModel(network_latency_s=0.001,
                                 service_time_s=0.01))
    try:
        _fill(eng, n=6, seed=seed)
        q = _find(ops=REMOTE_FLIP)
        ref = eng.execute(q)
        front = _serve(eng)
        results, errors, droppers = {}, [], []
        try:
            n_clients = 6
            drop_idx = set(rng.choice(n_clients, size=2, replace=False)
                           .tolist())
            barrier = threading.Barrier(n_clients + 1)

            def run(i):
                try:
                    c = WireClient(front.address)
                    barrier.wait(timeout=10)
                    fut = c.submit(q)
                    if i in drop_idx:
                        time.sleep(float(rng.uniform(0.0, 0.03)))
                        c.drop()
                        droppers.append(i)
                        return
                    results[i] = fut.result(120)
                    c.close()
                except Exception as e:  # noqa: BLE001
                    errors.append((i, e))

            threads = [threading.Thread(target=run, args=(i,), daemon=True)
                       for i in range(n_clients)]
            for t in threads:
                t.start()
            barrier.wait(timeout=10)
            time.sleep(float(rng.uniform(0.005, 0.03)))
            victim = int(rng.integers(0, 3))
            eng.kill_shard(victim)
            for t in threads:
                t.join(timeout=180)
            assert not any(t.is_alive() for t in threads)
            assert not errors, f"surviving clients failed: {errors}"
            assert len(results) == n_clients - 2
            for res in results.values():
                assert res["stats"]["failed"] == 0
                _same_entities(res, ref)
            assert victim not in eng.cluster_stats()["live_shards"]
        finally:
            front.close()
    finally:
        eng.shutdown()


# ==================================== admission v2: tenants + cost units
class _E:
    def __init__(self, qid):
        self.query_id = qid


class _Tracker:
    def __init__(self, est):
        self._est = est

    def mean_estimate(self):            # the reference's name
        return self._est

    def mean_cost_estimate(self):       # the port's
        return self._est


def _both(scenario):
    """Run ``scenario(controller_class)`` on the port's controller and
    on the reference's; they must observe the same values."""
    got, want = scenario(AdmissionController), scenario(JaxController)
    assert got == want
    return got


def _shed(fn):
    """The retry estimate of the OverloadError ``fn`` raises, and its
    tenant."""
    try:
        fn()
    except (OverloadError, JaxOverload) as e:
        return ("shed", e.retry_after_s, e.tenant)
    return ("admitted",)


def test_cost_aware_charges_estimated_work_seconds():
    def scenario(cls):
        ctl = cls(max_inflight=100, policy="shed", cost_aware=True,
                  cost_cap_s=2.0)
        ctl.bind(loop=None, pool=None, launch=None, tracker=_Tracker(0.5))
        seen = [ctl.unit_charge(1), ctl.unit_charge(4)]
        # 3 one-op entities = 1.5s of the 2.0s budget
        admitted = ctl.admit_phase("a", [_E("a") for _ in range(3)], 0,
                                   first_phase=True, n_ops=1)
        seen += [len(admitted), ctl.stats()["cost"]["inflight_cost_s"]]
        # 2 more would charge 1.0s against 0.5s free — shed, with the
        # deficit itself as the retry estimate
        seen.append(_shed(lambda: ctl.admit_phase(
            "b", [_E("b"), _E("b")], 0, first_phase=True, n_ops=1)))
        ctl.note_done(admitted[0])
        seen.append(ctl.stats()["cost"]["inflight_cost_s"])
        ok = ctl.admit_phase("c", [_E("c"), _E("c")], 0, first_phase=True,
                             n_ops=1)
        seen.append(len(ok))
        for e in admitted[1:] + ok:
            ctl.note_done(e)
        st = ctl.stats()
        return seen + [st["cost"]["inflight_cost_s"], st["inflight"]]

    seen = _both(scenario)
    assert seen[:2] == [0.5, 2.0]
    assert seen[2] == 3 and seen[3] == pytest.approx(1.5)
    assert seen[4][0] == "shed" and 0 < seen[4][1] <= 60
    assert seen[5] == pytest.approx(1.0) and seen[6] == 2
    assert seen[7] == pytest.approx(0.0) and seen[8] == 0


def test_cost_aware_wider_pipelines_charge_more():
    def scenario(cls):
        ctl = cls(max_inflight=100, policy="shed", cost_aware=True,
                  cost_cap_s=1.0)
        ctl.bind(loop=None, pool=None, launch=None, tracker=_Tracker(0.2))
        # a single 6-op entity charges 1.2s > 1.0s cap: never fits
        never = _shed(lambda: ctl.admit_phase("a", [_E("a")], 0,
                                              first_phase=True, n_ops=6))
        fits = ctl.admit_phase("a", [_E("a")], 0, first_phase=True, n_ops=4)
        return [never, len(fits)]

    never, fits = _both(scenario)
    assert never[:2] == ("shed", float("inf")) and fits == 1


def test_tenant_fair_share_math_and_exemption():
    def scenario(cls):
        ctl = cls(max_inflight=8, policy="shed",
                  tenant_weights={"gold": 3.0, "bronze": 1.0})
        caps = [ctl._tenant_cap_locked(t)
                for t in ("gold", "bronze", "stranger")]
        b1 = ctl.admit_phase("b1", [_E("b1"), _E("b1")], 0,
                             first_phase=True, tenant="bronze")
        b2 = _shed(lambda: ctl.admit_phase("b2", [_E("b2")], 0,
                                           first_phase=True,
                                           tenant="bronze"))
        g1 = ctl.admit_phase("g1", [_E("g1")] * 3, 0, first_phase=True,
                             tenant="gold")
        p1 = ctl.admit_phase("p1", [_E("p1")] * 3, 0, first_phase=True)
        return [caps, len(b1), b2[0], b2[2], len(g1), len(p1)]

    caps, b1, b2, tenant, g1, p1 = _both(scenario)
    assert caps == pytest.approx([6.0, 2.0, 8.0 / 5.0])
    assert (b1, b2, tenant, g1, p1) == (2, "shed", "bronze", 3, 3)


def test_tenant_anti_starvation_first_phase_always_lands():
    """A tenant holding nothing is admitted even when one phase exceeds
    its share — a small share must throttle, never starve outright."""
    def scenario(cls):
        ctl = cls(max_inflight=8, policy="shed",
                  tenant_weights={"tiny": 0.1, "big": 10.0})
        seen = [ctl._tenant_cap_locked("tiny") < 1.0]
        admitted = ctl.admit_phase("t1", [_E("t1"), _E("t1")], 0,
                                   first_phase=True, tenant="tiny")
        seen += [len(admitted), ctl.stats()["pending"]]
        seen.append(_shed(lambda: ctl.admit_phase(
            "t2", [_E("t2")], 0, first_phase=True, tenant="tiny"))[0])
        drained = ctl.note_done(admitted[0])
        seen.append(len(drained))
        ctl.note_done(drained[0])
        seen.append(len(ctl.admit_phase("t3", [_E("t3")], 0,
                                        first_phase=True, tenant="tiny")))
        return seen

    assert _both(scenario) == [True, 1, 1, "shed", 1, 1]


def test_queue_drain_skips_overcap_tenant_and_repushes():
    """Under "queue", an over-share tenant's parked entities are
    skipped (not dropped) by the drain while another tenant's work
    behind them proceeds."""
    def scenario(cls):
        ctl = cls(max_inflight=4, policy="queue",
                  tenant_weights={"a": 1.0, "b": 1.0})
        got = ctl.admit_phase("qa", [_E("qa") for _ in range(4)], 0,
                              first_phase=True, tenant="a")
        st = ctl.stats()
        seen = [len(got), st["pending"], st["tenants"]["a"]["used_units"]]
        got_b = ctl.admit_phase("qb", [_E("qb")], 0, first_phase=True,
                                tenant="b")
        drained = ctl.note_done(got[0])
        seen += [len(got_b), len(drained), drained[0].query_id,
                 ctl.stats()["pending"]]
        ctl.drop_query("qa")
        ctl.drop_query("qb")
        st = ctl.stats()
        return seen + [(st["inflight"], st["pending"], st["reserved"]),
                       st["tenants"]["a"]["used_units"],
                       st["tenants"]["b"]["used_units"]]

    assert _both(scenario) == [2, 2, 2.0, 1, 1, "qa", 1, (0, 0, 0), 0.0,
                               0.0]


def test_admission_v2_knobs_validated():
    for cls in (AdmissionController, JaxController):
        for kw in (dict(tenant_weights={}), dict(tenant_weights={"a": 0.0}),
                   dict(cost_aware=True),             # no budget
                   dict(cost_cap_s=1.0)):             # budget unused
            with pytest.raises(ValueError):
                cls(max_inflight=4, policy="shed", **kw)
    before = set(threading.enumerate())
    with pytest.raises(ValueError):
        VDMSAsyncEngine(device="cpu", admission_tenants={"a": 1.0})
    with pytest.raises(ValueError):
        VDMSAsyncEngine(device="cpu", admission_cost_aware=True,
                        admission_cost_cap_s=1.0)
    assert set(threading.enumerate()) == before


def test_tenant_quota_end_to_end_over_engine():
    """submit(tenant=) threads through session → launch → controller,
    and the default empty tenant stays exempt."""
    eng = VDMSAsyncEngine(**dict(DET, transport=SLOW), admission="shed",
                          max_inflight_entities=8,
                          admission_tenants={"gold": 3.0, "bronze": 1.0})
    try:
        _fill(eng, n=4)
        q = _find(ops=REMOTE_FLIP)
        fut = eng.submit(q, tenant="bronze")
        time.sleep(0.05)
        with pytest.raises(OverloadError) as ei:
            eng.submit(q, tenant="bronze")
        assert ei.value.tenant == "bronze"
        gold = eng.submit(q, tenant="gold")
        assert len(gold.result(60)["entities"]) == 4
        assert len(fut.result(60)["entities"]) == 4
        assert len(eng.submit(q).result(60)["entities"]) == 4
        st = eng.admission_ctl.stats()
        assert st["tenants"]["bronze"]["used_units"] == 0.0
        assert st["tenants"]["gold"]["used_units"] == 0.0
    finally:
        eng.shutdown()


def test_frontend_close_joins_accept_thread():
    """close() shuts the listener down first, so the thread blocked in
    accept() wakes and is joined promptly."""
    eng = VDMSAsyncEngine(**DET)
    try:
        front = _serve(eng)
        time.sleep(0.05)          # let the accept loop block
        t0 = time.monotonic()
        front.close()
        took = time.monotonic() - t0
        assert not front._accept_thread.is_alive()
        assert took < 2.0, f"close() took {took:.1f}s (join timeout burn)"
    finally:
        eng.shutdown()


# ================================================ the codec, by property
SET = settings(max_examples=40, deadline=None,
               suppress_health_check=[HealthCheck.too_slow,
                                      HealthCheck.data_too_large])
wire_event_st = st.sampled_from(
    ["submitted", "entity", "complete", "overload", "error", "cancelled",
     "pong", "submit", "cancel", "ping"])
wire_scalar_st = st.one_of(
    st.none(), st.booleans(), st.integers(-2**31, 2**31),
    st.floats(allow_nan=False, allow_infinity=False, width=32),
    st.text(max_size=12))
# shapes of 0 to 3 dimensions: () is a 0-d array
wire_array_st = st.tuples(
    st.sampled_from(["uint8", "int32", "float32", "float64"]),
    st.lists(st.integers(1, 4), min_size=0, max_size=3),
    st.integers(0, 2**32 - 1),
    st.booleans(),
).map(lambda t: (lambda a: torch.from_numpy(a) if t[3] else a)(
    np.random.default_rng(t[2]).uniform(0, 255, t[1]).astype(t[0])))
wire_payload_st = st.dictionaries(
    st.text(alphabet="abcdefgh0123456789_", min_size=1, max_size=8),
    st.one_of(wire_scalar_st, wire_array_st,
              st.lists(wire_scalar_st, max_size=4)),
    max_size=5)
wire_frames_st = st.lists(st.tuples(wire_event_st, wire_payload_st),
                          min_size=0, max_size=8)


def _chunked(blob: bytes, cuts: list) -> list:
    """Split ``blob`` at the (deduped, sorted) cut offsets."""
    points = sorted({c % (len(blob) + 1) for c in cuts})
    out, prev = [], 0
    for p in points:
        out.append(blob[prev:p])
        prev = p
    out.append(blob[prev:])
    return out


@SET
@given(wire_frames_st, st.lists(st.integers(0, 10**9), max_size=20))
def test_wire_codec_roundtrips_under_any_chunking(frames, cuts):
    """encode -> concatenate -> split at arbitrary byte offsets ->
    incremental decode reproduces the exact frame sequence, 0-d arrays
    with their shape and tensors as host arrays."""
    blob = b"".join(encode_frame(e, to_jsonable(p)) for e, p in frames)
    decoder = FrameDecoder()
    got = []
    for chunk in _chunked(blob, cuts):
        got.extend(decoder.feed(chunk))
    assert len(got) == len(frames)
    for (we, wp), (ge, gp) in zip(frames, got):
        assert ge == we
        decoded = from_jsonable(gp)
        assert set(decoded) == set(wp)
        for k, v in wp.items():
            if isinstance(v, torch.Tensor):
                v = v.numpy()
            if isinstance(v, np.ndarray):
                assert decoded[k].dtype == v.dtype
                assert decoded[k].shape == v.shape
                assert np.array_equal(decoded[k], v)
            elif isinstance(v, float):
                assert decoded[k] == pytest.approx(v, nan_ok=True)
            else:
                assert decoded[k] == v


@pytest.mark.parametrize("value", [
    np.array(162, np.uint8), np.full((), 2.5, np.float32),
    np.arange(12, dtype=np.int32).reshape(3, 4)[:, ::2],
    np.asfortranarray(np.arange(6.0).reshape(2, 3))],
    ids=["0d-uint8", "0d-float32", "strided", "fortran"])
def test_wire_codec_departs_from_the_reference_only_at_0d(value):
    """The port codes what the reference codes, bit for bit, except a
    0-d array, which keeps its shape in the port and comes back 1-d
    from the reference; a tensor codes as its host array."""
    got, want = to_jsonable(value), jax_to_jsonable(value)
    assert from_jsonable(got).shape == value.shape
    assert np.array_equal(from_jsonable(got), value)
    if value.ndim:
        assert got == want
    else:
        assert want["shape"] == [1] and got["shape"] == []
        assert got["b64"] == want["b64"]
    assert to_jsonable(torch.from_numpy(value.copy(order="C"))) == got


_WIRE_REF: dict = {}


def _wire_reference():
    """One live port engine run, captured once: its streamed entity
    frames and its response."""
    if _WIRE_REF:
        return _WIRE_REF["frames"], _WIRE_REF["result"]
    eng = VDMSAsyncEngine(**DET)
    try:
        rng = np.random.default_rng(31)
        for _ in range(5):
            eng.add_entity("image",
                           rng.uniform(0, 255, (8, 8, 3)).astype(np.float32),
                           {"category": "wp"})
        frames = []

        def on_entity(ent):
            frames.append(("entity",
                           {"rid": "r", "eid": ent.eid,
                            "cmd_index": ent.cmd_index,
                            "failed": ent.failed,
                            "data": to_jsonable(ent.data)}))

        # two Find commands over the same set: reassembly must apply the
        # max-cmd_index-wins rule, not just collect by eid
        res = eng.submit(
            [{"FindImage": {"constraints": {"category": ["==", "wp"]},
                            "operations": [{"type": "grayscale"}]}},
             {"FindImage": {"constraints": {"category": ["==", "wp"]},
                            "operations": [{"type": "rotate", "k": 2}]}}],
            on_entity=on_entity).result(60)
        frames.append(("complete",
                       {"rid": "r", "eids": list(res["entities"]),
                        "stats": to_jsonable(res["stats"])}))
    finally:
        eng.shutdown()
    _WIRE_REF["frames"] = frames
    _WIRE_REF["result"] = res
    return frames, res


@SET
@given(st.integers(0, 2**32 - 1),
       st.lists(st.integers(0, 10**9), max_size=30))
def test_wire_reassembly_invariant_under_interleaving(shuffle_seed, cuts):
    """Any permutation + chunking of one query's streamed frames
    reassembles to the exact in-process response."""
    frames, want = _wire_reference()
    shuffled = list(frames)
    np.random.default_rng(shuffle_seed).shuffle(shuffled)
    blob = b"".join(encode_frame(e, p) for e, p in shuffled)
    decoder = FrameDecoder()
    got_frames = []
    for chunk in _chunked(blob, cuts):
        got_frames.extend(decoder.feed(chunk))
    got = reassemble(got_frames)
    _same_entities(got, want)
    assert got["stats"]["matched"] == want["stats"]["matched"]
    assert got["stats"]["failed"] == want["stats"]["failed"]


# ================================================ the network launcher
def test_serve_launcher_serves_a_cluster_on_the_cpu():
    """``python -m repro_torch.launch.serve --shards 4 --device cpu``
    serves the wire until interrupted."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--shards", "4",
         "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        m = re.search(r"on ([\d.]+):(\d+) .*shards=4, device=cpu", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None
                   else "")
        with WireClient((m.group(1), int(m.group(2)))) as c:
            assert c.ping()
            res = c.execute(_find(), timeout=30)
        assert res["entities"] == {} and res["stats"]["failed"] == 0
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


def test_serve_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.launch import serve
    before = set(threading.enumerate())
    for argv in (["--port", "0"], ["--shards", "4", "--port", "0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(argv)               # --device cuda by default
    assert set(threading.enumerate()) == before
