"""The port's sharded cluster held against the JAX package's, on the CPU
(``device="cpu"``): the scenarios of ``tests/test_cluster.py`` with its
seeds and parameters, built from the same numpy data for both packages.

Where the reference is deterministic the two are compared: the 1-shard
cluster is byte-identical to a plain port engine and to the JAX cluster,
the eids follow the same counter, 2- and 4-shard responses equal the
plain engine's and the JAX cluster's, and the ring places, rebalances
and migrates entities exactly as the reference's does.  Elsewhere
(failover, ``ShardLostError``, cancellation without admission leaks,
chaos storms) the port is held to the same behaviour.

Tolerance: exact.  The pipelines are crops, flips, rotations and
thresholds (index permutations and comparisons), so responses compare
byte for byte; ring placement and migration compare as equal lists.
"""
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest

from repro.cluster import HashRing as JaxRing
from repro.cluster import ShardedEngine as JaxCluster
from repro.core.remote import TransportModel as JaxTransport
from repro.distributed.elastic import migration_moves as jax_moves
from repro_torch.cluster import HashRing, ShardedEngine
from repro_torch.core.engine import VDMSAsyncEngine
from repro_torch.core.remote import TransportModel
from repro_torch.distributed.elastic import migration_moves
from repro_torch.distributed.fault import ShardLostError
from repro_torch.query.admission import OverloadError

FAST = dict(network_latency_s=0.001, service_time_s=0.002)
SLOW = TransportModel(network_latency_s=0.001, service_time_s=0.03)

PIPE = [
    {"type": "crop", "x": 2, "y": 2, "width": 12, "height": 12},
    {"type": "remote", "url": "u", "options": {"id": "flip"}},
    {"type": "rotate", "k": 1},
]


def _port(cls=ShardedEngine, **kw):
    kw.setdefault("transport", TransportModel(**FAST))
    return cls(device="cpu", **kw)


def _jax(**kw):
    kw.setdefault("transport", JaxTransport(**FAST))
    return JaxCluster(**kw)


def _fill(eng, n=10, size=16, category="cl", seed=11):
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        eng.add_entity("image", img, {"category": category, "idx": i})


def _find(category="cl", ops=PIPE, **extra):
    return [{"FindImage": {"constraints": {"category": ["==", category]},
                           "operations": ops, **extra}}]


def _strip(stats):
    return {k: v for k, v in stats.items() if k != "duration_s"}


def _assert_same_response(a, b):
    """Bit-for-bit apart from wall-clock: same eids in the same order,
    same bytes/shape/dtype per entity, same stats."""
    assert list(a["entities"]) == list(b["entities"])
    for eid in a["entities"]:
        x, y = np.asarray(a["entities"][eid]), np.asarray(b["entities"][eid])
        assert x.shape == y.shape and x.dtype == y.dtype
        assert x.tobytes() == y.tobytes()
    assert _strip(a["stats"]) == _strip(b["stats"])


def _shutdown(*engines):
    for eng in engines:
        eng.shutdown()


def _wait_drained(eng):
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        adm = eng.admission_stats().values()
        if all(a["inflight"] == 0 and a["pending"] == 0 for a in adm):
            break
        time.sleep(0.01)
    return eng.admission_stats()


def _placement(stats):
    return {sid: (v["owned"], v["held"]) for sid, v in
            stats["per_shard"].items()}


# ------------------------------------------------- cross-shard identity
def test_one_shard_cluster_is_byte_identical_to_plain_engine():
    plain = _port(VDMSAsyncEngine, num_remote_servers=2)
    clustered = _port(num_shards=1, num_remote_servers=2)
    ref = _jax(num_shards=1, num_remote_servers=2)
    try:
        for eng in (plain, clustered, ref):
            _fill(eng)
        for q in (_find(), _find(ops=[]), _find(limit=4)):
            got = clustered.execute(q, timeout=60)
            _assert_same_response(plain.execute(q, timeout=60), got)
            _assert_same_response(ref.execute(q, timeout=60), got)
    finally:
        _shutdown(plain, clustered, ref)


def test_cluster_eids_match_plain_engine_counter():
    # cluster-level id assignment reproduces the single store's
    # "{kind}-{n}" sequence, shared across kinds
    plain = _port(VDMSAsyncEngine)
    clustered = _port(num_shards=3)
    ref = _jax(num_shards=3)
    try:
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
        for kind in ("image", "video", "image"):
            eid = clustered.add_entity(kind, img, {})
            assert eid == plain.add_entity(kind, img, {})
            assert eid == ref.add_entity(kind, img, {})
        assert _placement(clustered.cluster_stats()) == \
            _placement(ref.cluster_stats())
    finally:
        _shutdown(plain, clustered, ref)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_multi_shard_response_matches_plain_engine(num_shards):
    # assembly is (command order x sorted-eid order) regardless of which
    # shard finishes first, so the scatter must be invisible in results
    plain = _port(VDMSAsyncEngine, num_remote_servers=2)
    clustered = _port(num_shards=num_shards, num_remote_servers=2)
    ref = _jax(num_shards=num_shards, num_remote_servers=2)
    try:
        for eng in (plain, clustered, ref):
            _fill(eng, n=14)
        for q in (_find(), _find(limit=5)):
            got = clustered.execute(q, timeout=60)
            _assert_same_response(plain.execute(q, timeout=60), got)
            _assert_same_response(ref.execute(q, timeout=60), got)
        assert _placement(clustered.cluster_stats()) == \
            _placement(ref.cluster_stats())
    finally:
        _shutdown(plain, clustered, ref)


def test_replicated_cluster_results_unchanged():
    # replica_factor is a durability knob, not a semantics knob
    a = _port(num_shards=3, replica_factor=1)
    b = _port(num_shards=3, replica_factor=2)
    ref = _jax(num_shards=3, replica_factor=2)
    try:
        for eng in (a, b, ref):
            _fill(eng)
        got = b.execute(_find(), timeout=60)
        _assert_same_response(a.execute(_find(), timeout=60), got)
        _assert_same_response(ref.execute(_find(), timeout=60), got)
        held = sum(v["held"] for v in
                   b.cluster_stats()["per_shard"].values())
        assert held == 2 * 10       # every entity stored on two shards
        assert _placement(b.cluster_stats()) == \
            _placement(ref.cluster_stats())
    finally:
        _shutdown(a, b, ref)


# ------------------------------------------------ scatter/gather order
def test_streaming_gather_dedupes_and_covers_every_entity():
    eng = _port(num_shards=3, replica_factor=2)
    try:
        _fill(eng, n=12)
        seen = []
        lock = threading.Lock()

        def on_entity(ent):
            with lock:
                seen.append(ent.eid)
        res = eng.submit(_find(), on_entity=on_entity).result(timeout=60)
        assert sorted(seen) == sorted(res["entities"])   # once each,
        assert len(seen) == len(set(seen))               # despite replicas
    finally:
        eng.shutdown()


def test_mixed_add_find_barrier_across_shards():
    # the Add is a barrier: the Find phase scatters only after every
    # replica holder ingested, so it must match the new entity
    eng = _port(num_shards=3, replica_factor=2)
    ref = _jax(num_shards=3, replica_factor=2)
    plain = _port(VDMSAsyncEngine)
    try:
        img = np.full((16, 16, 3), 0.25, np.float32)
        q = [{"AddImage": {"properties": {"category": "cl", "idx": 99},
                           "data": img}},
             {"FindImage": {"constraints": {"category": ["==", "cl"]}}}]
        for e in (eng, ref, plain):
            _fill(e, n=6)
        res = eng.execute(q, timeout=60)
        assert len(res["entities"]) == 7
        assert res["stats"]["matched"] == 7
        new_eid = [e for e in res["entities"] if e.endswith("-6")][0]
        np.testing.assert_array_equal(res["entities"][new_eid], img)
        # the plain engine and the JAX cluster agree bit-for-bit
        _assert_same_response(plain.execute(q, timeout=60), res)
        _assert_same_response(ref.execute(q, timeout=60), res)
    finally:
        _shutdown(eng, ref, plain)


def test_add_with_operations_processes_on_every_replica():
    # an Add pipeline runs per copy; deterministic ops keep the copies
    # identical, and the response carries the processed data
    eng = _port(num_shards=3, replica_factor=2)
    ref = _jax(num_shards=3, replica_factor=2)
    try:
        img = np.full((8, 8, 3), 2.0, np.float32)
        q = [{"AddImage": {"properties": {"category": "cl"}, "data": img,
                           "operations": [{"type": "threshold",
                                           "value": 0.5}]}}]
        res = eng.execute(q, timeout=60)
        (eid, out), = res["entities"].items()
        np.testing.assert_array_equal(out, np.ones_like(img))
        holders = [s for s in eng.live_shards() if eid in eng.shards[s].store]
        assert len(holders) == 2
        for s in holders:
            stored = eng.shards[s].store.get(eid)
            assert isinstance(stored, np.ndarray)    # host arrays
            np.testing.assert_array_equal(stored, np.ones_like(img))
        ref.execute(q, timeout=60)
        assert holders == [s for s in ref.live_shards()
                           if eid in ref.shards[s].store]
    finally:
        _shutdown(eng, ref)


# --------------------------------------- cancellation / timeout drops
def test_cancel_drops_work_on_every_shard_without_admission_leaks():
    eng = _port(num_shards=3, num_remote_servers=1, transport=SLOW,
                admission="queue", max_inflight_entities=4)
    try:
        _fill(eng, n=12)
        fut = eng.submit(_find())
        time.sleep(0.05)              # let the scatter reach the shards
        assert fut.cancel()
        assert fut.cancelled()
        with pytest.raises(CancelledError):
            fut.result(timeout=5)
        for sid, a in _wait_drained(eng).items():
            assert a["inflight"] == 0 and a["pending"] == 0, (sid, a)
            assert a["peak_inflight"] <= 4
    finally:
        eng.shutdown()


def test_execute_timeout_cancels_across_shards():
    eng = _port(num_shards=3, num_remote_servers=1, transport=SLOW,
                admission="queue", max_inflight_entities=4)
    try:
        _fill(eng, n=12)
        with pytest.raises(TimeoutError):
            eng.execute(_find(), timeout=0.05)
        for sid, a in _wait_drained(eng).items():
            assert a["inflight"] == 0 and a["pending"] == 0, (sid, a)
    finally:
        eng.shutdown()


def test_shed_shard_overload_propagates_to_submit():
    # admission back-pressure is NOT ill health: no failover, the typed
    # OverloadError surfaces from submit() exactly like a plain engine
    eng = _port(num_shards=2, num_remote_servers=1, transport=SLOW,
                admission="shed", max_inflight_entities=2)
    try:
        _fill(eng, n=12)
        with pytest.raises(OverloadError) as ei:
            for _ in range(6):
                eng.submit(_find())
        assert ei.value.retry_after_s >= 0
        assert eng.cluster_stats()["failovers_total"] == 0
    finally:
        eng.shutdown()


# ----------------------------------------------------- replica failover
def test_kill_shard_mid_query_redrives_on_replicas():
    eng = _port(num_shards=3, replica_factor=2, num_remote_servers=1,
                transport=SLOW)
    plain = _port(VDMSAsyncEngine)
    try:
        _fill(eng, n=12)
        _fill(plain, n=12)
        fut = eng.submit(_find())
        time.sleep(0.02)
        eng.kill_shard(1)
        res = fut.result(timeout=60)
        assert len(res["entities"]) == 12
        assert res["stats"]["failed"] == 0
        st = eng.cluster_stats()
        assert st["live_shards"] == [0, 2]
        assert st["failovers_total"] >= 1
        assert st["failovers"].get(1, 0) >= 1
        # the failover answers exactly what an unbroken engine answers
        _assert_same_response(plain.execute(_find(), timeout=60), res)
        # and later queries keep working against the survivors
        res2 = eng.execute(_find(), timeout=60)
        assert len(res2["entities"]) == 12
        assert res2["stats"]["failed"] == 0
    finally:
        _shutdown(eng, plain)


def test_shard_loss_without_replicas_fails_loudly():
    eng = _port(num_shards=2, replica_factor=1, num_remote_servers=1,
                transport=SLOW)
    try:
        _fill(eng, n=8)
        fut = eng.submit(_find())
        time.sleep(0.02)
        eng.kill_shard(0)
        with pytest.raises(ShardLostError):
            fut.result(timeout=60)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("seed", range(10))
def test_chaos_storm_kill_one_shard_completes_every_query(seed):
    """The seeded kill-a-shard storm: at replica_factor=2 every future
    resolves, zero failed entities, failover counted in cluster_stats."""
    rng = np.random.default_rng(seed)
    n_images, n_queries = 8, 3
    eng = _port(num_shards=3, replica_factor=2, num_remote_servers=1,
                transport=TransportModel(network_latency_s=0.001,
                                         service_time_s=0.015))
    try:
        _fill(eng, n=n_images, seed=seed)
        futs = [eng.submit(_find()) for _ in range(n_queries)]
        time.sleep(float(rng.uniform(0.005, 0.04)))
        victim = int(rng.integers(0, 3))
        eng.kill_shard(victim)
        for fut in futs:
            res = fut.result(timeout=120)
            assert len(res["entities"]) == n_images
            assert res["stats"]["failed"] == 0
        st = eng.cluster_stats()
        assert st["failovers_total"] >= 1
        assert victim not in st["live_shards"]
    finally:
        eng.shutdown()


# -------------------------------------------------- rebalance migration
def test_shard_join_and_leave_preserve_results_and_move_minimally():
    eng = _port(num_shards=2, replica_factor=2, virtual_nodes=64)
    ref = _jax(num_shards=2, replica_factor=2, virtual_nodes=64)
    try:
        _fill(eng, n=24)
        _fill(ref, n=24)
        q = _find(ops=[])
        base = eng.execute(q, timeout=60)
        assert len(base["entities"]) == 24
        before = eng.cluster_stats()

        sid = eng.add_shard()
        assert ref.add_shard() == sid
        after_join = eng.cluster_stats()
        assert sid in after_join["live_shards"]
        _assert_same_response(base, eng.execute(q, timeout=60))
        # the join moved only the new shard's ranges: the copies it
        # received, bounded well below a full reshuffle of 2x24 copies
        moved = after_join["moved_entities"] - before["moved_entities"]
        assert 0 < moved <= eng.shards[sid].meta.count() + 24
        held = sum(v["held"] for v in after_join["per_shard"].values())
        assert held == 2 * 24       # replica invariant survives the join
        # the same copies moved to the same shards as in the reference
        ref_join = ref.cluster_stats()
        assert after_join["moved_entities"] == ref_join["moved_entities"]
        assert _placement(after_join) == _placement(ref_join)

        eng.remove_shard(0)
        ref.remove_shard(0)
        after_leave = eng.cluster_stats()
        assert 0 not in after_leave["live_shards"]
        _assert_same_response(base, eng.execute(q, timeout=60))
        _assert_same_response(ref.execute(q, timeout=60), base)
        held = sum(v["held"] for v in after_leave["per_shard"].values())
        assert held == 2 * 24
        ref_leave = ref.cluster_stats()
        assert after_leave["moved_entities"] == ref_leave["moved_entities"]
        assert _placement(after_leave) == _placement(ref_leave)
        for s in after_leave["live_shards"]:     # the same holders' data
            for eid in eng.shards[s].meta.find_ids("image", {}):
                assert eng.shards[s].meta.get(eid) == \
                    ref.shards[s].meta.get(eid)
    finally:
        _shutdown(eng, ref)


def test_cluster_stats_shapes():
    eng = _port(num_shards=4, replica_factor=2, virtual_nodes=128)
    ref = _jax(num_shards=4, replica_factor=2, virtual_nodes=128)
    try:
        _fill(eng, n=40)
        _fill(ref, n=40)
        st = eng.cluster_stats()
        assert st["num_shards"] == 4 and st["replica_factor"] == 2
        assert st["entities"] == 40
        assert sum(v["owned"] for v in st["per_shard"].values()) == 40
        assert st["imbalance"] >= 1.0
        assert set(st["breakers"]) == {f"shard:{i}" for i in range(4)}
        want = ref.cluster_stats()
        assert set(st) == set(want)
        for key in ("per_shard", "imbalance", "live_shards", "entities",
                    "failovers", "moved_entities"):
            assert st[key] == want[key], key
    finally:
        _shutdown(eng, ref)


def test_constructor_validation():
    with pytest.raises(ValueError):
        ShardedEngine(num_shards=0, device="cpu")
    with pytest.raises(ValueError):
        ShardedEngine(num_shards=2, replica_factor=3, device="cpu")
    with pytest.raises(ValueError):
        ShardedEngine(num_shards=2, replica_factor=0, device="cpu")
    with pytest.raises(ValueError):
        ShardedEngine(num_shards=2, virtual_nodes=0, device="cpu")
    eng = ShardedEngine(num_shards=2, device="cpu")
    eng.shutdown()
    with pytest.raises(RuntimeError):
        eng.submit(_find())
    with pytest.raises(RuntimeError):
        eng.add_entity("image", np.zeros((2, 2, 3)), {})


# ------------------------------------------------- ring and migration
KEYS = [f"image-{i}" for i in range(3000)] + [f"video-{i}" for i in range(500)]


@pytest.mark.parametrize("shards,vnodes", [(1, 64), (3, 64), (4, 192),
                                           (7, 16)])
def test_ring_places_every_key_as_the_reference(shards, vnodes):
    port, ref = HashRing(range(shards), virtual_nodes=vnodes), \
        JaxRing(range(shards), virtual_nodes=vnodes)
    for n in (1, 2, shards):
        assert [port.owners(k, n) for k in KEYS] == \
            [ref.owners(k, n) for k in KEYS]
        assert port.ownership(KEYS, n) == ref.ownership(KEYS, n)
    assert port.owner(KEYS[0]) == ref.owner(KEYS[0])
    assert port.shard_count() == ref.num_shards() == shards
    assert port.stats() == ref.stats()


@pytest.mark.parametrize("change", ["join", "leave", "swap"])
@pytest.mark.parametrize("rf", [1, 2])
def test_rebalance_deltas_and_moves_match_the_reference(change, rf):
    kw = {"join": dict(add=4), "leave": dict(remove=1),
          "swap": dict(add=4, remove=0)}[change]
    port, ref = HashRing(range(4), virtual_nodes=64), \
        JaxRing(range(4), virtual_nodes=64)
    d_port, d_ref = port.rebalance(**kw), ref.rebalance(**kw)
    for k in KEYS[:1000]:
        assert d_port.old_owners(k, rf) == d_ref.old_owners(k, rf)
        assert d_port.new_owners(k, rf) == d_ref.new_owners(k, rf)
    got = list(migration_moves(KEYS, lambda k: d_port.old_owners(k, rf),
                               lambda k: d_port.new_owners(k, rf)))
    want = list(jax_moves(KEYS, lambda k: d_ref.old_owners(k, rf),
                          lambda k: d_ref.new_owners(k, rf)))
    assert [(m.key, m.copy_to, m.drop_from, m.old_primary, m.new_primary,
             m.primary_changed) for m in got] == \
        [(m.key, m.copy_to, m.drop_from, m.old_primary, m.new_primary,
          m.primary_changed) for m in want]
    assert 0 < len(got) < len(KEYS)        # a delta, never a reshuffle
    assert port.shards() == ref.shards()


def test_sharded_engine_refuses_cuda_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEngine(num_shards=2)            # device="cuda" by default
    assert set(threading.enumerate()) == before
