"""The port's result cache held against ``tests/test_result_cache.py``:
full and prefix hits, Add-barrier invalidation, sessions sharing the
cache, and the byte identity of the cache-off engine.  The cache keys
(``prefix_signatures``) equal the reference's, and the cache-off and
resumed responses equal the reference engine's byte for byte.

The port's ``ResultCache.longest_cached_prefix`` is the reference's
``longest_prefix`` and ``MetadataStore.find_ids`` its ``find``
(``repro_torch/__init__.py``)."""
import threading

import numpy as np
import torch

from repro.core.pipeline import make_op as ref_make_op
from repro.core.result_cache import prefix_signatures as ref_prefix_signatures
from repro_torch.core.pipeline import make_op
from repro_torch.core.result_cache import (ResultCache, pipeline_signature,
                                           prefix_signatures)
from torch_parity import (add_images, assert_same, find, port_engine,
                          ref_engine, run)

torch.set_num_threads(1)

NATIVE_PIPE = [
    {"type": "resize", "width": 24, "height": 24},
    {"type": "grayscale"},
]

REMOTE_PIPE = [
    {"type": "resize", "width": 24, "height": 24},
    {"type": "remote", "url": "http://s/box", "options": {"id": "facedetect_box"}},
    {"type": "threshold", "value": 0.4},
]


def _add(eng, n=8, size=32, category="lfw"):
    """``tests/test_result_cache.py::_add_images``."""
    return add_images(eng, n, size, category, seed=0)


def _find(category="lfw", ops=NATIVE_PIPE):
    return find(category, ops)


def _execute(n, ops):
    def scenario(e):
        _add(e, n)
        return e.execute(_find(ops=ops), timeout=60)
    return scenario


# ----------------------------------------------------------------- unit
def test_lru_is_bounded_and_evicts_oldest():
    rc = ResultCache(capacity=4)
    for i in range(10):
        rc.put(f"e{i}", "sig", i)
    assert len(rc) == 4
    assert rc.evictions == 6
    assert rc.get("e0", "sig") == (False, None)
    assert rc.get("e9", "sig") == (True, 9)


def test_byte_capacity_bounds_large_values():
    rc = ResultCache(capacity=64, capacity_bytes=4 * 1024)
    for i in range(8):
        rc.put(f"e{i}", "sig", torch.zeros(256))   # 1 KiB each
    assert rc.stats()["bytes"] <= 4 * 1024
    assert len(rc) == 4 and rc.evictions == 4
    # a value larger than the whole budget is not retained
    rc.put("huge", "sig", torch.zeros(4096))
    assert rc.get("huge", "sig") == (False, None)


def test_stale_epoch_put_is_refused():
    rc = ResultCache(capacity=8)
    e0 = rc.epoch("e")
    rc.invalidate("e")                       # concurrent Add write-back
    rc.put("e", "sig", 1, epoch=e0)          # computed from the old blob
    assert rc.get("e", "sig") == (False, None)
    assert rc.stats()["stale_puts"] == 1
    rc.put("e", "sig", 2, epoch=rc.epoch("e"))
    assert rc.get("e", "sig") == (True, 2)


def test_cached_arrays_are_isolated_from_client_mutation():
    # the port caches tensors and hands out clones (the reference hands
    # out read-only views of its own copy); a host array is copied in
    # and read-only as in the reference
    rc = ResultCache(capacity=8)
    mine = torch.ones(4, 4)
    rc.put("e", "sig", mine)
    mine.mul_(0)                             # the populating client's copy
    _, cached = rc.get("e", "sig")
    torch.testing.assert_close(cached, torch.ones(4, 4))
    cached.zero_()                           # a warm hit scribbles on its
    _, again = rc.get("e", "sig")            # clone, not on the cache
    torch.testing.assert_close(again, torch.ones(4, 4))
    host = np.ones((4, 4), np.float32)
    rc.put("h", "sig", host)
    host *= 0
    _, cached = rc.get("h", "sig")
    np.testing.assert_array_equal(cached, np.ones((4, 4), np.float32))
    assert not cached.flags.writeable


def test_invalidate_drops_every_signature_of_an_eid():
    rc = ResultCache(capacity=16)
    rc.put("e", "s1", 1)
    rc.put("e", "s2", 2)
    rc.put("f", "s1", 3)
    assert rc.invalidate("e") == 2
    assert rc.get("e", "s1") == (False, None)
    assert rc.get("e", "s2") == (False, None)
    assert rc.get("f", "s1") == (True, 3)      # other eids untouched
    assert rc.invalidate("missing") == 0


def test_prefix_signatures_are_canonical_and_incremental():
    ops_a = [make_op("resize", {"width": 24, "height": 24}),
             make_op("grayscale")]
    ops_b = [make_op("resize", {"height": 24, "width": 24}),
             make_op("grayscale"), make_op("threshold", {"value": 0.5})]
    sa, sb = prefix_signatures(ops_a), prefix_signatures(ops_b)
    assert sa == sb[:2]                        # shared prefix, param order
    assert sb[2] != sb[1]
    assert pipeline_signature(ops_a) == sa[-1]
    # the same keys as the reference's cache
    assert sb == ref_prefix_signatures([
        ref_make_op("resize", {"width": 24, "height": 24}),
        ref_make_op("grayscale"), ref_make_op("threshold", {"value": 0.5})])


def test_longest_prefix_prefers_longer_and_counts():
    sigs = prefix_signatures([make_op("resize"), make_op("grayscale"),
                              make_op("threshold")])
    rc = ResultCache(capacity=16)
    assert rc.longest_cached_prefix("e", sigs) == (0, None)
    rc.put("e", sigs[0], "after1")
    rc.put("e", sigs[1], "after2")
    assert rc.longest_cached_prefix("e", sigs) == (2, "after2")
    rc.put("e", sigs[2], "after3")
    assert rc.longest_cached_prefix("e", sigs) == (3, "after3")
    assert (rc.hits, rc.prefix_hits, rc.misses) == (1, 1, 1)


# ------------------------------------------------------------ full hits
def test_repeat_query_full_hits_skip_queue1():
    eng = port_engine(cache_capacity=256)
    try:
        _add(eng, 8)
        r1 = eng.execute(_find(), timeout=60)
        assert r1["stats"]["cache_full_hits"] == 0
        intervals_before = eng.loop.t2_meter.total_intervals
        r2 = eng.execute(_find(), timeout=60)
        assert r2["stats"]["cache_full_hits"] == 8
        # no native work ran for the warm query: full hits never enqueue
        assert eng.loop.t2_meter.total_intervals == intervals_before
        assert_same(r2, r1)
        assert eng.cache_stats()["hits"] == 8
    finally:
        eng.shutdown()


def test_remote_pipeline_hits_avoid_remote_dispatch():
    eng = port_engine(cache_capacity=256)
    try:
        _add(eng, 6)
        eng.execute(_find(ops=REMOTE_PIPE), timeout=60)
        dispatched = eng.pool.dispatched
        r2 = eng.execute(_find(ops=REMOTE_PIPE), timeout=60)
        assert r2["stats"]["cache_full_hits"] == 6
        assert eng.pool.dispatched == dispatched, \
            "warm query should not touch the remote pool"
    finally:
        eng.shutdown()


# --------------------------------------------------------- prefix resume
def test_prefix_hit_resumes_at_first_uncached_op():
    ref = run(port_engine, _execute(6, REMOTE_PIPE))   # cache off
    eng = port_engine(cache_capacity=256)
    try:
        _add(eng, 6)
        eng.execute(_find(ops=REMOTE_PIPE[:2]), timeout=60)  # caches prefix
        dispatched = eng.pool.dispatched
        r = eng.execute(_find(ops=REMOTE_PIPE), timeout=60)
        assert r["stats"]["cache_prefix_hits"] == 6
        assert r["stats"]["cache_full_hits"] == 0
        # resumed AFTER the remote op: only the native threshold ran
        assert eng.pool.dispatched == dispatched
        assert eng.cache_stats()["prefix_hits"] == 6
    finally:
        eng.shutdown()
    assert_same(r, ref)
    assert_same(r, run(ref_engine, _execute(6, REMOTE_PIPE)))


# ----------------------------------------------------------- invalidation
def test_add_barrier_invalidation_write_then_read():
    eng = port_engine(cache_capacity=256)
    try:
        img = np.random.default_rng(3).uniform(0, 1, (30, 30, 3)).astype(
            np.float32)
        q = [{"AddImage": {"properties": {"category": "w"}, "data": img,
                           "operations": [{"type": "resize", "width": 10,
                                           "height": 10}]}},
             {"FindImage": {"constraints": {"category": ["==", "w"]},
                            "operations": [{"type": "grayscale"}]}}]
        r1 = eng.execute(q, timeout=60)
        assert r1["stats"]["matched"] == 1
        r2 = eng.execute(q, timeout=60)
        assert r2["stats"]["matched"] == 2
        for arr in r2["entities"].values():
            assert np.asarray(arr).shape == (10, 10, 3)
        r3 = eng.execute(q, timeout=60)
        assert r3["stats"]["matched"] == 3
        assert r3["stats"]["cache_full_hits"] == 2
    finally:
        eng.shutdown()


def test_ingest_and_write_back_invalidate_cached_eids():
    eng = port_engine(cache_capacity=256)
    try:
        _add(eng, 2)
        eng.execute(_find(), timeout=60)
        eids = list(eng.meta.find_ids("image"))
        assert all(len(eng.result_cache._by_eid.get(e, ())) for e in eids)
        eng.result_cache.put(eids[0], "stale-sig", "stale")
        eng.planner.ingest("image", np.zeros((4, 4, 3), np.float32), {})

        class _E:  # minimal stand-in carrying eid + data
            eid, data = eids[0], torch.zeros(4, 4, 3)
        eng._store_result(_E())
        assert eng.result_cache.get(eids[0], "stale-sig") == (False, None)
    finally:
        eng.shutdown()


# ------------------------------------------------------- shared sessions
def test_concurrent_sessions_share_the_cache():
    eng = port_engine(cache_capacity=1024)
    try:
        _add(eng, 12)
        ref = eng.execute(_find(ops=REMOTE_PIPE), timeout=60)
        futs = []
        lock = threading.Lock()

        def client():
            f = eng.submit(_find(ops=REMOTE_PIPE))
            with lock:
                futs.append(f)

        threads = [threading.Thread(target=client) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in futs:
            r = f.result(timeout=120)
            assert r["stats"]["cache_full_hits"] == 12
            assert_same(r, ref)
        assert eng.cache_stats()["hits"] >= 6 * 12
    finally:
        eng.shutdown()


def test_concurrent_cold_sessions_race_safely():
    ref = run(ref_engine, _execute(10, REMOTE_PIPE))
    eng = port_engine(cache_capacity=1024, num_remote_servers=4)
    try:
        _add(eng, 10)
        futs = [eng.submit(_find(ops=REMOTE_PIPE)) for _ in range(4)]
        for f in futs:
            assert_same(f.result(timeout=120), ref)
    finally:
        eng.shutdown()


# ------------------------------------------------------ baseline identity
def test_cache_off_single_worker_reproduces_baseline_bytes():
    eng_base = port_engine(num_native_workers=1)          # cache off default
    eng_cache = port_engine(cache_capacity=256)
    try:
        _add(eng_base, 10)
        _add(eng_cache, 10)
        q = _find(ops=REMOTE_PIPE)
        base1 = eng_base.execute(q, timeout=60)
        base2 = eng_base.execute(q, timeout=60)
        warm = [eng_cache.execute(q, timeout=60) for _ in range(2)][-1]
        assert_same(base1, base2)
        assert_same(warm, base1)
        assert set(base1["stats"]) == {"matched", "failed", "duration_s"}
        assert eng_base.result_cache is None
        assert eng_base.cache_stats() == {}
    finally:
        eng_base.shutdown()
        eng_cache.shutdown()
    # the reference's single-worker cache-off engine: the same bytes
    want = run(lambda: ref_engine(num_native_workers=1),
               _execute(10, REMOTE_PIPE))
    assert set(want["stats"]) == set(base1["stats"])
    assert_same(base1, want)


def test_per_query_cache_false_bypasses_reads_and_writes():
    eng = port_engine(cache_capacity=256)
    try:
        _add(eng, 4)
        eng.execute(_find(), timeout=60)                   # populate
        puts = eng.cache_stats()["puts"]
        r = eng.execute(_find(), timeout=60, cache=False)
        assert r["stats"]["cache_full_hits"] == 0
        assert eng.cache_stats()["puts"] == puts, \
            "cache=False query must not write the cache"
        r2 = eng.execute(_find(), timeout=60)              # cache still warm
        assert r2["stats"]["cache_full_hits"] == 4
    finally:
        eng.shutdown()
