#!/usr/bin/env python3
"""Hot-query-path benchmarks on the PyTorch port: the result cache and
cross-session coalescing.

``python3 benchmarks/torch_hotpath.py [--device cuda|cpu]
[--smoke|--full] [--check-baseline]`` from the root of a checkout.  The
port's counterpart of ``benchmarks/hotpath.py``, with its workloads,
functions, row names and keys:

- ``run_cache``: resize → remote facedetect_box → threshold, a cold run
  that fills the cache and a warm run of full hits; ``derived`` is cold
  wall over warm wall.  ``cold_misses`` / ``warm_hits`` split the
  engine-lifetime hit rate (0.5 by construction), and both responses
  must equal the cache-off engine's (``identical_to_cache_off``);
- ``run_coalesce``: the same pipeline from concurrent sessions over a
  30 ms transport, per-entity requests against coalesced batches
  (``TransportModel.cost_batch``); ``derived`` is per-entity wall over
  coalesced wall, and the responses must be identical
  (``identical_to_per_entity``).

``--check-baseline`` exits 2 unless both responses match their
baselines (the reference's ``baseline_identical``).  The payload goes
with the card's name and power limit to ``chiprun_out/torch_hotpath.json``.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402

from benchmarks.torch_common import (bench_args, entities_equal,  # noqa: E402
                                     finish, write_payload)
from repro_torch.core.engine import VDMSAsyncEngine  # noqa: E402
from repro_torch.core.remote import TransportModel  # noqa: E402

REMOTE_PIPE = [
    {"type": "resize", "width": 48, "height": 48},
    {"type": "remote", "url": "http://svc/box",
     "options": {"id": "facedetect_box"}},
    {"type": "threshold", "value": 0.4},
]


def _find(category="hot", ops=REMOTE_PIPE):
    return [{"FindImage": {"constraints": {"category": ["==", category]},
                           "operations": ops}}]


def _fill(eng, n, size, category="hot"):
    rng = np.random.default_rng(7)
    for i in range(n):
        img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        eng.add_entity("image", img, {"category": category, "idx": i})


def run_cache(n_images=32, size=64, *, device="cuda"):
    """Repeated-pipeline workload: cold populate against a warm run of
    full hits, each against the cache-off engine's response."""
    transport = TransportModel(network_latency_s=0.002, service_time_s=0.004)

    # reference: the engine exactly as it ships by default (cache off)
    ref_eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                              transport=transport)
    try:
        _fill(ref_eng, n_images, size)
        ref_eng.execute(_find(), timeout=600)          # warm-up
        t0 = time.monotonic()
        ref = ref_eng.execute(_find(), timeout=600)
        t_off = time.monotonic() - t0
    finally:
        ref_eng.shutdown()

    eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                          transport=transport,
                          cache_capacity=4 * n_images + 64)
    try:
        _fill(eng, n_images, size)
        eng.execute(_find(), cache=False, timeout=600)  # warm-up, no writes
        t0 = time.monotonic()
        cold = eng.execute(_find(), timeout=600)        # populates
        t_cold = time.monotonic() - t0
        stats_cold = eng.cache_stats()
        t0 = time.monotonic()
        warm = eng.execute(_find(), timeout=600)        # full hits
        t_warm = time.monotonic() - t0
        stats = eng.cache_stats()
    finally:
        eng.shutdown()
    warm_hits = stats["hits"] - stats_cold["hits"]
    warm_lookups = ((stats["hits"] + stats["prefix_hits"] + stats["misses"])
                    - (stats_cold["hits"] + stats_cold["prefix_hits"]
                       + stats_cold["misses"]))
    identical = (entities_equal(ref["entities"], cold["entities"])
                 and entities_equal(ref["entities"], warm["entities"]))
    return [{
        "name": "hotpath_cache_repeat",
        "us_per_call": t_warm / n_images * 1e6,
        "derived": t_cold / t_warm,
        "n_images": n_images,
        "cold_s": t_cold,
        "warm_s": t_warm,
        "cache_off_s": t_off,
        "entities_per_s_warm": n_images / t_warm,
        "full_hits": warm["stats"].get("cache_full_hits", 0),
        # engine-lifetime rate: 0.5 by construction; the split below is
        # the signal
        "hit_rate": stats["hit_rate"],
        "cold_misses": stats_cold["misses"],
        "warm_hits": warm_hits,
        "warm_hit_rate": (warm_hits / warm_lookups if warm_lookups else 0.0),
        "identical_to_cache_off": identical,
    }]


def run_coalesce(fanout=32, sessions=2, size=48, *, device="cuda"):
    """Per-entity remote dispatch against cross-session coalescing at a
    fan-out of ``sessions * fanout`` remote ops, transport-bound (30 ms
    round trips); ``coalesce_max_batch`` 16 keeps batches spread over
    the servers."""
    transport = TransportModel(network_latency_s=0.03,
                               service_time_s=0.0003)

    def wall(**kw):
        eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                              transport=transport,
                              dispatch_policy="least_loaded", **kw)
        try:
            _fill(eng, fanout, size)
            eng.execute(_find(), timeout=600)          # warm-up
            t0 = time.monotonic()
            futs = [eng.submit(_find()) for _ in range(sessions)]
            results = [f.result(timeout=600) for f in futs]
            dt = time.monotonic() - t0
            assert all(r["stats"]["failed"] == 0 for r in results)
            return dt, results[0]["entities"], eng.utilization()
        finally:
            eng.shutdown()

    t_per, ents_per, util_per = wall()
    t_co, ents_co, util_co = wall(coalesce_window_ms=5.0,
                                  coalesce_max_batch=16)
    return [{
        "name": f"hotpath_coalesce_f{fanout}x{sessions}",
        "us_per_call": t_co / (fanout * sessions) * 1e6,
        "derived": t_per / t_co,
        "fanout": fanout,
        "sessions": sessions,
        "per_entity_s": t_per,
        "coalesced_s": t_co,
        "entities_per_s_coalesced": fanout * sessions / t_co,
        "requests_per_entity": util_per["remote_dispatched"],
        "requests_coalesced": util_co["remote_dispatched"],
        "coalesced_batches": util_co["coalesced_batches"],
        "coalesced_entities": util_co["coalesced_entities"],
        "identical_to_per_entity": entities_equal(ents_per, ents_co),
    }]


def run(smoke=True, device="cuda", report=True):
    """Both suites; writes ``chiprun_out/torch_hotpath.json``."""
    if smoke:
        rows = (run_cache(n_images=24, size=48, device=device)
                + run_coalesce(fanout=32, device=device))
    else:
        rows = (run_cache(n_images=64, size=96, device=device)
                + run_coalesce(fanout=64, sessions=4, device=device))
    cache_row, co_row = rows
    if report:
        write_payload("hotpath", {
            "smoke": smoke,
            "cache_speedup": cache_row["derived"],
            "coalesce_speedup": co_row["derived"],
            "entities_per_s_warm": cache_row["entities_per_s_warm"],
            "entities_per_s_coalesced": co_row["entities_per_s_coalesced"],
            "baseline_identical": (cache_row["identical_to_cache_off"]
                                   and co_row["identical_to_per_entity"]),
            "rows": rows,
        }, device)
    return rows


def gates(rows) -> list[str]:
    """The responses against their baselines: the cache-off engine's and
    the per-entity dispatch's."""
    cache_row = next(r for r in rows if r["name"] == "hotpath_cache_repeat")
    co_row = next(r for r in rows if r["name"].startswith("hotpath_coalesce"))
    failures = []
    if not cache_row["identical_to_cache_off"]:
        failures.append("cache-on responses differ from the cache-off "
                        "engine's")
    if not co_row["identical_to_per_entity"]:
        failures.append("coalesced responses differ from per-entity "
                        "dispatch's")
    return failures


def headline(rows) -> list[str]:
    c, co = rows
    return [
        f"{c['name']}: cold {c['cold_s']:.4f} s, warm {c['warm_s']:.4f} s "
        f"({c['derived']:.3f}); cold misses {c['cold_misses']}, warm hits "
        f"{c['warm_hits']}; identical {c['identical_to_cache_off']}",
        f"{co['name']}: per entity {co['per_entity_s']:.4f} s, coalesced "
        f"{co['coalesced_s']:.4f} s ({co['derived']:.3f}); requests "
        f"{co['requests_per_entity']} -> {co['requests_coalesced']}; "
        f"identical {co['identical_to_per_entity']}"]


def main(argv=None) -> int:
    args = bench_args(__doc__.splitlines()[0], argv)
    rows = run(smoke=not args.full, device=args.device)
    return finish(rows, gates(rows), args, headline(rows))


if __name__ == "__main__":
    sys.exit(main())
