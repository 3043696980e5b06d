#!/usr/bin/env python3
"""Resilience benchmarks on the PyTorch port: the fault-tolerance layer
under a seeded fault storm, and the fault-off byte-identity tripwire.

``python3 benchmarks/torch_resilience_bench.py [--device cuda|cpu]
[--smoke|--full] [--check-baseline]`` from the root of a checkout.  The
port's counterpart of ``benchmarks/resilience_bench.py``, with its
workloads, functions, row names and keys:

- ``run_identity``: ``torch_dispatch_bench.run_static_hash`` with every
  fault-tolerance knob at its default; the digest must equal the
  recorded ``benchmarks/dispatch_static_baseline.json``;
- ``run_storm``: a seeded storm of about 20% faults (error 12%, crash
  4%, latency 4%, one server death budgeted; ``FaultInjector`` seed
  ``0xFA17``) against an engine with the remote op pinned onto the
  faulty pool, bounded-jitter retries, heartbeats, circuit breakers,
  ``fallback="native"`` and ``admission="queue"`` under a cap of 16,
  beside the same workload fault-free.  Gates: ``completion_rate`` 1.0
  with no failed entity, no admission leak, ``peak_inflight`` ≤ the
  cap, ``p99_factor`` (storm p99 / fault-free p99) ≤ ``P99_GATE``.

``--check-baseline`` exits 2 unless every gate holds.  The payload goes
with the card's name and power limit to
``chiprun_out/torch_resilience.json``.  The p99s are host wall clocks.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402

from benchmarks import torch_dispatch_bench  # noqa: E402
from benchmarks.torch_common import (bench_args, finish,  # noqa: E402
                                     write_payload)
from repro_torch.core.engine import VDMSAsyncEngine  # noqa: E402
from repro_torch.core.remote import TransportModel  # noqa: E402
from repro_torch.distributed.fault import FaultInjector  # noqa: E402

# storm p99 may exceed fault-free p99 by at most this factor: the gate
# catches unbounded degradation (a retry loop that never converges, a
# breaker that never closes)
P99_GATE = 25.0

STORM_SEED = 0xFA17
INFLIGHT_CAP = 16


def _fill(eng, n, size=32, category="res"):
    rng = np.random.default_rng(23)
    for i in range(n):
        img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        eng.add_entity("image", img, {"category": category, "idx": i})


# -------------------------------------------------- fault-off identity
def run_identity(*, device="cuda"):
    """Fault-tolerance layer present, every knob default: the static
    response hash must still match the recorded dispatch baseline."""
    row = dict(torch_dispatch_bench.run_static_hash(device=device)[0])
    row["name"] = "resilience_identity"
    return [row]


# ------------------------------------------------------- fault storm
def _storm_injector():
    return FaultInjector(seed=STORM_SEED,
                         error_rate=0.12,
                         crash_rate=0.04,
                         latency_rate=0.04,
                         latency_s=0.05,
                         die_rate=0.005,
                         death_budget=1)


def run_storm(n_queries=24, n_images=8, *, device="cuda"):
    transport = TransportModel(network_latency_s=0.004,
                               service_time_s=0.001)
    query = [{"FindImage": {"constraints": {"category": ["==", "res"]},
                            "operations": torch_dispatch_bench.STATIC_PIPE}}]
    # the remote op pinned onto the faulty pool; when its breaker opens
    # the router's health veto re-routes it to the native fallback
    pinned = {"flip": {"remote": 1e-6, "native": 10.0, "batcher": 10.0}}

    def arm(injector):
        eng = VDMSAsyncEngine(
            device=device, num_remote_servers=3, transport=transport,
            num_native_workers=2,
            dispatch="cost", cost_overrides=pinned,
            admission="queue", max_inflight_entities=INFLIGHT_CAP,
            max_retries=4,
            retry_backoff_base_s=0.002, retry_backoff_max_s=0.05,
            heartbeat_timeout_s=0.25,
            fallback="native",
            breaker_enabled=True,
            fault_injector=injector)
        try:
            _fill(eng, n_images)
            futs = [eng.submit(query) for _ in range(n_queries)]
            t0 = time.monotonic()
            completed, failed_entities, durations = 0, 0, []
            for fut in futs:
                try:
                    res = fut.result(timeout=300)
                except Exception:  # noqa: BLE001 — counted, not raised
                    continue
                completed += 1
                failed_entities += res["stats"]["failed"]
                durations.append(res["stats"]["duration_s"])
            wall = time.monotonic() - t0
            adm = eng.admission_stats()
            ds = eng.dispatch_stats()
            return {
                "wall_s": wall,
                "completed": completed,
                "failed_entities": failed_entities,
                "p50_s": float(np.percentile(durations, 50))
                if durations else float("inf"),
                "p99_s": float(np.percentile(durations, 99))
                if durations else float("inf"),
                "peak_inflight": adm["peak_inflight"],
                "admission_leaks": adm["inflight"] + adm["pending"],
                "pool": ds.get("pool", {}),
                "breakers": {k: v["state"]
                             for k, v in ds.get("breakers", {}).items()},
                "breaker_trips": sum(v["trips"] for v in
                                     ds.get("breakers", {}).values()),
                "fallbacks": ds.get("fallbacks", 0),
                "injected": injector.stats() if injector else {},
            }
        finally:
            eng.shutdown()

    clean = arm(None)
    storm = arm(_storm_injector())
    p99_factor = (storm["p99_s"] / clean["p99_s"]
                  if clean["p99_s"] > 0 else float("inf"))
    pool = storm["pool"]
    return [{
        "name": f"resilience_storm_q{n_queries}",
        "us_per_call": storm["wall_s"] / n_queries * 1e6,
        "derived": storm["completed"] / n_queries,
        "completion_rate": storm["completed"] / n_queries,
        "failed_entities": storm["failed_entities"],
        "n_queries": n_queries,
        "entities_per_query": n_images,
        "inflight_cap": INFLIGHT_CAP,
        "peak_inflight": storm["peak_inflight"],
        "admission_leaks": storm["admission_leaks"],
        "clean_p50_s": clean["p50_s"],
        "clean_p99_s": clean["p99_s"],
        "storm_p50_s": storm["p50_s"],
        "storm_p99_s": storm["p99_s"],
        "p99_factor": p99_factor,
        "p99_gate": P99_GATE,
        "injected": storm["injected"],
        "retried": pool.get("retried", 0),
        "retries_delayed": pool.get("retries_delayed", 0),
        "beat_deaths": pool.get("beat_deaths", 0),
        "beat_requeued": pool.get("beat_requeued", 0),
        "live_servers": pool.get("live", 0),
        "breaker_trips": storm["breaker_trips"],
        "breakers_final": storm["breakers"],
        "fallbacks": storm["fallbacks"],
    }]


def run(smoke=True, device="cuda", report=True):
    """Both arms (24 queries in the smoke run, 64 in the full one);
    writes ``chiprun_out/torch_resilience.json``."""
    rows = (run_identity(device=device)
            + run_storm(n_queries=24 if smoke else 64, n_images=8,
                        device=device))
    ident, storm = rows
    if report:
        write_payload("resilience", {
            "smoke": smoke,
            "fault_off_matches_baseline": ident["static_matches_baseline"],
            "completion_rate": storm["completion_rate"],
            "p99_factor": storm["p99_factor"],
            "peak_inflight": storm["peak_inflight"],
            "admission_leaks": storm["admission_leaks"],
            "fallbacks": storm["fallbacks"],
            "rows": rows,
        }, device)
    return rows


def gates(rows, timing=True) -> list[str]:
    """The reference's ``--check-baseline`` gates, as messages of the
    ones that failed (empty: all hold).  ``timing=False`` leaves out the
    one read off wall clocks (``p99_factor``) and keeps those fixed by
    construction."""
    ident = next(r for r in rows if r["name"] == "resilience_identity")
    storm = next(r for r in rows
                 if r["name"].startswith("resilience_storm"))
    if ident["baseline_sha256"] is None:
        return ["no recorded baseline at benchmarks/"
                "dispatch_static_baseline.json"]
    failures = []
    if not ident["static_matches_baseline"]:
        failures.append(f"fault-off response hash "
                        f"{ident['static_response_sha256']} != recorded "
                        f"baseline {ident['baseline_sha256']}")
    if storm["completion_rate"] != 1.0 or storm["failed_entities"]:
        failures.append(f"storm completion_rate="
                        f"{storm['completion_rate']:.3f}, failed_entities="
                        f"{storm['failed_entities']} (want 1.0 / 0)")
    if (storm["admission_leaks"] != 0
            or storm["peak_inflight"] > storm["inflight_cap"]):
        failures.append(f"admission ledger leaked under the storm (leaks="
                        f"{storm['admission_leaks']}, peak="
                        f"{storm['peak_inflight']}, cap="
                        f"{storm['inflight_cap']})")
    if timing and storm["p99_factor"] > P99_GATE:
        failures.append(f"storm p99 is {storm['p99_factor']:.1f}x the "
                        f"fault-free p99 (gate {P99_GATE}x)")
    return failures


def headline(rows) -> list[str]:
    ident, st = rows
    return [
        f"{st['name']}: completion {st['completion_rate']}, failed "
        f"{st['failed_entities']}, p99 clean {st['clean_p99_s']:.4f} s, "
        f"storm {st['storm_p99_s']:.4f} s (factor {st['p99_factor']:.3f}, "
        f"gate {st['p99_gate']}); retried {st['retried']}, breaker trips "
        f"{st['breaker_trips']}, fallbacks {st['fallbacks']}, peak "
        f"{st['peak_inflight']} (cap {st['inflight_cap']}), leaks "
        f"{st['admission_leaks']}; fault-off hash "
        f"{ident['static_response_sha256'][:8]}…"]


def main(argv=None) -> int:
    args = bench_args(__doc__.splitlines()[0], argv)
    rows = run(smoke=not args.full, device=args.device)
    return finish(rows, gates(rows), args, headline(rows))


if __name__ == "__main__":
    sys.exit(main())
