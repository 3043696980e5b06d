#!/usr/bin/env python3
"""Admission-control benchmarks on the PyTorch port: bounded tail
latency under a 10× overload storm against unbounded collapse, and the
admission-off response hash.

``python3 benchmarks/torch_admission_bench.py [--device cuda|cpu]
[--smoke|--full] [--check-baseline]`` from the root of a checkout.  The
port's counterpart of ``benchmarks/admission_bench.py``, with its
workloads, functions, row names and keys:

- ``run_storm``: a burst of ``storm_factor × max_inflight`` entities of
  a remote-bound pipeline (resize → remote grayscale → threshold)
  against engines with ``admission="none"``, ``"shed"`` and
  ``"queue"``.  ``shed_inflight_bounded`` / ``queue_inflight_bounded``:
  the controller's in-flight ledger never exceeded the cap;
  ``shed_p99_within_3x``: the admitted queries' p99 stayed within 3×
  the uncontended p99.  ``derived`` is ``p99_none / p99_shed``;
- ``run_static_hash``: crop → remote flip → rotate → threshold over 8
  seeded 28×28 images on a default engine; the digest must equal the
  recorded ``benchmarks/admission_static_baseline.json`` (``f9acbed1…``)
  and an ``admission="queue"`` engine's arrays must equal it.

``--check-baseline`` exits 2 unless every gate of the reference's holds
(a missing baseline file fails too); there is no ``--update-baseline``.
The payload goes with the card's name and power limit to
``chiprun_out/torch_admission.json``.  The p99s are host wall clocks.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402

from benchmarks.torch_common import (ADMISSION_BASELINE,  # noqa: E402
                                     bench_args, entities_equal, finish,
                                     percentile, recorded_sha256,
                                     response_sha256, write_payload)
from repro_torch.core.engine import VDMSAsyncEngine  # noqa: E402
from repro_torch.core.remote import TransportModel  # noqa: E402
from repro_torch.query.admission import OverloadError  # noqa: E402


def _fill(eng, n, size=24, category="adm"):
    rng = np.random.default_rng(23)
    for i in range(n):
        img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        eng.add_entity("image", img, {"category": category, "idx": i})


def _find(pipe):
    return [{"FindImage": {"constraints": {"category": ["==", "adm"]},
                           "operations": pipe}}]


# ------------------------------------------------------- overload storm
def run_storm(fanout=4, max_inflight=16, storm_factor=10,
              service_ms=3.0, servers=4, *, device="cuda"):
    """One burst of ``storm_factor * max_inflight`` entities against a
    ``max_inflight``-capacity engine, per admission mode."""
    transport = TransportModel(network_latency_s=0.001,
                               service_time_s=service_ms / 1000.0)
    query = _find([
        {"type": "resize", "width": 16, "height": 16},
        {"type": "remote", "url": "u", "options": {"id": "grayscale"}},
        {"type": "threshold", "value": 0.4},
    ])
    n_queries = max(1, storm_factor * max_inflight // fanout)

    def arm(mode):
        kw = {}
        if mode != "none":
            kw = {"admission": mode, "max_inflight_entities": max_inflight,
                  "admission_queue_cap": 100_000}
        eng = VDMSAsyncEngine(device=device, num_remote_servers=servers,
                              transport=transport, num_native_workers=2,
                              **kw)
        try:
            _fill(eng, fanout)
            eng.execute(query, timeout=600)      # warm-up
            uncontended = []                     # one query at a time
            for _ in range(6):
                t0 = time.monotonic()
                eng.execute(query, timeout=600)
                uncontended.append(time.monotonic() - t0)
            # the storm: a burst of submits from one thread (submit is
            # O(fan-out) pointer work, so the backlog is the bottleneck)
            latencies, shed, pending = [], 0, []
            t_burst = time.monotonic()
            for _ in range(n_queries):
                t0 = time.monotonic()
                try:
                    fut = eng.submit(query, cache=False)
                except OverloadError:
                    shed += 1
                    continue
                pending.append((t0, fut))
            for t0, fut in pending:
                fut.result(timeout=600)
                latencies.append(time.monotonic() - t0)
            wall = time.monotonic() - t_burst
            st = eng.admission_stats()
            return {
                "mode": mode,
                "uncontended_p99_s": percentile(uncontended, 99),
                "storm_p50_s": percentile(latencies, 50),
                "storm_p99_s": percentile(latencies, 99),
                "completed": len(latencies),
                "shed": shed,
                "storm_wall_s": wall,
                "peak_inflight": st.get("peak_inflight"),
                "inflight_bounded": (st.get("peak_inflight", 0)
                                     <= max_inflight
                                     if mode != "none" else None),
            }
        finally:
            eng.shutdown()

    none_r, shed_r, queue_r = arm("none"), arm("shed"), arm("queue")
    base = max(1e-9, none_r["uncontended_p99_s"])
    row = {
        "name": f"admission_storm_x{storm_factor}_cap{max_inflight}",
        "us_per_call": shed_r["storm_p99_s"] * 1e6,
        # headline: the tail-latency collapse shedding avoids
        "derived": none_r["storm_p99_s"] / max(1e-9, shed_r["storm_p99_s"]),
        "fanout": fanout,
        "max_inflight_entities": max_inflight,
        "storm_queries": n_queries,
        "none": none_r,
        "shed": shed_r,
        "queue": queue_r,
        "none_p99_ratio": none_r["storm_p99_s"] / base,
        "shed_p99_ratio": shed_r["storm_p99_s"]
        / max(1e-9, shed_r["uncontended_p99_s"]),
        "shed_inflight_bounded": bool(shed_r["inflight_bounded"]),
        "queue_inflight_bounded": bool(queue_r["inflight_bounded"]),
        "shed_count": shed_r["shed"],
    }
    row["shed_p99_within_3x"] = row["shed_p99_ratio"] <= 3.0
    return [row]


# ------------------------------------------------- static-response hash
def run_static_hash(*, device="cuda"):
    """Hash the default engine's response on the bit-exact workload and
    check that an ``admission="queue"`` engine returns the same arrays."""
    transport = TransportModel(network_latency_s=0.001,
                               service_time_s=0.001)
    query = _find([
        {"type": "crop", "x": 2, "y": 2, "width": 20, "height": 20},
        {"type": "remote", "url": "http://svc/flip",
         "options": {"id": "flip"}},
        {"type": "rotate", "k": 3},
        {"type": "threshold", "value": 0.5},
    ])

    def response(**kw):
        eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                              transport=transport, **kw)
        try:
            _fill(eng, 8, size=28)
            return eng.execute(query, timeout=600)
        finally:
            eng.shutdown()

    ref = response()                       # engine exactly as it ships
    gated = response(admission="queue", max_inflight_entities=4)
    identical = entities_equal(ref["entities"], gated["entities"])
    digest = response_sha256(ref["entities"])
    recorded = recorded_sha256(ADMISSION_BASELINE)
    return [{
        "name": "admission_none_hash",
        "us_per_call": 0.0,
        "derived": 1.0 if identical else 0.0,
        "none_response_sha256": digest,
        "baseline_sha256": recorded,
        "queue_matches_none": identical,
        "none_matches_baseline": (recorded is None or digest == recorded),
    }]


def run(smoke=True, device="cuda", report=True):
    """Both arms at the reference's sizes (cap 8 of 4 servers in the
    smoke run: admitted queries near 2× uncontended, inside the 3×
    gate); writes ``chiprun_out/torch_admission.json``."""
    if smoke:
        rows = (run_storm(fanout=4, max_inflight=8, storm_factor=10,
                          service_ms=3.0, servers=4, device=device)
                + run_static_hash(device=device))
    else:
        rows = (run_storm(fanout=8, max_inflight=16, storm_factor=10,
                          service_ms=5.0, servers=8, device=device)
                + run_static_hash(device=device))
    storm, h = _storm_and_hash(rows)
    if report:
        write_payload("admission", {
            "smoke": smoke,
            "p99_collapse_unbounded": storm["none_p99_ratio"],
            "p99_shed_vs_none": storm["derived"],
            "shed_p99_ratio": storm["shed_p99_ratio"],
            "shed_p99_within_3x": storm["shed_p99_within_3x"],
            "shed_inflight_bounded": storm["shed_inflight_bounded"],
            "queue_inflight_bounded": storm["queue_inflight_bounded"],
            "shed_count": storm["shed_count"],
            "none_response_sha256": h["none_response_sha256"],
            "none_matches_baseline": h["none_matches_baseline"],
            "queue_matches_none": h["queue_matches_none"],
            "rows": rows,
        }, device)
    return rows


def _storm_and_hash(rows):
    return (next(r for r in rows if r["name"].startswith("admission_storm")),
            next(r for r in rows if r["name"] == "admission_none_hash"))


def gates(rows, timing=True) -> list[str]:
    """The reference's ``--check-baseline`` gates, as messages of the
    ones that failed (empty: all hold).  ``timing=False`` leaves out the
    one read off wall clocks (shed p99 within 3×) and keeps those fixed
    by construction."""
    storm, h = _storm_and_hash(rows)
    if h["baseline_sha256"] is None:
        return [f"no recorded baseline at {ADMISSION_BASELINE}"]
    failures = []
    if not h["none_matches_baseline"]:
        failures.append(f"none-response hash {h['none_response_sha256']} "
                        f"!= recorded baseline {h['baseline_sha256']}")
    if not h["queue_matches_none"]:
        failures.append("admission='queue' perturbed the response")
    if not (storm["shed_inflight_bounded"]
            and storm["queue_inflight_bounded"]):
        failures.append("in-flight entities exceeded "
                        "max_inflight_entities during the storm")
    if timing and not storm["shed_p99_within_3x"]:
        failures.append(f"shed-arm p99 {storm['shed']['storm_p99_s']:.4f}s "
                        f"is {storm['shed_p99_ratio']:.1f}x its uncontended "
                        f"baseline (limit 3x)")
    return failures


def headline(rows) -> list[str]:
    st, h = _storm_and_hash(rows)
    return [
        f"{st['name']}: storm p99 none {st['none']['storm_p99_s']:.4f} s, "
        f"shed {st['shed']['storm_p99_s']:.4f} s, queue "
        f"{st['queue']['storm_p99_s']:.4f} s (none/shed "
        f"{st['derived']:.3f}); shed p99 {st['shed_p99_ratio']:.3f}x "
        f"uncontended, shed {st['shed_count']} of {st['storm_queries']}; "
        f"peak in flight shed {st['shed']['peak_inflight']}, queue "
        f"{st['queue']['peak_inflight']} (cap "
        f"{st['max_inflight_entities']})",
        f"{h['name']} {h['none_response_sha256']}, queue identical "
        f"{h['queue_matches_none']}"]


def main(argv=None) -> int:
    args = bench_args(__doc__.splitlines()[0], argv)
    rows = run(smoke=not args.full, device=args.device)
    return finish(rows, gates(rows), args, headline(rows))


if __name__ == "__main__":
    sys.exit(main())
