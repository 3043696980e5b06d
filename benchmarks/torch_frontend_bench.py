#!/usr/bin/env python3
"""Serving front-end benchmarks on the PyTorch port: what the wire
costs, and the gates that keep it honest.

``python3 benchmarks/torch_frontend_bench.py [--device cuda|cpu]
[--smoke|--full] [--check-baseline]`` from the root of a checkout.  The
port's counterpart of ``benchmarks/frontend_bench.py``, with its
workloads, functions, row names and keys, through the port's wire
protocol and socket front end (``repro_torch.serving.{wire,frontend}``):

- ``run_wire_identity``: the bit-exact static workload of
  ``torch_dispatch_bench`` over the wire; the reassembled response's
  digest must equal the in-process response's and the recorded
  ``benchmarks/dispatch_static_baseline.json`` (``778564da…``);
- ``run_wire_overhead``: the same workload in process and over the
  wire on one engine; the wire's overhead per entity and each path's
  time to first result (medians); the responses must be identical;
- ``run_overload_gate``: a saturated admission ledger answered over
  the wire: the overload frame carries a positive, finite
  ``retry_after_s`` while a cache-servable query still completes.

``--check-baseline`` exits 2 unless every gate of the reference's holds
(a missing baseline file fails too).  The payload goes with the card's
name and power limit to ``chiprun_out/torch_frontend.json``.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402

from benchmarks.torch_common import (DISPATCH_BASELINE,  # noqa: E402
                                     bench_args, entities_equal, finish,
                                     recorded_sha256, response_sha256,
                                     write_payload)
from benchmarks.torch_dispatch_bench import STATIC_PIPE  # noqa: E402
from repro_torch.core.engine import VDMSAsyncEngine  # noqa: E402
from repro_torch.core.remote import TransportModel  # noqa: E402
from repro_torch.query.admission import OverloadError  # noqa: E402
from repro_torch.serving.frontend import (WireClient,  # noqa: E402
                                          WireFrontend)

STATIC_QUERY = [{"FindImage": {"constraints": {"category": ["==", "dsp"]},
                               "operations": STATIC_PIPE}}]


def _fill(eng, n, size, category="dsp"):
    rng = np.random.default_rng(11)
    for i in range(n):
        img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        eng.add_entity("image", img, {"category": category, "idx": i})


def _static_engine(device, servers=2, **kw):
    return VDMSAsyncEngine(
        device=device, num_remote_servers=servers,
        transport=TransportModel(network_latency_s=0.001,
                                 service_time_s=0.001), **kw)


# --------------------------------------------------------- wire identity
def run_wire_identity(*, device="cuda"):
    """The static-hash workload through the socket: the reassembled
    wire response against the in-process one and the recorded digest."""
    eng = _static_engine(device)
    try:
        _fill(eng, 8, 32)
        inproc = eng.execute(STATIC_QUERY, timeout=600)
        front = WireFrontend(eng).start()
        try:
            with WireClient(front.address) as client:
                wired = client.execute(STATIC_QUERY, timeout=600)
        finally:
            front.close()
    finally:
        eng.shutdown()
    wire_sha = response_sha256(wired["entities"])
    inproc_sha = response_sha256(inproc["entities"])
    recorded = recorded_sha256(DISPATCH_BASELINE)
    return [{
        "name": "frontend_wire_identity",
        "us_per_call": 0.0,
        "derived": 1.0 if wire_sha == inproc_sha else 0.0,
        "wire_response_sha256": wire_sha,
        "inproc_response_sha256": inproc_sha,
        "baseline_sha256": recorded,
        "wire_matches_inproc": wire_sha == inproc_sha,
        "wire_matches_baseline": (recorded is None or wire_sha == recorded),
    }]


# -------------------------------------------------------- wire overhead
def run_wire_overhead(n_images=32, size=32, repeats=5, *, device="cuda"):
    """One engine, one workload: in-process submit against the full
    wire round trip, alternating, ``repeats`` times after one warm-up
    each."""
    def inproc_once(eng):
        first = []
        t0 = time.perf_counter()
        fut = eng.submit(STATIC_QUERY,
                         on_entity=lambda e: first.append(
                             time.perf_counter()) if not first else None)
        res = fut.result(600)
        t_total = time.perf_counter() - t0
        return t_total, (first[0] - t0 if first else t_total), res

    def wire_once(client):
        t0 = time.perf_counter()
        fut = client.submit(STATIC_QUERY)
        first = None
        while True:
            event, _ = fut._pull(600)
            if event == "entity" and first is None:
                first = time.perf_counter()
            if event in ("complete", "overload", "error", "cancelled"):
                break
        res = fut.result(600)
        t_total = time.perf_counter() - t0
        return t_total, ((first or time.perf_counter()) - t0), res

    eng = _static_engine(device)
    try:
        _fill(eng, n_images, size)
        front = WireFrontend(eng).start()
        try:
            inproc_t, inproc_first, wire_t, wire_first = [], [], [], []
            with WireClient(front.address) as client:
                inproc_once(eng)           # warm both paths once
                wire_once(client)
                for _ in range(repeats):
                    t, f, ri = inproc_once(eng)
                    inproc_t.append(t)
                    inproc_first.append(f)
                    t, f, rw = wire_once(client)
                    wire_t.append(t)
                    wire_first.append(f)
        finally:
            front.close()
    finally:
        eng.shutdown()
    t_in = float(np.median(inproc_t))
    t_wire = float(np.median(wire_t))
    overhead_per_entity_us = (t_wire - t_in) / n_images * 1e6
    return [{
        "name": f"frontend_wire_overhead_n{n_images}",
        "us_per_call": t_wire * 1e6,
        "derived": overhead_per_entity_us,
        "inproc_total_s": t_in,
        "wire_total_s": t_wire,
        "wire_overhead_per_entity_us": overhead_per_entity_us,
        "inproc_first_result_s": float(np.median(inproc_first)),
        "wire_first_result_s": float(np.median(wire_first)),
        "responses_identical": entities_equal(ri["entities"],
                                              rw["entities"]),
    }]


# -------------------------------------------------------- overload gate
def run_overload_gate(*, device="cuda"):
    """Saturate the admission ledger, then query over the wire: the
    shed query gets the overload frame with a positive finite
    ``retry_after_s`` while a cache-servable query completes on the
    same saturated engine."""
    eng = _static_engine(device, servers=1, admission="shed",
                         max_inflight_entities=4, cache_capacity=64)
    retry_after = None
    cache_served = False
    cache_hits = 0
    try:
        _fill(eng, 4, 24)
        front = WireFrontend(eng).start()
        try:
            with WireClient(front.address) as client:
                warm = client.execute(STATIC_QUERY, timeout=600)
                # deterministic saturation: claim every slot pre-ingest
                eng.admission_ctl.reserve("hold", 4, first_phase=True)
                try:
                    client.submit(STATIC_QUERY, cache=False).result(60)
                except OverloadError as e:
                    retry_after = e.retry_after_s
                served = client.execute(STATIC_QUERY, timeout=600)
                cache_hits = served["stats"].get("cache_full_hits", 0)
                cache_served = (
                    cache_hits == len(warm["entities"]) and
                    list(served["entities"]) == list(warm["entities"]))
        finally:
            front.close()
    finally:
        eng.shutdown()
    gate_ok = (retry_after is not None and 0 < retry_after < float("inf")
               and cache_served)
    return [{
        "name": "frontend_overload_gate",
        "us_per_call": 0.0,
        "derived": 1.0 if gate_ok else 0.0,
        "retry_after_s": retry_after,
        "overload_answered": retry_after is not None,
        "cache_served_while_saturated": cache_served,
        "cache_full_hits": cache_hits,
        "gate_ok": gate_ok,
    }]


def run(smoke=True, device="cuda", report=True):
    """The three arms; writes ``chiprun_out/torch_frontend.json``."""
    over = (dict(n_images=16, size=32, repeats=3) if smoke
            else dict(n_images=64, size=48, repeats=7))
    rows = (run_wire_identity(device=device)
            + run_wire_overhead(device=device, **over)
            + run_overload_gate(device=device))
    ident, over_row, gate = _rows(rows)
    if report:
        write_payload("frontend", {
            "smoke": smoke,
            "wire_matches_inproc": ident["wire_matches_inproc"],
            "wire_matches_baseline": ident["wire_matches_baseline"],
            "wire_response_sha256": ident["wire_response_sha256"],
            "wire_overhead_per_entity_us":
                over_row["wire_overhead_per_entity_us"],
            "wire_first_result_s": over_row["wire_first_result_s"],
            "inproc_first_result_s": over_row["inproc_first_result_s"],
            "overload_retry_after_s": gate["retry_after_s"],
            "cache_served_while_saturated":
                gate["cache_served_while_saturated"],
            "rows": rows,
        }, device)
    return rows


def _rows(rows):
    return (next(r for r in rows if r["name"] == "frontend_wire_identity"),
            next(r for r in rows
                 if r["name"].startswith("frontend_wire_overhead")),
            next(r for r in rows if r["name"] == "frontend_overload_gate"))


def gates(rows) -> list[str]:
    """The reference's ``--check-baseline`` gates, as messages of the
    ones that failed (empty: all hold)."""
    ident, over, gate = _rows(rows)
    if ident["baseline_sha256"] is None:
        return [f"no recorded baseline at {DISPATCH_BASELINE}"]
    failures = []
    if not ident["wire_matches_baseline"]:
        failures.append(f"wire response hash {ident['wire_response_sha256']}"
                        f" != recorded baseline {ident['baseline_sha256']}")
    if not ident["wire_matches_inproc"]:
        failures.append("wire response differs from in-process response")
    if not over["responses_identical"]:
        failures.append("overhead-arm wire response differs from "
                        "in-process response")
    if not gate["gate_ok"]:
        failures.append(f"overload gate (retry_after_s="
                        f"{gate['retry_after_s']}, cache_served="
                        f"{gate['cache_served_while_saturated']})")
    return failures


def headline(rows) -> list[str]:
    ident, over, gate = _rows(rows)
    return [
        f"{ident['name']} {ident['wire_response_sha256']}; {over['name']}: "
        f"in process {over['inproc_total_s']:.4f} s, wire "
        f"{over['wire_total_s']:.4f} s, "
        f"{over['wire_overhead_per_entity_us']:.1f} us an entity, first "
        f"result {over['inproc_first_result_s']:.4f} / "
        f"{over['wire_first_result_s']:.4f} s; overload retry_after_s "
        f"{gate['retry_after_s']}, cache served "
        f"{gate['cache_served_while_saturated']}"]


def main(argv=None) -> int:
    args = bench_args(__doc__.splitlines()[0], argv)
    rows = run(smoke=not args.full, device=args.device)
    return finish(rows, gates(rows), args, headline(rows))


if __name__ == "__main__":
    sys.exit(main())
