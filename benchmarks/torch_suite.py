#!/usr/bin/env python3
"""The paper's image benchmarks and scale-out curves on the PyTorch port.

``python3 benchmarks/torch_suite.py [--device cuda|cpu]`` from the root
of a checkout.  The port's counterpart of ``benchmarks/image_suite.py``
and ``benchmarks/scaleout.py``, at their sizes; it imports nothing of
the JAX package (the queries, the transports and the system runners
are in ``benchmarks/torch_common.py``):

- ``run_c1``: IQ1–IQ9 as remote ops over 32 64x64x3 faces, through the
  sync (VDMS) and pooled (PostgreSQL) executors of
  ``repro_torch.core.executors`` and the async engine;
- ``run_c2``: resize → facedetect_box → manipulation → rotate, 32 faces;
- ``run_c3``: C2 over 16 faces from 2, 4 and 8 concurrent clients on
  the simulated transport (``execute_ops=False``: the remote servers
  sleep their service time and run nothing);
- ``run_shards``: a ``ShardedEngine`` at 1, 2 and 4 shards, one remote
  server each, 96 images, 2 clients, remote-bound (``SCALE_TRANSPORT``);
  ``T(1)/T(N)`` and the efficiency ``T(1)/T(N)/N``;
- ``run_kappa``: one engine with 1–64 remote servers (paper Fig 29).

Every system runs its ops on ``device`` (the CUDA card by default): the
executors move each entity there when its run starts and back when it
ends, as the engine's host boundary does.  C1 and C2 record each
system's responses' largest difference from the async engine's
(``max_abs_err``) and the blur kernel's launches per system.  Rows are
printed as ``name,us_per_call,derived`` (``derived``: the sync
baseline's wall over the async engine's, or the scaling efficiency) and
written with the card's name to ``chiprun_out/torch_suite.json``.
The times are host wall clocks; no limit is applied to them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402

from benchmarks.torch_common import (SIM_TRANSPORT,  # noqa: E402
                                     remote_op, clients_wall, execute_all,
                                     image_c2_pipeline, image_queries,
                                     image_set, max_err, run_async_engine,
                                     run_baseline)
from repro_torch.cluster import ShardedEngine  # noqa: E402
from repro_torch.core.engine import VDMSAsyncEngine  # noqa: E402
from repro_torch.core.remote import TransportModel  # noqa: E402

# benchmarks/scaleout.py: remote-bound, the op run for real
SCALE_TRANSPORT = TransportModel(network_latency_s=0.0005,
                                 bandwidth_bytes_s=5e9,
                                 service_time_s=0.02)


def _compare(name, n, data, ops, device, servers, fuse=False,
             batch_remote=1):
    sync = run_baseline("sync", data, ops, device=device, servers=servers)
    pool = run_baseline("pool", data, ops, device=device, servers=servers)
    a = run_async_engine(data, ops, device=device, servers=servers,
                         fuse=fuse, batch_remote=batch_remote)
    return {
        "name": name,
        "us_per_call": a["wall_s"] / n * 1e6,
        "derived": sync["wall_s"] / a["wall_s"],
        "sync_s": sync["wall_s"], "pool_s": pool["wall_s"],
        "async_s": a["wall_s"],
        "sync_over_async": sync["wall_s"] / a["wall_s"],
        "pool_over_async": pool["wall_s"] / a["wall_s"],
        "throughput_eps": n / a["wall_s"],
        "t2_busy": a["thread2_busy_s"], "t3_busy": a["thread3_busy_s"],
        "max_abs_err": {"sync": max_err(sync["outputs"], a["outputs"]),
                        "pool": max_err(pool["outputs"], a["outputs"])},
        "k1_launches": {"sync": sync["k1"], "pool": pool["k1"],
                        "async": a["k1"]},
    }


# ------------------------------------------------------------ the suites
def run_c1(device="cuda", n_images=32, queries=None, servers=2):
    data = image_set(n_images)
    return [_compare(f"image_c1_{name}", n_images, data, ops, device,
                     servers)
            for name, ops in (queries or image_queries()).items()]


def run_c2(device="cuda", n_images=32, servers=2, fuse=False,
           batch_remote=1):
    """C2; with ``fuse`` or ``batch_remote`` > 1 the async engine fuses
    its native runs and batches its remote requests (``run.py``'s fusion
    suite), and the row is named ``image_c2_pipeline_opt``."""
    tag = "" if not (fuse or batch_remote > 1) else "_opt"
    return [_compare(f"image_c2_pipeline{tag}", n_images,
                     image_set(n_images), image_c2_pipeline(), device,
                     servers, fuse=fuse, batch_remote=batch_remote)]


def run_c3(device="cuda", n_images=16, clients=(2, 4, 8), servers=4):
    data = image_set(n_images)
    ops = image_c2_pipeline()
    rows = []
    for c in clients:
        kw = dict(device=device, servers=servers, clients=c,
                  transport=SIM_TRANSPORT)
        t_sync = run_baseline("sync", data, ops, **kw)["wall_s"]
        t_pool = run_baseline("pool", data, ops, **kw)["wall_s"]
        t_async = run_async_engine(data, ops, **kw)["wall_s"]
        t_opt = run_async_engine(data, ops, fuse=True, batch_remote=8,
                                 **kw)["wall_s"]
        rows.append({
            "name": f"image_c3_{c}clients",
            "us_per_call": t_async / (n_images * c) * 1e6,
            "derived": t_sync / t_async,
            "sync_s": t_sync, "pool_s": t_pool, "async_s": t_async,
            "async_opt_s": t_opt,
            "sync_over_async": t_sync / t_async,
            "pool_over_async": t_pool / t_async,
            "opt_speedup": t_sync / t_opt,
        })
    return rows


def _find_all(ops, category):
    return [{"FindImage": {"constraints": {"category": ["==", category]},
                           "operations": ops}}]


def run_shards(device="cuda", shard_counts=(1, 2, 4), n_images=96,
               clients=2, virtual_nodes=192, repeats=2):
    """IQ4 (face detect) against a ShardedEngine at growing shard
    counts, one remote server per shard, so per-shard capacity is
    constant and T(N) tracks the most-loaded shard.  Each count takes
    the best of ``repeats`` timed runs."""
    rng = np.random.default_rng(7)
    data = [rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
            for _ in range(n_images)]
    q = _find_all([remote_op("facedetect_box")], "s")
    times, stats = {}, {}
    for n in shard_counts:
        eng = ShardedEngine(num_shards=n, replica_factor=1,
                            virtual_nodes=virtual_nodes, device=device,
                            num_remote_servers=1,
                            transport=SCALE_TRANSPORT,
                            dispatch_policy="least_loaded",
                            num_native_workers=1, fair_scheduling=False)
        try:
            for i, img in enumerate(data):
                eng.add_entity("image", img, {"category": "s", "idx": i})
            execute_all(eng, q, n_images)       # warm-up on every shard
            times[n] = min(clients_wall(lambda: execute_all(eng, q, n_images),
                                    clients) for _ in range(repeats))
            cs = eng.cluster_stats()
            stats[n] = {"owned_primary": {str(s): v["owned"] for s, v
                                          in cs["per_shard"].items()},
                        "ring_imbalance": cs["imbalance"]}
        finally:
            eng.shutdown()
    t1 = times[shard_counts[0]]
    return [{"name": f"scaleout_shards{n}",
             "us_per_call": times[n] / (n_images * clients) * 1e6,
             "derived": t1 / times[n] / n, "gain": t1 / times[n],
             "wall_s": times[n], "shards": n, "n_images": n_images,
             "clients": clients, **stats[n]}
            for n in shard_counts]


def run_kappa(device="cuda", kappas=(1, 2, 4, 8, 16, 32, 64), n_images=48,
              clients=2):
    """One engine, kappa remote servers (paper Fig 29): IQ4 under
    ``clients`` parallel clients; T(1)/T(kappa) should grow linearly."""
    data = image_set(n_images, size=48)
    q = _find_all([remote_op("facedetect_box")], "s")
    times = {}
    for k in kappas:
        eng = VDMSAsyncEngine(device=device, num_remote_servers=k,
                              transport=SCALE_TRANSPORT,
                              dispatch_policy="least_loaded",
                              num_native_workers=1, fair_scheduling=False)
        try:
            for i, img in enumerate(data):
                eng.add_entity("image", img, {"category": "s", "idx": i})
            execute_all(eng, q, n_images)       # warm-up
            times[k] = clients_wall(lambda: execute_all(eng, q, n_images),
                                    clients)
        finally:
            eng.shutdown()
    t1 = times[kappas[0]]
    return [{"name": f"scaleout_k{k}",
             "us_per_call": times[k] / (n_images * clients) * 1e6,
             "derived": t1 / times[k] / k, "gain": t1 / times[k],
             "wall_s": times[k]}
            for k in kappas]


def device_name(device) -> str:
    import torch
    dev = torch.device(device)
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")


def run_all(device="cuda", **sizes) -> dict:
    """Every suite on ``device``; ``sizes`` maps a suite's name (``c1``,
    ``c2``, ``c3``, ``shards``, ``kappa``) to keyword arguments of its
    ``run_*`` function.  Returns ``{suite: rows}`` and the seconds each
    suite took."""
    suites = {"c1": run_c1, "c2": run_c2, "c3": run_c3,
              "shards": run_shards, "kappa": run_kappa}
    out, seconds = {}, {}
    for name, fn in suites.items():
        t0 = time.monotonic()
        out[name] = fn(device=device, **sizes.get(name, {}))
        seconds[name] = time.monotonic() - t0
    out["seconds"] = seconds
    return out


def write_report(result: dict, device) -> str:
    path = os.path.join(ROOT, "chiprun_out", "torch_suite.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"device": device_name(device), **result}, f, indent=1)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run_all(args.device)
    print(f"device: {device_name(args.device)}")
    print("name,us_per_call,derived")
    for name, rows in result.items():
        if name != "seconds":
            for r in rows:
                print(f"{r['name']},{r['us_per_call']:.1f},"
                      f"{r['derived']:.4f}")
    print(f"report: {write_report(result, args.device)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
