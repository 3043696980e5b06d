#!/usr/bin/env python3
"""The paper's image benchmarks and scale-out curves on the PyTorch port.

``python3 benchmarks/torch_suite.py [--device cuda|cpu]`` from the root
of a checkout.  The port's counterpart of ``benchmarks/image_suite.py``
and ``benchmarks/scaleout.py``, at their sizes; it imports nothing of
the JAX package (``benchmarks/common.py`` does, so the queries, the
transports and the drivers are copied here):

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
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

from repro_torch.cluster import ShardedEngine  # noqa: E402
from repro_torch.core.engine import VDMSAsyncEngine  # noqa: E402
from repro_torch.core.entity import Entity  # noqa: E402
from repro_torch.core.executors import (PooledExecutor,  # noqa: E402
                                        SyncExecutor)
from repro_torch.core.pipeline import parse_operations  # noqa: E402
from repro_torch.core.remote import (RemoteServerPool,  # noqa: E402
                                     TransportModel)
from repro_torch.dataio.synthetic import synthetic_faces  # noqa: E402
from repro_torch.kernels import gaussian_blur  # noqa: E402

# benchmarks/common.py: ~LAN latency + the remote server's compute per
# entity, identical across all competing systems
TRANSPORT = TransportModel(network_latency_s=0.008, bandwidth_bytes_s=1e9,
                           service_time_s=0.010)
# benchmarks/common.py: C3's remote capacity, simulated
SIM_TRANSPORT = TransportModel(network_latency_s=0.008,
                               bandwidth_bytes_s=1e9,
                               service_time_s=0.012, execute_ops=False)
# benchmarks/scaleout.py: remote-bound, the op run for real
SCALE_TRANSPORT = TransportModel(network_latency_s=0.0005,
                                 bandwidth_bytes_s=5e9,
                                 service_time_s=0.02)


# -------------------------------------------------------------- queries
def _remote(name, **opt):
    return {"type": "remote", "url": "http://srv/op",
            "options": {"id": name, **opt}}


def image_queries() -> dict[str, list[dict]]:
    """IQ1–IQ9 (paper section 6.1.2), each a remote op."""
    return {
        "IQ1_crop": [_remote("crop", x=4, y=4, width=32, height=32)],
        "IQ2_grayscale": [_remote("grayscale")],
        "IQ3_blur": [_remote("blur", ksize=5, sigma_x=1.5)],
        "IQ4_box": [_remote("facedetect_box")],
        "IQ5_mask": [_remote("facedetect_mask", r=12)],
        "IQ6_upsample": [_remote("upsample", fx=1.5, fy=1.5)],
        "IQ7_downsample": [_remote("downsample", fx=2.0, fy=2.0)],
        "IQ8_caption": [_remote("caption", text="LFW", x=2, y=2)],
        "IQ9_manipulation": [_remote("manipulation")],
    }


def image_c2_pipeline() -> list[dict]:
    """Resize -> Box -> Manipulation -> Rotate (Resize/Rotate native)."""
    return [
        {"type": "resize", "width": 48, "height": 48},
        {"type": "remote", "url": "u", "options": {"id": "facedetect_box"}},
        {"type": "remote", "url": "u", "options": {"id": "manipulation"}},
        {"type": "rotate", "k": 1},
    ]


def image_set(n=32, size=64):
    return synthetic_faces(n, size=size, seed=1)


# -------------------------------------------------------------- systems
def _clients(fn, clients):
    """Run ``fn()`` from ``clients`` threads at once; re-raise the first
    error.  Returns the wall time."""
    errors = []

    def one():
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        raise RuntimeError(f"{len(errors)}/{clients} clients raised: "
                           f"{errors[0]!r}") from errors[0]
    return wall


def _execute(eng, query, n):
    """``eng.execute(query)``, raising on a short or failed response —
    one that would otherwise time as if it had succeeded."""
    res = eng.execute(query, timeout=600)
    if res["stats"]["failed"] or len(res["entities"]) != n:
        raise RuntimeError(f"short or failed response: {res['stats']}")
    return res


def run_async_engine(data, ops_json, *, device, servers=2, clients=1,
                     fuse=False, batch_remote=1, transport=None) -> dict:
    """The async engine with one native worker and FIFO Queue_1 (the
    paper-faithful single Thread_2).  One warm-up query, then the timed
    one (or ``clients`` at once).  ``outputs``: the timed response's
    arrays in ingest order; ``k1``: blur launches in both runs."""
    eng = VDMSAsyncEngine(device=device, num_remote_servers=servers,
                          transport=transport or TRANSPORT,
                          fuse_native=fuse, batch_remote=batch_remote,
                          num_native_workers=1, fair_scheduling=False)
    try:
        eids = [eng.add_entity("image", item, {"category": "bench",
                                               "idx": i})
                for i, item in enumerate(data)]
        q = [{"FindImage": {"constraints": {"category": ["==", "bench"]},
                            "operations": ops_json}}]
        k1 = gaussian_blur.launches.count
        _execute(eng, q, len(eids))           # warm-up
        responses = []
        wall = _clients(lambda: responses.append(_execute(eng, q, len(eids))),
                        clients)
        return {"wall_s": wall, "k1": gaussian_blur.launches.count - k1,
                "outputs": [responses[0]["entities"][e] for e in eids]}
    finally:
        eng.shutdown()


def run_baseline(system, data, ops_json, *, device, servers=2, clients=1,
                 workers=8, transport=None) -> dict:
    """A baseline executor over the same transport: one warm-up run,
    then the timed one (or ``clients`` at once)."""
    pool = RemoteServerPool(servers, transport or TRANSPORT)
    ops = parse_operations(ops_json)
    try:
        def make_ents():
            return [Entity(str(i), "image", np.array(d), ops=list(ops))
                    for i, d in enumerate(data)]

        ex = (SyncExecutor(pool, device=device) if system == "sync" else
              PooledExecutor(pool, workers=workers, device=device))
        k1 = gaussian_blur.launches.count
        ex.run(make_ents())                   # warm-up
        runs = []
        wall = _clients(lambda: runs.append(ex.run(make_ents())), clients)
        return {"wall_s": wall, "k1": gaussian_blur.launches.count - k1,
                "outputs": [e.data for e in runs[0]]}
    finally:
        pool.shutdown()


def _max_err(a, b) -> float:
    out = 0.0
    for x, y in zip(a, b, strict=True):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if x.shape != y.shape:
            return float("inf")
        out = max(out, float(np.max(np.abs(x - y))) if x.size else 0.0)
    return out


def _compare(name, n, data, ops, device, servers):
    sync = run_baseline("sync", data, ops, device=device, servers=servers)
    pool = run_baseline("pool", data, ops, device=device, servers=servers)
    a = run_async_engine(data, ops, device=device, servers=servers)
    return {
        "name": name,
        "us_per_call": a["wall_s"] / n * 1e6,
        "derived": sync["wall_s"] / a["wall_s"],
        "sync_s": sync["wall_s"], "pool_s": pool["wall_s"],
        "async_s": a["wall_s"],
        "sync_over_async": sync["wall_s"] / a["wall_s"],
        "pool_over_async": pool["wall_s"] / a["wall_s"],
        "throughput_eps": n / a["wall_s"],
        "max_abs_err": {"sync": _max_err(sync["outputs"], a["outputs"]),
                        "pool": _max_err(pool["outputs"], a["outputs"])},
        "k1_launches": {"sync": sync["k1"], "pool": pool["k1"],
                        "async": a["k1"]},
    }


# ------------------------------------------------------------ the suites
def run_c1(device="cuda", n_images=32, queries=None, servers=2):
    data = image_set(n_images)
    return [_compare(f"image_c1_{name}", n_images, data, ops, device,
                     servers)
            for name, ops in (queries or image_queries()).items()]


def run_c2(device="cuda", n_images=32, servers=2):
    return [_compare("image_c2_pipeline", n_images, image_set(n_images),
                     image_c2_pipeline(), device, servers)]


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
    q = _find_all([_remote("facedetect_box")], "s")
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
            _execute(eng, q, n_images)       # warm-up on every shard
            times[n] = min(_clients(lambda: _execute(eng, q, n_images),
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
    q = _find_all([_remote("facedetect_box")], "s")
    times = {}
    for k in kappas:
        eng = VDMSAsyncEngine(device=device, num_remote_servers=k,
                              transport=SCALE_TRANSPORT,
                              dispatch_policy="least_loaded",
                              num_native_workers=1, fair_scheduling=False)
        try:
            for i, img in enumerate(data):
                eng.add_entity("image", img, {"category": "s", "idx": i})
            _execute(eng, q, n_images)       # warm-up
            times[k] = _clients(lambda: _execute(eng, q, n_images), clients)
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
