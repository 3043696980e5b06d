"""Shared scaffolding of the PyTorch port's benchmarks: datasets, query
suites, the four competing systems, response comparison and reports.

The port's counterpart of ``benchmarks/common.py``.  It imports nothing
of the JAX package (``common.py`` imports ``repro.dataio``), so the
transports, the queries and the system runners are copied here and run
on the port's engine and executors on one torch ``device`` (the CUDA
card unless the caller passes ``"cpu"``; a CUDA request on a host
without a card raises, nothing falls back to the CPU).

Every runner returns the reference's timing keys plus ``outputs`` (the
timed run's arrays in ingest order, on the host) and ``k1`` (blur kernel
launches over the warm-up and the timed run), so that each system's
responses can be held against the async engine's.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

from repro_torch.core.boundary import to_host  # noqa: E402
from repro_torch.core.engine import VDMSAsyncEngine  # noqa: E402
from repro_torch.core.entity import Entity  # noqa: E402
from repro_torch.core.executors import (FrameExecutor,  # noqa: E402
                                        PooledExecutor, SyncExecutor)
from repro_torch.core.pipeline import parse_operations  # noqa: E402
from repro_torch.core.remote import (RemoteServerPool,  # noqa: E402
                                     TransportModel)
from repro_torch.dataio.synthetic import (synthetic_faces,  # noqa: E402
                                          synthetic_video)
from repro_torch.kernels import gaussian_blur  # noqa: E402

# ~LAN latency + the remote server's compute per entity, identical
# across all competing systems
TRANSPORT = TransportModel(network_latency_s=0.008, bandwidth_bytes_s=1e9,
                           service_time_s=0.010)
# C3's remote capacity, simulated (execute_ops=False: the servers sleep
# their service time and run nothing), so kappa servers serve in
# parallel whatever the host's cores
SIM_TRANSPORT = TransportModel(network_latency_s=0.008,
                               bandwidth_bytes_s=1e9,
                               service_time_s=0.012, execute_ops=False)

# the recorded digests of the bit-exact workloads (never written here)
DISPATCH_BASELINE = os.path.join(ROOT, "benchmarks",
                                 "dispatch_static_baseline.json")
ADMISSION_BASELINE = os.path.join(ROOT, "benchmarks",
                                  "admission_static_baseline.json")


# ---------------------------------------------------------------- data
def image_set(n=48, size=64):
    return synthetic_faces(n, size=size, seed=1)


def video_set(n=6, frames=8, size=48):
    """``n`` clips of ``frames`` frames; ``size`` is H = W or (H, W)."""
    return np.stack([synthetic_video(frames, size, seed=i)
                     for i in range(n)])


# -------------------------------------------------------------- queries
def remote_op(name, **opt):
    return {"type": "remote", "url": "http://srv/op",
            "options": {"id": name, **opt}}


def image_queries() -> dict[str, list[dict]]:
    """IQ1–IQ9 (paper section 6.1.2), each a remote op."""
    return {
        "IQ1_crop": [remote_op("crop", x=4, y=4, width=32, height=32)],
        "IQ2_grayscale": [remote_op("grayscale")],
        "IQ3_blur": [remote_op("blur", ksize=5, sigma_x=1.5)],
        "IQ4_box": [remote_op("facedetect_box")],
        "IQ5_mask": [remote_op("facedetect_mask", r=12)],
        "IQ6_upsample": [remote_op("upsample", fx=1.5, fy=1.5)],
        "IQ7_downsample": [remote_op("downsample", fx=2.0, fy=2.0)],
        "IQ8_caption": [remote_op("caption", text="LFW", x=2, y=2)],
        "IQ9_manipulation": [remote_op("manipulation")],
    }


def video_queries() -> dict[str, list[dict]]:
    """VQ1–VQ9, each a remote op run frame by frame on the server."""
    return {
        "VQ1_select": [remote_op("crop", x=2, y=2, width=32, height=32)],
        "VQ2_grayscale": [remote_op("grayscale")],
        "VQ3_blur": [remote_op("blur", ksize=5, sigma_x=1.5)],
        "VQ4_box": [remote_op("facedetect_box")],
        "VQ5_mask": [remote_op("facedetect_mask", r=10)],
        "VQ6_upsample": [remote_op("upsample", fx=1.5, fy=1.5)],
        "VQ7_downsample": [remote_op("downsample", fx=2.0, fy=2.0)],
        "VQ8_activity": [remote_op("activityrecognition")],
        "VQ9_manipulation": [remote_op("manipulation")],
    }


def image_c2_pipeline() -> list[dict]:
    """Resize -> Box -> Manipulation -> Rotate (Resize/Rotate native)."""
    return [
        {"type": "resize", "width": 48, "height": 48},
        {"type": "remote", "url": "u", "options": {"id": "facedetect_box"}},
        {"type": "remote", "url": "u", "options": {"id": "manipulation"}},
        {"type": "rotate", "k": 1},
    ]


def video_c2_pipeline() -> list[dict]:
    """ActivityRecognition -> Resize -> Select -> Manipulation."""
    return [
        {"type": "remote", "url": "u",
         "options": {"id": "activityrecognition"}},
        {"type": "resize", "width": 40, "height": 40},
        {"type": "crop", "x": 2, "y": 2, "width": 32, "height": 32},
        {"type": "remote", "url": "u", "options": {"id": "manipulation"}},
    ]


# -------------------------------------------------------------- systems
def clients_wall(fn, clients):
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


def execute_all(eng, query, n):
    """``eng.execute(query)``, raising on a short or failed response —
    one that would otherwise time as if it had succeeded."""
    res = eng.execute(query, timeout=600)
    if res["stats"]["failed"] or len(res["entities"]) != n:
        raise RuntimeError(f"short or failed response: {res['stats']}")
    return res


def run_async_engine(data, ops_json, *, device, servers=2, clients=1,
                     video=False, fuse=False, batch_remote=1,
                     transport=None, num_native_workers=1) -> dict:
    """The async engine; ``num_native_workers=1`` with FIFO Queue_1 is
    the paper-faithful single Thread_2.  One warm-up query, then the
    timed one (or ``clients`` at once).  Returns ``eng.utilization()``
    with Thread_2's and Thread_3's busy seconds over the timed run,
    ``wall_s``, ``outputs`` and ``k1``."""
    eng = VDMSAsyncEngine(device=device, num_remote_servers=servers,
                          transport=transport or TRANSPORT,
                          fuse_native=fuse, batch_remote=batch_remote,
                          num_native_workers=num_native_workers,
                          fair_scheduling=num_native_workers != 1)
    try:
        kind = "video" if video else "image"
        eids = [eng.add_entity(kind, item, {"category": "bench", "idx": i})
                for i, item in enumerate(data)]
        verb = "FindVideo" if video else "FindImage"
        q = [{verb: {"constraints": {"category": ["==", "bench"]},
                     "operations": ops_json}}]
        k1 = gaussian_blur.launches.count
        execute_all(eng, q, len(eids))           # warm-up
        responses = []
        m0 = time.monotonic()
        wall = clients_wall(
            lambda: responses.append(execute_all(eng, q, len(eids))),
            clients)
        util = eng.utilization()
        util["thread2_busy_s"] = eng.loop.t2_meter.busy_seconds(since=m0)
        util["thread3_busy_s"] = eng.loop.t3_meter.busy_seconds(since=m0)
        util.update(wall_s=wall, k1=gaussian_blur.launches.count - k1,
                    outputs=[responses[0]["entities"][e] for e in eids])
        return util
    finally:
        eng.shutdown()


def run_baseline(system, data, ops_json, *, device, servers=2, clients=1,
                 video=False, workers=8, transport=None) -> dict:
    """A baseline executor (``"sync"`` VDMS, ``"pool"`` PostgreSQL,
    ``"frame"`` Scanner) over the same transport: one warm-up run, then
    the timed one (or ``clients`` at once).  ``busy_s``: the executor's
    busy seconds over the timed run."""
    pool = RemoteServerPool(servers, transport or TRANSPORT)
    ops = parse_operations(ops_json)
    kind = "video" if video else "image"
    try:
        def make_ents():
            return [Entity(str(i), kind, np.array(d), ops=list(ops))
                    for i, d in enumerate(data)]

        cls = {"sync": SyncExecutor, "pool": PooledExecutor,
               "frame": FrameExecutor}[system]
        ex = (cls(pool, device=device) if system == "sync" else
              cls(pool, workers=workers, device=device))
        k1 = gaussian_blur.launches.count
        ex.run(make_ents())                   # warm-up
        runs = []
        m0 = time.monotonic()
        wall = clients_wall(lambda: runs.append(ex.run(make_ents())),
                            clients)
        return {"wall_s": wall, "busy_s": ex.meter.busy_seconds(since=m0),
                "k1": gaussian_blur.launches.count - k1,
                "outputs": [to_host(e.data) for e in runs[0]]}
    finally:
        pool.shutdown()


# ---------------------------------------------------- comparing responses
def max_err(a, b) -> float:
    """Largest absolute difference between two lists of arrays (inf
    when a shape differs)."""
    out = 0.0
    for x, y in zip(a, b, strict=True):
        x = np.asarray(to_host(x), np.float64)
        y = np.asarray(to_host(y), np.float64)
        if x.shape != y.shape:
            return float("inf")
        out = max(out, float(np.max(np.abs(x - y))) if x.size else 0.0)
    return out


def entities_equal(a: dict, b: dict) -> bool:
    """Same eids in the same order, byte-equal arrays (host copies)."""
    if list(a) != list(b):
        return False
    return all(np.array_equal(to_host(a[k]), to_host(b[k])) for k in a)


def compare_close(a: dict, b: dict) -> tuple:
    """(allclose verdict, per-dtype max-abs-error) across two response
    entity dicts, ``rtol`` 1e-5 and ``atol`` 1e-6 as the reference's."""
    if list(a) != list(b):
        return False, {}
    close = True
    errs: dict[str, float] = {}
    for k in a:
        x, y = to_host(a[k]), to_host(b[k])
        if x.shape != y.shape:
            return False, errs
        err = float(np.max(np.abs(x.astype(np.float64)
                                  - y.astype(np.float64)))) if x.size else 0.0
        dt = str(x.dtype)
        errs[dt] = max(errs.get(dt, 0.0), err)
        close = close and np.allclose(x, y, rtol=1e-5, atol=1e-6)
    return close, errs


def response_sha256(entities: dict) -> str:
    """The reference's response digest: eid, shape, dtype and bytes of
    each entity's host array, in response order."""
    h = hashlib.sha256()
    for eid in entities:
        arr = np.ascontiguousarray(to_host(entities[eid]))
        h.update(eid.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def recorded_sha256(path) -> str | None:
    """The digest recorded in a baseline file, None when it is absent."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("sha256")


def percentile(values, q) -> float:
    return float(np.percentile(np.asarray(values), q)) if values else 0.0


# ------------------------------------------------------------- reports
def card_line(device) -> str:
    """``nvidia-smi``'s name and power limit of the card on a CUDA
    device, ``"cpu"`` otherwise."""
    import torch
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else torch.cuda.get_device_name(0)


def write_payload(bench: str, payload: dict, device) -> str:
    """``chiprun_out/torch_<bench>.json`` with the card's name and power
    limit beside the payload."""
    path = os.path.join(ROOT, "chiprun_out", f"torch_{bench}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"card": card_line(device), **payload}, f, indent=1,
                  default=float)
    return path


def print_rows(rows) -> None:
    print("name,us_per_call,derived")
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']:.4f}")


def bench_args(description, argv=None):
    """The port benches' command line: ``--device``, ``--smoke`` /
    ``--full`` and ``--check-baseline`` (no ``--update-baseline``: the
    recorded digests are the reference's and are never written here)."""
    import argparse
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes (default unless --full)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--check-baseline", action="store_true",
                    help="exit 2 unless every gate holds")
    return ap.parse_args(argv)


def finish(rows, failures, args, lines=()) -> int:
    """Print the rows, the bench's headline ``lines`` and, under
    ``--check-baseline``, each failed gate on stderr; the exit code."""
    print_rows(rows)
    for line in lines:
        print(line)
    if args.check_baseline:
        for msg in failures:
            print(f"FAIL: {msg}", file=sys.stderr)
        if failures:
            return 2
        print("baseline check OK")
    return 0
