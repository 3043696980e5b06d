#!/usr/bin/env python3
"""The paper's video benchmarks on the PyTorch port: C1 (Figs 18–20),
C2 (Figs 21–23), C3 (Figs 24–26) and the busy fractions of Figs 27–28.

``python3 benchmarks/torch_video_suite.py [--device cuda|cpu] [--full]
[--check-baseline]`` from the root of a checkout.  The port's
counterpart of ``benchmarks/video_suite.py`` and
``benchmarks/cpu_trace.py``, with their workloads, row names and keys:

- ``run_c1``: VQ1–VQ9, each a remote op that the server runs frame by
  frame, through the sync (VDMS) baseline, the Scanner-style frame
  graph (``FrameExecutor``: every frame its own remote request) and the
  async engine (``FindVideo``);
- ``run_c2``: activityrecognition → resize 40×40 → crop 32×32 →
  manipulation, through sync, pooled, frame and async;
- ``run_c3``: C2 from 2 and 4 concurrent clients on the simulated
  transport (the servers sleep their service time and run nothing);
- ``run_cputrace``: ``cpu_trace.run``, VQ7's downsample → grayscale →
  blur chain over 6 clips of 10 64×64 frames; ``derived`` is each
  system's busy fraction, the async engine's Thread_2 and Thread_3
  averaged;
- ``run_real``: C1 and C2 at a size a user would call real, 4 clips of
  32 240×320×3 float32 frames (≈ 118 MB the entities hold on the card);
  rows carry the suffix ``_240x320``.

Every row carries each system's largest difference from the async
engine's response (``max_abs_err``) and its blur-kernel launches
(``k1_launches``).  ``--check-baseline`` exits 2 unless every system is
within ``VIDEO_TOL`` of the async engine (and, on the card, VQ3 launched
the blur kernel in every system).  Rows go with the card's name and
power limit to ``chiprun_out/torch_video.json``.  The times are host
wall clocks; no limit is applied to them.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from benchmarks.torch_common import (SIM_TRANSPORT, bench_args,  # noqa: E402
                                     finish, max_err, run_async_engine,
                                     run_baseline, video_c2_pipeline,
                                     video_queries, video_set,
                                     write_payload)

# every system's response against the async engine's: the same ops on
# the same device, in another order of entities and threads
VIDEO_TOL = 1e-5
REAL_SIZE = dict(n_videos=4, frames=32, size=(240, 320))


def _suffix(size) -> str:
    return "" if size == 48 else f"_{size[0]}x{size[1]}"


def _systems(systems, data, ops, *, device, servers, **kw):
    """Each baseline of ``systems`` and the async engine on ``data``:
    ``{system: result}`` with ``"async"`` last."""
    out = {s: run_baseline(s, data, ops, device=device, servers=servers,
                           video=True, **kw) for s in systems}
    out["async"] = run_async_engine(data, ops, device=device,
                                    servers=servers, video=True, **kw)
    return out


def _checks(res) -> dict:
    a = res["async"]
    return {"max_abs_err": {s: max_err(r["outputs"], a["outputs"])
                            for s, r in res.items() if s != "async"},
            "k1_launches": {s: r["k1"] for s, r in res.items()}}


def run_c1(device="cuda", n_videos=4, frames=6, queries=None, servers=2,
           size=48):
    data = video_set(n_videos, frames=frames, size=size)
    rows = []
    for name, ops in (queries or video_queries()).items():
        res = _systems(("sync", "frame"), data, ops, device=device,
                       servers=servers)
        t_sync, a = res["sync"]["wall_s"], res["async"]["wall_s"]
        rows.append({
            "name": f"video_c1_{name}{_suffix(size)}",
            "us_per_call": a / n_videos * 1e6,
            "derived": t_sync / a,
            "sync_s": t_sync, "scanner_s": res["frame"]["wall_s"],
            "async_s": a,
            "frames_per_s": n_videos * frames / a,
            **_checks(res),
        })
    return rows


def run_c2(device="cuda", n_videos=4, frames=6, servers=2, size=48):
    data = video_set(n_videos, frames=frames, size=size)
    res = _systems(("sync", "pool", "frame"), data, video_c2_pipeline(),
                   device=device, servers=servers)
    t_sync, a = res["sync"]["wall_s"], res["async"]["wall_s"]
    return [{
        "name": f"video_c2_pipeline{_suffix(size)}",
        "us_per_call": a / n_videos * 1e6,
        "derived": t_sync / a,
        "sync_s": t_sync, "pool_s": res["pool"]["wall_s"],
        "scanner_s": res["frame"]["wall_s"], "async_s": a,
        **_checks(res),
    }]


def run_c3(device="cuda", n_videos=3, frames=4, clients=(2, 4), servers=4):
    data = video_set(n_videos, frames=frames)
    rows = []
    for c in clients:
        res = _systems(("sync",), data, video_c2_pipeline(), device=device,
                       servers=servers, clients=c, transport=SIM_TRANSPORT)
        t_sync, a = res["sync"]["wall_s"], res["async"]["wall_s"]
        rows.append({
            "name": f"video_c3_{c}clients",
            "us_per_call": a / (n_videos * c) * 1e6,
            "derived": t_sync / a,
            "sync_s": t_sync, "async_s": a,
            **_checks(res),
        })
    return rows


CPUTRACE_OPS = [
    {"type": "remote", "url": "u",
     "options": {"id": "downsample", "fx": 2.0, "fy": 2.0}},
    {"type": "grayscale"},
    {"type": "remote", "url": "u",
     "options": {"id": "blur", "ksize": 5, "sigma_x": 1.0}},
]


def run_cputrace(device="cuda", n_videos=6, frames=10, servers=2):
    """``cpu_trace.run``: busy fractions of each system over VQ7's chain
    (busy seconds / wall seconds / threads)."""
    data = video_set(n_videos, frames=frames, size=64)
    res = {"sync": run_baseline("sync", data, CPUTRACE_OPS, device=device,
                                servers=servers, video=True)}
    for s in ("pool", "frame"):
        res[s] = run_baseline(s, data, CPUTRACE_OPS, device=device,
                              servers=servers, video=True, workers=4)
    res["async"] = run_async_engine(data, CPUTRACE_OPS, device=device,
                                    servers=servers, video=True)
    checks = _checks(res)
    rows = []
    for key, name in (("sync", "cputrace_sync_vdms"),
                      ("pool", "cputrace_postgres_pool"),
                      ("frame", "cputrace_scanner_frames")):
        r = res[key]
        rows.append({"name": name,
                     "us_per_call": r["wall_s"] / n_videos * 1e6,
                     "derived": r["busy_s"] / max(r["wall_s"], 1e-9),
                     "wall_s": r["wall_s"],
                     "max_abs_err": checks["max_abs_err"][key],
                     "k1_launches": r["k1"]})
    a = res["async"]
    rows.append({"name": "cputrace_vdms_async",
                 "us_per_call": a["wall_s"] / n_videos * 1e6,
                 "derived": (a["thread2_busy_s"] + a["thread3_busy_s"])
                 / max(a["wall_s"], 1e-9) / 2,
                 "wall_s": a["wall_s"],
                 "speedup_vs_sync": rows[0]["wall_s"] / a["wall_s"],
                 "max_abs_err": 0.0, "k1_launches": a["k1"]})
    return rows


def run_real(device="cuda", n_videos=4, frames=32, size=(240, 320),
             servers=2):
    """C1 and C2 over ``n_videos`` clips of ``frames`` frames of
    ``size``."""
    kw = dict(device=device, n_videos=n_videos, frames=frames,
              servers=servers, size=size)
    return run_c1(**kw) + run_c2(**kw)


def run_all(device="cuda", full=True, real=True, sizes=None,
            cputrace=True) -> dict:
    """The suites at ``run.py``'s sizes (``--full``: C1 and C2 6 × 8,
    C3 4 × 6 at 2 and 4 clients; else its fast sizes), cputrace unless
    ``cputrace`` is false, and the real-size run; ``sizes`` maps a
    suite's name to keyword arguments that replace its defaults.
    Returns ``{suite: rows}`` and the seconds each took."""
    import time
    if full:
        plan = {"c1": (run_c1, dict(n_videos=6, frames=8)),
                "c2": (run_c2, dict(n_videos=6, frames=8)),
                "c3": (run_c3, dict(n_videos=4, frames=6, clients=(2, 4)))}
    else:
        fast = dict(list(video_queries().items())[:3])
        plan = {"c1": (run_c1, dict(n_videos=3, frames=4, queries=fast)),
                "c2": (run_c2, dict(n_videos=3, frames=4)),
                "c3": (run_c3, dict(n_videos=2, frames=3, clients=(2,)))}
    if cputrace:
        plan["cputrace"] = (run_cputrace, {})
    if real:
        plan["real"] = (run_real, dict(REAL_SIZE))
    out, seconds = {}, {}
    for name, (fn, kw) in plan.items():
        t0 = time.monotonic()
        out[name] = fn(device=device,
                       **{**kw, **(sizes or {}).get(name, {})})
        seconds[name] = time.monotonic() - t0
    out["seconds"] = seconds
    return out


def rows_of(result) -> list:
    """``run_all``'s rows, suite after suite."""
    return [r for k, v in result.items() if k != "seconds" for r in v]


def run_suite(smoke=True, device="cuda", report=True, sizes=None):
    """``run_all`` at ``run.py``'s fast sizes (``smoke``) or at its
    ``--full`` ones with the real-size run; writes the rows and each
    suite's seconds to ``chiprun_out/torch_video.json``; returns the
    rows."""
    result = run_all(device, full=not smoke, real=not smoke, sizes=sizes)
    if report:
        write_payload("video", result, device)
    return rows_of(result)


def headline(rows) -> list[str]:
    """A line a row: each system's time, ``derived``, the largest
    difference from the async engine and the blur kernel's launches."""
    out = []
    for r in rows:
        times = ", ".join(f"{k[:-2]} {r[k] * 1e3:.3f} ms" for k in
                          ("sync_s", "pool_s", "scanner_s", "async_s",
                           "wall_s") if k in r)
        out.append(f"{r['name']}: {times}; derived {r['derived']:.4f}; "
                   f"max_abs_err {r['max_abs_err']}; K1 {r['k1_launches']}")
    return out


def gates(rows, device) -> list[str]:
    """The failed checks: a system farther than ``VIDEO_TOL`` from the
    async engine, or, on the card, a VQ3 system that never launched the
    blur kernel."""
    import torch
    failures = []
    for r in rows:
        errs = r["max_abs_err"]
        errs = errs if isinstance(errs, dict) else {"": errs}
        for system, err in errs.items():
            if not err <= VIDEO_TOL:
                failures.append(f"{r['name']}: {system} is {err:.3g} from "
                                f"the async engine (limit {VIDEO_TOL})")
        if "VQ3_blur" in r["name"] and torch.device(device).type == "cuda":
            for system, n in r["k1_launches"].items():
                if n <= 0:
                    failures.append(f"{r['name']}: the {system} system "
                                    "launched no blur kernel")
    return failures


def main(argv=None) -> int:
    args = bench_args(__doc__.splitlines()[0], argv)
    rows = run_suite(smoke=not args.full, device=args.device)
    return finish(rows, gates(rows, args.device), args, headline(rows))


if __name__ == "__main__":
    sys.exit(main())
