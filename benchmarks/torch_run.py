#!/usr/bin/env python3
"""The PyTorch port's benchmark harness — one suite per paper table or
figure, the counterpart of ``benchmarks/run.py``.

``python3 benchmarks/torch_run.py [--device cuda|cpu] [--full]
[--only SUITE]`` from the root of a checkout, where SUITE is one of
image, video, cputrace, scaleout, serving, native_pool, hotpath,
dispatch, fusion, roofline.  Prints ``name,us_per_call,derived`` and writes every
row with the card's name and power limit to
``chiprun_out/torch_bench.json``.  Unlike ``run.py``, a suite that
raises fails the run (exit 1) after the other suites have run.  The
roofline suite (``torch_roofline.py``) joins them, as ``roofline`` does
in ``run.py``, whenever the port's dry-run records exist
(``experiments/dryrun_torch``, from ``python -m
repro_torch.launch.dryrun --all --mesh both``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from benchmarks import (torch_dispatch_bench, torch_hotpath,  # noqa: E402
                        torch_roofline, torch_serving_bench, torch_suite,
                        torch_video_suite)
from benchmarks.torch_common import (image_queries, print_rows,  # noqa: E402
                                     write_payload)

SUITES = ("image", "video", "cputrace", "scaleout", "serving",
          "native_pool", "hotpath", "dispatch", "fusion")


def suites(device, full, dryrun_dir=torch_roofline.DRYRUN_DIR) -> dict:
    """``{name: fn}``: each returns its rows, at ``run.py``'s sizes; the
    roofline suite last, when ``dryrun_dir`` exists."""
    ts, vs = torch_suite, torch_video_suite
    out = {}
    if full:
        out["image"] = lambda: (ts.run_c1(device, 48) + ts.run_c2(device, 48)
                                + ts.run_c3(device, 24, clients=(2, 4, 8)))
        out["scaleout"] = lambda: (
            ts.run_shards(device, shard_counts=(1, 2, 4, 8))
            + ts.run_kappa(device, n_images=96, clients=4))
    else:
        iq = dict(list(image_queries().items())[:4])
        out["image"] = lambda: (ts.run_c1(device, 16, queries=iq)
                                + ts.run_c2(device, 16)
                                + ts.run_c3(device, 8, clients=(2, 4)))
        out["scaleout"] = lambda: (
            ts.run_shards(device)
            + ts.run_kappa(device, kappas=(1, 2, 4, 8), n_images=48))
    out["video"] = lambda: vs.rows_of(vs.run_all(device, full=full,
                                                 real=full, cputrace=False))
    out["cputrace"] = lambda: vs.run_cputrace(device)
    out["serving"] = lambda: torch_serving_bench.run(device=device)
    out["native_pool"] = lambda: torch_serving_bench.run_native_pool(
        n_images=48 if full else 24, sessions=4 if full else 2,
        device=device)
    out["hotpath"] = lambda: torch_hotpath.run(smoke=not full, device=device)
    out["dispatch"] = lambda: torch_dispatch_bench.run(smoke=not full,
                                                       device=device)
    out["fusion"] = lambda: (
        ts.run_c2(device, 16)
        + [dict(r, name=r["name"] + "_fused")
           for r in ts.run_c2(device, 16, fuse=True, batch_remote=8)])
    out = {name: out[name] for name in SUITES}
    if os.path.isdir(dryrun_dir):
        out["roofline"] = lambda: torch_roofline.run(dryrun_dir)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None, choices=SUITES + ("roofline",))
    args = ap.parse_args(argv)
    rows, failed, seconds = [], [], {}
    for name, fn in suites(args.device, args.full).items():
        if args.only and name != args.only:
            continue
        print(f"# running suite: {name}", file=sys.stderr, flush=True)
        t0 = time.monotonic()
        try:
            rows.extend(fn())
        except Exception:  # noqa: BLE001 — the run fails below
            traceback.print_exc()
            failed.append(name)
        seconds[name] = time.monotonic() - t0
    path = write_payload("bench", {"full": args.full, "failed": failed,
                                   "seconds": seconds, "rows": rows},
                         args.device)
    print_rows(rows)
    print(f"report: {path}")
    if failed:
        print(f"FAIL: suites raised: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
