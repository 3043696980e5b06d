#!/usr/bin/env python3
"""The roofline tables of the port's dry run: the counterpart of
``benchmarks/report.py``, over the records that ``python -m
repro_torch.launch.dryrun --all --mesh both`` writes.

  python3 benchmarks/torch_report.py --dryrun experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from benchmarks.torch_roofline import (DRYRUN_DIR,  # noqa: E402
                                       analytic_cell, load_dryrun, pod_of)
from repro_torch.configs import ALL_ARCHS, SHAPES, get_arch  # noqa: E402


def fmt_s(x):
    if x is None:
        return "—"
    if x >= 1:
        return f"{x:.1f}s"
    return f"{x*1e3:.1f}ms"


def table(dryrun_dir: str, mesh: str) -> str:
    """One line per record on ``mesh``, in ``ALL_ARCHS`` x ``SHAPES``
    order: the counted and the analytic terms and bounds."""
    recs = load_dryrun(dryrun_dir)
    lines = [
        "| arch | shape | GiB/dev | counted C/M/N (s) | counted bound "
        "| adj C/M/N (s) | adj bound | roofline frac | useful ratio |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    order = [(a, s) for a in ALL_ARCHS for s in SHAPES
             if (a, s, mesh) in recs]
    for a, s in order:
        r = recs[(a, s, mesh)]
        if r["status"] == "skipped":
            lines.append(f"| {a} | {s} | — | — | — | — | — | skipped: "
                         f"{r['reason'][:60]} | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {a} | {s} | — | ERROR {r.get('error','')[:50]} "
                         f"| — | — | — | — | — |")
            continue
        ana = analytic_cell(get_arch(a), SHAPES[s], pod=pod_of(mesh))
        lines.append(
            f"| {a} | {s} | {r['input_bytes_per_device']/2**30:.2f} "
            f"| {fmt_s(r['compute_term_s'])} / {fmt_s(r['memory_term_s'])} / "
            f"{fmt_s(r['collective_term_s'])} | {r['bottleneck']} "
            f"| {fmt_s(ana['compute_s'])} / {fmt_s(ana['memory_s'])} / "
            f"{fmt_s(ana['collective_s'])} | {ana['bottleneck']} "
            f"| {ana['roofline_fraction']:.2f} | {ana['useful_ratio']:.2f} |")
    return "\n".join(lines)


def summary(dryrun_dir: str) -> str:
    """A line per production mesh: cells ok, skipped and in error, and
    the median and largest ``run_s`` (the port's record has no compile
    step: a cell's run on meta tensors is its whole cost)."""
    recs = load_dryrun(dryrun_dir)
    out = []
    for mesh in ("16x16", "2x16x16"):
        rows = [r for (a, s, m), r in recs.items() if m == mesh]
        ok = sum(r["status"] == "ok" for r in rows)
        sk = sum(r["status"] == "skipped" for r in rows)
        er = sum(r["status"] == "error" for r in rows)
        run = sorted(r.get("run_s", 0) for r in rows if r["status"] == "ok")
        times = (f"{run[len(run)//2]:.1f}/{max(run):.1f}s" if run else "—")
        out.append(f"- **{mesh}**: {ok} ran OK, {sk} skipped-by-design, "
                   f"{er} errors; run time med/max {times}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", default=DRYRUN_DIR)
    ap.add_argument("--mesh", default="16x16")
    a = ap.parse_args(argv)
    print(summary(a.dryrun))
    print()
    print(table(a.dryrun, a.mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
