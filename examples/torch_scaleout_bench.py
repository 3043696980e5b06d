#!/usr/bin/env python3
"""Scale-out demo on the PyTorch port (paper Fig 29): query latency vs
the number of remote servers kappa — the event-driven engine converts
added servers into near-linear speedup.

Prints one line per kappa from ``benchmarks/torch_suite.run_kappa``.

  PYTHONPATH=src python examples/torch_scaleout_bench.py [--device cpu]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from benchmarks.torch_suite import run_kappa  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kappas", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32])
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--clients", type=int, default=4)
    a = ap.parse_args(argv)
    rows = run_kappa(a.device, kappas=tuple(a.kappas), n_images=a.images,
                     clients=a.clients)
    print(f"{'kappa':>6s} {'wall_s':>8s} {'gain T(1)/T(k)':>15s} {'efficiency':>11s}")
    for r in rows:
        k = int(r["name"].split("_k")[1])
        print(f"{k:6d} {r['wall_s']:8.3f} {r['gain']:15.2f} {r['derived']:11.2f}")
    return {"rows": rows}


if __name__ == "__main__":
    main()
