"""Runs one cell of the benchmark once and prints its result.

    python3 vdms_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a host with the CUDA cards the cell
asks for.  The last line of standard output is the result, one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
the correctness comparison read, beside its limit); the last lines of
standard error repeat the checks.  Without a card, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits with 2."""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import cell
    try:
        result = cell.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START)
    except cell.NoChip as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    bad = cell.forbidden_modules()
    if bad:
        print(f"no result: modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
