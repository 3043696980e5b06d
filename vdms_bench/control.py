"""The correctness check's two readings on the card: for each seed, one
short window of the cell at its own load, the program's numbers and the
control's (the plain reference computed in TF32 in the program's place)
on the same sample, all seeds in one process.

    python3 vdms_bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line per seed, with whether the program's numbers and
the control's keep to the cell's limits (``limits/<cell>.json``), then
the largest reading of each number over the program's runs and the
smallest over the control's: the two readings each limit lies between.
Exits with 1 where a control reads correct or a program run does not."""
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
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from harness import cell
    program, low, wrong = {}, {}, 0
    for seed in args.seeds:
        res = cell.run(args.workload, seed, args.seconds, False,
                       t_start=time.monotonic(), control=True)
        nums = {k: v["value"] for k, v in res["checks"].items()}
        ctl = {k: v["value"] for k, v in res["control"].items()}
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "control_correct": res["control_correct"],
                          "program": nums, "control": ctl}), flush=True)
        wrong += (not res["correct"]) + res["control_correct"]
        for k, v in nums.items():
            program[k] = max(program.get(k, v), v)
        for k, v in ctl.items():
            low[k] = min(low.get(k, v), v)
    print(json.dumps({"program_max": program, "control_min": low}))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
