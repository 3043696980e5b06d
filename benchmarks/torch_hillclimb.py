#!/usr/bin/env python3
"""Perf hillclimb driver on the port's dry run: the counterpart of
``benchmarks/hillclimb.py``.  Runs an (arch x shape) cell under named
variants (sharding-rule overrides, a capacity factor, the parameters'
dtype), each through ``repro_torch.launch.dryrun.run_cell`` on the
16 x 16 production mesh under a ``fake`` group of 256 ranks, and
records its counted roofline terms.

  python3 benchmarks/torch_hillclimb.py --cell moe_train
  python3 benchmarks/torch_hillclimb.py --all

Records go to ``experiments/hillclimb_torch/<cell>.json``, one per
variant; a variant that fails is its own ``status: "error"`` record
with its traceback, and the sweep goes on.

As in the reference, ``dtype`` is the dtype ``build_cell`` gives the
parameters (a serving cell's cache keeps ``cfg.serve_cache_dtype``),
so ``kv_cache_f8`` and ``cache_heads_f8`` cast the parameters, not the
cache; and ``build_cell`` applies the config's own overrides after a
variant's rules, so a variant whose rules the config already holds
partitions as its baseline does.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's cells and variants, key for key
VARIANTS = {
    # qwen3-moe-235b-a22b x train_4k: the most collective-bound cell
    "moe_train": {
        "arch": "qwen3-moe-235b-a22b",
        "shape": "train_4k",
        "variants": {
            "baseline": {},
            # H1: expert parallelism on the model axis, expert weights
            # stored (E -> model, F -> data) and gathered per layer
            "ep_over_model": {"rules": {"experts": "model",
                                        "expert_ff": "data"}},
            # H2: as H1 at capacity factor 1.0 (fewer padded slots)
            "ep_model_cf1": {"rules": {"experts": "model",
                                       "expert_ff": "data"},
                             "capacity_factor": 1.0},
        },
    },
    # qwen1.5-32b x decode_32k: the worst memory feasibility (an MHA
    # cache of 32k x 128 sequences)
    "dense_decode": {
        "arch": "qwen1.5-32b",
        "shape": "decode_32k",
        "variants": {
            "baseline": {},
            # H1: float8 (e4m3) in place of bfloat16
            "kv_cache_f8": {"dtype": "float8_e4m3fn"},
        },
    },
    # zamba2-2.7b x prefill_32k: the hybrid arch through the serving
    # path behind the paper's model-UDF queries
    "hybrid_prefill": {
        "arch": "zamba2-2.7b",
        "shape": "prefill_32k",
        "variants": {
            "baseline": {},
            # H1: the cache sharded on heads, not sequence
            "cache_heads_sharded": {"rules": {"cache_seq": None,
                                              "cache_heads": "model"}},
            # H2: + float8 on top
            "cache_heads_f8": {"rules": {"cache_seq": None,
                                         "cache_heads": "model"},
                               "dtype": "float8_e4m3fn"},
        },
    },
}

_RUN_TEMPLATE = r"""
import json, sys
sys.path.insert(0, "src")
import torch
from repro_torch.configs import base as cb, get_arch
from repro_torch.distributed.sharding import default_rules
from repro_torch.launch.dryrun import fake_group, run_cell

spec = json.loads({spec_json!r})
rules = default_rules()
rules.update(spec.get("rules") or {{}})
if spec.get("capacity_factor"):
    # applied through the registry, as the reference patches its own
    get_arch(spec["arch"])
    e = cb._REGISTRY[spec["arch"]]
    e.full = e.full.replace(moe_capacity_factor=spec["capacity_factor"])
dtype = getattr(torch, spec.get("dtype") or "bfloat16")
with fake_group(256):
    rec = run_cell(spec["arch"], spec["shape"], multi_pod=False,
                   rules=rules, dtype=dtype, verbose=False)
print("RESULT_JSON:" + json.dumps(rec))
"""


def run_variant(arch, shape, variant: dict, timeout=900) -> dict:
    """One variant's dry-run record, from a fresh subprocess (so a
    variant that fails or runs out of time is its own error record)."""
    spec = {"arch": arch, "shape": shape, **variant}
    code = _RUN_TEMPLATE.format(spec_json=json.dumps(spec))
    try:
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             timeout=timeout, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return {"status": "error", "error": f"timed out after {timeout} s"}
    for line in out.stdout.splitlines():
        if line.startswith("RESULT_JSON:"):
            return json.loads(line[len("RESULT_JSON:"):])
    return {"status": "error", "error": (out.stderr or out.stdout)[-1500:]}


def run_cell_variants(name: str, timeout=900,
                      out_dir="experiments/hillclimb_torch") -> list[dict]:
    """Every variant of cell ``name``, written to ``out_dir/<name>.json``."""
    cell = VARIANTS[name]
    rows = []
    for vname, v in cell["variants"].items():
        rec = run_variant(cell["arch"], cell["shape"], v, timeout=timeout)
        rec["variant"] = vname
        rec["cell"] = name
        rows.append(rec)
        if rec.get("status") == "ok":
            print(f"[{name}/{vname}] compute={rec['compute_term_s']:.4f}s "
                  f"memory={rec['memory_term_s']:.4f}s "
                  f"collective={rec['collective_term_s']:.4f}s "
                  f"input={rec['input_bytes_per_device']/2**30:.2f}GiB "
                  f"run={rec['run_s']}s -> {rec['bottleneck']}", flush=True)
        else:
            print(f"[{name}/{vname}] FAILED: {rec.get('error','?')[:300]}",
                  flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default=None, choices=list(VARIANTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--timeout", type=float, default=900)
    a = ap.parse_args(argv)
    cells = list(VARIANTS) if (a.all or not a.cell) else [a.cell]
    for c in cells:
        run_cell_variants(c, timeout=a.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
