#!/usr/bin/env python3
"""Roofline analysis on the port's dry run: the counterpart of
``benchmarks/roofline.py``.

Combines two sources per (arch x shape x mesh) cell:

1. Counted terms from the port's dry run (``python -m
   repro_torch.launch.dryrun``, records under ``experiments/dryrun_torch``):
   the per-device FLOPs, HBM bytes and collective bytes that
   ``launch/costs.CostCounter`` counts op by op over rank 0's step on
   meta tensors.  Caveat: the counted HBM bytes are every eager op's
   operands and results, with no fusion rule, and the hand-written
   kernels (K3's score blocks, the scans' chunk states) keep their
   interiors in shared memory and registers on the card, so the counted
   memory term is an upper bound.  The reference's ``parsed_*`` columns
   (HLO) are ``counted_*`` here.

2. An analytic kernel-adjusted model (this module), the reference's
   arithmetic term for term: the traffic an execution with the
   hand-written kernels moves (parameters, optimizer state, activation
   stacks, caches, logits, ideal kernel I/O) and the collective volumes
   the sharding rules imply, at the NVIDIA H100's rates
   (``repro_torch.kernels.work``: 989 TF/s bf16, 3.35 TB/s HBM3, NVLink
   450 GB/s a direction).  A model axis of 16 spans two 8-card nodes,
   whose traffic between nodes crosses a slower network, so the
   collective term is a lower bound.

MODEL_FLOPS = 6*N*T (dense) or 6*N_active*T (MoE); the ratio against
the modelled FLOPs measures remat/attention overhead.

  python3 benchmarks/torch_roofline.py [--dryrun DIR] [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import pprint
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.configs.base import ArchConfig, ShapeConfig  # noqa: E402
from repro_torch.kernels.work import (HBM_BYTES_S,  # noqa: E402
                                      NVLINK_BYTES_S, PEAK_FLOPS)

DRYRUN_DIR = "experiments/dryrun_torch"


def analytic_cell(cfg: ArchConfig, shape: ShapeConfig, *, dp=16, tp=16,
                  pod=1) -> dict:
    """Kernel-adjusted per-device roofline terms in seconds."""
    chips = dp * tp * pod
    dpp = dp * pod
    B, S = shape.global_batch, shape.seq_len
    B_loc = max(B // dpp, 1)
    N = cfg.param_count()
    N_act = cfg.active_param_count()
    d, L = cfg.d_model, max(cfg.num_layers, 1)
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    V = cfg.padded_vocab
    zero3 = bool(cfg.train_sharding_overrides) and shape.kind == "train"

    # attention layer count (hybrid: shared blocks applied L/every times)
    if cfg.family == "hybrid":
        n_attn = L // max(cfg.shared_attn_every, 1)
    elif cfg.attention == "none":
        n_attn = 0
    else:
        n_attn = L
    bf = 2  # bf16 bytes

    if shape.kind == "train":
        T_loc = B_loc * S
        mb = 16 if B_loc >= 16 else max(B_loc, 1)  # matches dryrun heuristic
        flops = 8.0 * N_act * T_loc / tp                     # fwd+bwd+remat
        flops += 8.0 * (0.5 * 4 * T_loc * S * H * hd) * n_attn / max(tp, 1) / 2
        # gathered weights are read locally once per pass
        p_reads = 3 * (mb if zero3 else 1) * N * bf / tp
        opt = 2 * N * 12 / (tp * (dpp if zero3 else 1))      # m,v,master rw
        acts = 2 * B_loc * S * d * L * bf                    # stack w+r
        logits = 3 * B_loc * S * (V / tp) * 4                # fwd+bwd f32
        attn_io = 10 * B_loc * S * (H / tp) * hd * bf * n_attn
        hbm = p_reads + opt + acts + logits + attn_io
        # collectives: DP grad reduce (ring 2x) + TP act all-reduce
        coll = 2 * (N * bf / tp)                             # grad all-reduce
        if zero3:
            coll += 3 * mb * (N * bf / tp)                   # ZeRO regathers
        coll += 2 * 2 * 2 * B_loc * S * d * bf * L           # 2 AR/layer fwd+bwd
        if cfg.is_moe:
            coll += 4 * 2 * T_loc * cfg.num_experts_per_tok * d * bf * L / tp
    elif shape.kind == "prefill":
        T_loc = B_loc * S
        flops = 2.0 * N_act * T_loc / tp
        flops += 2.0 * (0.5 * 4 * T_loc * S * H * hd) * n_attn / max(tp, 1) / 2
        p_reads = N * bf / tp
        acts = 2 * B_loc * S * d * L * bf
        cache = 2 * B_loc * S * KV * hd * bf * n_attn
        attn_io = 4 * B_loc * S * (H / tp) * hd * bf * n_attn
        hbm = p_reads + acts + cache + attn_io
        coll = 2 * 2 * B_loc * S * d * bf * L
    else:  # decode: one token against an S-long cache
        flops = 2.0 * N_act * B_loc / tp
        flops += 2 * 2 * B_loc * S * (KV * hd) * n_attn / max(tp, 1)
        p_reads = N * bf / tp
        cache = 2 * B_loc * S * KV * hd * bf * n_attn / max(tp, 1)
        if cfg.family in ("ssm", "hybrid"):
            # recurrent state instead of (or in addition to) KV
            st = B_loc * cfg.mamba_nheads * cfg.mamba_head_dim * cfg.ssm_state * 4 \
                if cfg.family == "hybrid" else \
                B_loc * cfg.rwkv_nheads * cfg.rwkv_head_dim ** 2 * 4
            cache += 2 * st * L
        hbm = p_reads + cache + 2 * B_loc * d * L * bf
        coll = 2 * 2 * B_loc * d * bf * L

    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": hbm / HBM_BYTES_S,
             "collective_s": coll / NVLINK_BYTES_S}
    bott = max(terms, key=terms.get)
    total = max(terms.values())
    factor = 6.0 if shape.kind == "train" else 2.0
    model_flops_dev = factor * N_act * (B * S if shape.kind in ("train", "prefill")
                                        else B) / chips
    return {
        **terms,
        "bottleneck": bott.replace("_s", ""),
        "roofline_fraction": terms["compute_s"] / max(total, 1e-12),
        "model_flops_per_dev": model_flops_dev,
        "useful_ratio": model_flops_dev / max(flops, 1e-9),
        "hbm_bytes": hbm, "coll_bytes": coll, "flops": flops,
    }


def pod_of(mesh: str) -> int:
    return 2 if mesh.startswith("2x") else 1


def load_dryrun(dryrun_dir=DRYRUN_DIR) -> dict:
    """``{(arch, shape, mesh): record}`` of the dry run's records."""
    out = {}
    for path in glob.glob(os.path.join(dryrun_dir, "*.json")):
        if path.endswith("summary.json"):
            continue
        with open(path) as f:
            r = json.load(f)
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def build_table(dryrun_dir=DRYRUN_DIR, mesh="16x16") -> list[dict]:
    """One row per record on ``mesh``: the counted terms beside the
    analytic model's."""
    recs = load_dryrun(dryrun_dir)
    rows = []
    for (arch, shape, m), r in sorted(recs.items()):
        if m != mesh:
            continue
        row = {"arch": arch, "shape": shape, "mesh": m,
               "status": r["status"]}
        if r["status"] != "ok":
            row["reason"] = r.get("reason", "")
            rows.append(row)
            continue
        a = analytic_cell(get_arch(arch), SHAPES[shape], pod=pod_of(m))
        row.update({
            "counted_compute_s": r["compute_term_s"],
            "counted_memory_s": r["memory_term_s"],
            "counted_collective_s": r["collective_term_s"],
            "counted_bottleneck": r["bottleneck"],
            "adj_compute_s": a["compute_s"],
            "adj_memory_s": a["memory_s"],
            "adj_collective_s": a["collective_s"],
            "adj_bottleneck": a["bottleneck"],
            "roofline_fraction": a["roofline_fraction"],
            "useful_ratio": a["useful_ratio"],
            "gib_per_dev": r["input_bytes_per_device"] / 2 ** 30,
        })
        rows.append(row)
    return rows


def run(dryrun_dir=DRYRUN_DIR) -> list[dict]:
    """Benchmark-harness entry: one row per dry-run cell on 16 x 16,
    ``us_per_call`` the modelled step at the card's rates."""
    rows = []
    for r in build_table(dryrun_dir):
        if r["status"] != "ok":
            rows.append({"name": f"roofline_{r['arch']}_{r['shape']}",
                         "us_per_call": 0.0, "derived": 0.0,
                         "skipped": r.get("reason", "")})
            continue
        step_s = max(r["adj_compute_s"], r["adj_memory_s"], r["adj_collective_s"])
        rows.append({
            "name": f"roofline_{r['arch']}_{r['shape']}",
            "us_per_call": step_s * 1e6,               # modelled step time
            "derived": r["roofline_fraction"],          # the score
            "bottleneck": r["adj_bottleneck"],
            "counted_bottleneck": r["counted_bottleneck"],
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", default=DRYRUN_DIR)
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    for row in build_table(args.dryrun, args.mesh):
        pprint.pprint(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
