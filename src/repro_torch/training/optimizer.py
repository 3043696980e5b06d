"""AdamW + LR schedules (incl. the WSD schedule MiniCPM was trained with).

Written by hand, as the JAX package writes it (no ``torch.optim``):
moments are plain trees mirroring the params, float32 whatever the
parameters' dtype, and weight decay applies to every leaf of two or more
dimensions, stacked (L, d) norms and biases included.  The schedule is
computed in Python floats, where the reference computes it in float32
(they differ by about 1e-7 relative).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.lm import tree_leaves, tree_like, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "wsd"          # wsd | cosine | linear | constant
    wsd_decay_frac: float = 0.1    # final fraction of steps in the decay phase
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    clip_norm: float = 1.0
    compute_dtype: str = "bfloat16"   # forward/backward dtype; master is f32
    remat: bool = True
    grad_reduce_dtype: str = "bfloat16"  # dtype the gradients are rounded to
    # gradient accumulation: number of sequential microbatches per step;
    # bounds the remat activation stack to B/microbatches sequences
    microbatches: int = 1


def lr_schedule(cfg: TrainConfig):
    """``sched(step) -> float``: linear warmup to the peak, then
    constant, linear or cosine decay to ``min_lr_ratio`` of it, or WSD
    (stable at the peak, then a linear decay over the last
    ``wsd_decay_frac`` of the steps)."""
    peak, total, warm = cfg.learning_rate, cfg.total_steps, cfg.warmup_steps
    floor = peak * cfg.min_lr_ratio

    def clip01(x):
        return min(max(x, 0.0), 1.0)

    def sched(step) -> float:
        step = float(step)
        warm_lr = peak * min(step / max(warm, 1), 1.0)
        if cfg.schedule == "constant":
            return warm_lr
        if step < warm:
            return warm_lr
        if cfg.schedule in ("linear", "cosine"):
            frac = clip01((step - warm) / max(total - warm, 1))
            if cfg.schedule == "linear":
                return peak + frac * (floor - peak)
            return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * frac))
        decay_steps = max(int(total * cfg.wsd_decay_frac), 1)
        decay_start = total - decay_steps
        if step < decay_start:
            return peak
        frac = clip01((step - decay_start) / decay_steps)
        return peak + frac * (floor - peak)

    return sched


def init_moments(params) -> tuple[dict, dict]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return tree_map(zeros, params), tree_map(zeros, params)


def global_norm(tree, groups=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  ``groups``
    (one per leaf, in leaf order) names the process-group axes whose
    ranks hold the other shards of a split leaf: the squares of the
    leaves split alike are summed over those axes, and a replicated
    leaf (an empty group) is counted once."""
    leaves = tree_leaves(tree) if isinstance(tree, dict) else list(tree)
    if groups is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                              for g in leaves))
    sums: dict = {}
    for g, axes in zip(leaves, groups):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        key = tuple(axes)
        sums[key] = sq if key not in sums else sums[key] + sq
    total = 0.0
    for axes, sq in sums.items():
        for axis in axes:
            sq = axis.all_reduce(sq)
        total = total + sq
    return torch.sqrt(total)


def bias_corrections(step, cfg: TrainConfig) -> tuple[float, float]:
    """``1 - b1**step`` and ``1 - b2**step`` at the 1-based ``step``."""
    step = float(step)
    return 1 - cfg.b1 ** step, 1 - cfg.b2 ** step


def adamw_leaf(p, g, m, v, c1: float, c2: float, cfg: TrainConfig,
               lr: float):
    """One leaf's AdamW step in float32 -> (new p in p's dtype, new m,
    new v)."""
    g = g.to(torch.float32)
    m_new = cfg.b1 * m + (1 - cfg.b1) * g
    v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
    p32 = p.to(torch.float32)
    if p.ndim >= 2 and cfg.weight_decay:
        delta = delta + cfg.weight_decay * p32
    return (p32 - lr * delta).to(p.dtype), m_new, v_new


def adamw_update(params, grads, m, v, step, cfg: TrainConfig, lr):
    """One AdamW step; returns (new_params, new_m, new_v).

    ``step`` is the 1-based step index.  Weight decay is decoupled and
    skipped for 1-D params (norms, biases) per common practice."""
    c1, c2 = bias_corrections(step, cfg)
    lr = float(lr)
    out = [adamw_leaf(*leaves, c1, c2, cfg, lr) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(m),
        tree_leaves(v))]
    return tuple(tree_like(params, [o[i] for o in out]) for i in range(3))
