"""The training step: mixed precision, remat, sequential microbatches,
gradient rounding, global-norm clipping and AdamW.

Mixed precision: master params are float32; the forward and backward
run in ``compute_dtype`` (the float32 leaves are cast inside the
differentiated function, so the gradients land on the float32
masters).  The gradients are then rounded to ``grad_reduce_dtype``
(bfloat16 by default: the dtype of the reference's data-parallel
all-reduce, which rounds them on one device too), clipped by their
global norm, and applied by AdamW at ``lr = sched(step + 1)``.

The step updates the state's tensors in place and returns the same
state, as the JAX package's launcher donates it to its jitted step: at
full width a second copy of the parameters and both moments would not
fit beside the first.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models.lm import tree_leaves, tree_like, tree_map
from repro_torch.models.registry import ModelAPI
from repro_torch.training.optimizer import (
    TrainConfig, adamw_leaf, bias_corrections, global_norm, init_moments,
    lr_schedule)


def init_train_state(model: ModelAPI, generator: torch.Generator,
                     param_dtype=torch.float32) -> dict:
    """Seeded parameters (on ``generator``'s device), zero float32
    moments and an int32 step of 0."""
    params = model.init(generator, dtype=param_dtype)
    m, v = init_moments(params)
    step = torch.zeros((), dtype=torch.int32, device=generator.device)
    return {"params": params, "m": m, "v": v, "step": step}


def train_state_axes(model: ModelAPI) -> dict:
    ax = model.param_axes()
    return {"params": ax, "m": ax, "v": ax, "step": ()}


def make_train_step(model: ModelAPI, tcfg: TrainConfig, sh: ShardingCtx):
    """``train_step(state, batch) -> (state, metrics)``; metrics are the
    model's (``ce``, ``aux``, ``ntok``: of the last microbatch) plus
    ``loss`` (the microbatches' mean), ``grad_norm`` (before clipping)
    and ``lr``."""
    sched = lr_schedule(tcfg)
    cdtype = getattr(torch, tcfg.compute_dtype)
    rdtype = getattr(torch, tcfg.grad_reduce_dtype)
    f32 = torch.float32

    def cast(p):
        return tree_map(lambda x: x.to(cdtype)
                        if x.dtype == f32 and x.ndim >= 1 else x, p)

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = model.loss(cast(tree_like(params, leaves)), batch,
                                       sh, remat=tcfg.remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        step = int(state["step"]) + 1
        mb = max(int(tcfg.microbatches), 1)
        if mb == 1:
            loss, metrics, grads = value_and_grad(state["params"], batch)
        else:
            # sequential microbatches: gradients accumulate in float32 and
            # the remat residuals only ever hold B/mb sequences
            grads, loss = None, 0.0
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                l, metrics, g = value_and_grad(state["params"], part)
                if grads is None:
                    grads = [x.to(f32) for x in g]
                else:
                    for acc, x in zip(grads, g):
                        acc.add_(x.to(f32))
                loss = loss + l
                del g
            for g in grads:
                g.div_(mb)
            loss = loss / mb
        if tcfg.grad_reduce_dtype != "float32":
            grads = [g.to(rdtype) for g in grads]

        gnorm = global_norm(grads)
        scale = torch.clamp(tcfg.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = sched(step)
        c1, c2 = bias_corrections(step, tcfg)
        for i, (p, m, v) in enumerate(zip(tree_leaves(state["params"]),
                                          tree_leaves(state["m"]),
                                          tree_leaves(state["v"]))):
            g, grads[i] = grads[i], None
            new = adamw_leaf(p, g.to(f32) * scale, m, v, c1, c2, tcfg, lr)
            for dst, src in zip((p, m, v), new):
                dst.copy_(src)
            del g, new
        state["step"].add_(1)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return state, metrics

    return train_step
