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

Data parallelism: on a mesh of several ranks (``sh.mesh``, whose model
axis is 1) each rank takes its rows of each microbatch, the rows the
reference's ``"batch" -> ("pod", "data")`` sharding puts on its data
index (every row when they do not split evenly, as the reference's
divisibility demotion replicates them).  Each rank's gradients, loss
and metrics are weighted by its share of the microbatch's tokens and
summed over the ranks after the float32 accumulation, before the
``grad_reduce_dtype`` rounding; clipping and AdamW then run alike on
every rank.  The result is one rank's step on the global batch, up to
the order of the sums.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import ShardingCtx, local_rows
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

    dp = _DataParallel.of(sh)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        step = int(state["step"]) + 1
        mb = max(int(tcfg.microbatches), 1)
        # sequential microbatches: gradients accumulate in float32 and
        # the remat residuals only ever hold B/mb sequences
        grads, loss = None, 0.0
        for i in range(mb):
            part = batch if mb == 1 else {
                k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                for k, v in batch.items()}
            if dp is not None:
                part = local_rows(part, dp.n, dp.index)
            l, metrics, g = value_and_grad(state["params"], part)
            if dp is not None:
                l, metrics, g = dp.weigh(l, metrics, g)
            if grads is None:
                grads = g if mb == 1 else [x.to(f32) for x in g]
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x.to(f32))
            loss = loss + l
            del g
        if mb > 1:
            for g in grads:
                g.div_(mb)
            loss = loss / mb
        if dp is not None:
            loss, metrics = dp.reduce(grads, loss, metrics)
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


class _DataParallel:
    """This rank's share of a data-parallel step over the default
    process group (the mesh's ranks; its model axis is 1, so its batch
    extent is every rank)."""

    def __init__(self, n: int, index: int):
        self.n, self.index = n, index

    @classmethod
    def of(cls, sh: ShardingCtx):
        mesh = sh.mesh
        if mesh is None or mesh.size == 1:
            return None
        if mesh.device_mesh is None:
            raise ValueError(f"a mesh of {mesh.size} ranks needs its "
                             "DeviceMesh (a process group of that size)")
        return cls(mesh.batch_extent, dist.get_rank())

    def weigh(self, loss, metrics, grads):
        """Scale this rank's loss, ``ce``, ``aux`` and gradients by its
        share of the microbatch's tokens; ``ntok`` becomes the
        microbatch's."""
        ntok = metrics["ntok"].detach().clone()
        dist.all_reduce(ntok)
        w = metrics["ntok"] / ntok
        metrics = dict(metrics, ce=metrics["ce"] * w, aux=metrics["aux"] * w,
                       ntok=ntok)
        for g in grads:
            g.mul_(w.to(g.dtype))
        return loss * w, metrics, grads

    def reduce(self, grads, loss, metrics):
        """Sum the weighted gradients, loss and metrics over the ranks."""
        for g in grads:
            dist.all_reduce(g)
        sums = torch.stack([loss, metrics["ce"], metrics["aux"]]).to(
            torch.float32)
        dist.all_reduce(sums)
        return sums[0], dict(metrics, ce=sums[1], aux=sums[2])
