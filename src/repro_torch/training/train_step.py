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

Parallelism: on a mesh of several ranks (``sh.mesh``) the state holds
each leaf's local shard, as its spec names it.  Each rank takes the
rows of each microbatch that the reference's ``"batch" -> ("pod",
"data")`` sharding puts on its data index (every row when they do not
split evenly, as the reference's divisibility demotion replicates
them), and its loss is weighted by its share of the microbatch's
tokens before the backward.  The model's apply functions place their
own collectives over the model axis (tensor and expert parallelism),
so every model rank of a data index ends with the same loss and the
same gradient for a replicated leaf, and its local gradient for a leaf
split over ``model``.  The gradients, loss and metrics are then summed
over the data axis after the float32 accumulation, before the
``grad_reduce_dtype`` rounding — except a leaf split over ``data`` (the
MoE's experts), whose gather over the data axis already summed its
gradient in the backward.  The global norm sums the squares of a split
leaf over the axes that split it; clipping and AdamW then run on the
local shards.  The result is one rank's step on the global batch, up to
the order of the sums.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (Axis, Layout, ShardingCtx,
                                              entry_names, local_rows,
                                              map_with_axes)
from repro_torch.models.lm import tree_leaves, tree_like, tree_map
from repro_torch.models.registry import ModelAPI, param_shapes
from repro_torch.training.optimizer import (
    TrainConfig, adamw_leaf, bias_corrections, global_norm, init_moments,
    lr_schedule)


def init_train_state(model: ModelAPI, generator: torch.Generator,
                     param_dtype=torch.float32, place=None) -> dict:
    """Seeded parameters (on ``generator``'s device, or where ``place``
    puts them: a rank's shards on its card), zero float32 moments beside
    them and an int32 step of 0."""
    params = model.init(generator, dtype=param_dtype)
    if place is not None:
        params = place(params)
    m, v = init_moments(params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"params": params, "m": m, "v": v, "step": step}


def train_state_axes(model: ModelAPI) -> dict:
    ax = model.param_axes()
    return {"params": ax, "m": ax, "v": ax, "step": ()}


def make_train_step(model: ModelAPI, tcfg: TrainConfig, sh: ShardingCtx,
                    local_batch: bool = False):
    """``train_step(state, batch) -> (state, metrics)``; metrics are the
    model's (``ce``, ``aux``, ``ntok``: of the last microbatch) plus
    ``loss`` (the microbatches' mean), ``grad_norm`` (before clipping)
    and ``lr``.  ``batch`` is the global batch, of which each rank keeps
    its rows of every microbatch, or with ``local_batch`` this rank's
    rows already (the dry run's inputs).  A ``meta`` state (the dry
    run) has no step count: it steps from 0."""
    sched = lr_schedule(tcfg)
    cdtype = getattr(torch, tcfg.compute_dtype)
    rdtype = getattr(torch, tcfg.grad_reduce_dtype)
    f32 = torch.float32

    def cast(p):
        return tree_map(lambda x: x.to(cdtype)
                        if x.dtype == f32 and x.ndim >= 1 else x, p)

    par = _Parallel.of(model, sh)

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            tree = cast(tree_like(params, leaves))
            if par is not None:
                tree = par.gathered(tree)
            loss, metrics = model.loss(tree, batch, sh, remat=tcfg.remat)
            if par is not None and par.batch is not None:
                loss, metrics = par.weigh(loss, metrics)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        step = (0 if state["step"].is_meta else int(state["step"])) + 1
        mb = max(int(tcfg.microbatches), 1)
        # sequential microbatches: gradients accumulate in float32 and
        # the remat residuals only ever hold B/mb sequences
        grads, loss = None, 0.0
        for i in range(mb):
            part = batch if mb == 1 else {
                k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                for k, v in batch.items()}
            if par is not None and not local_batch:
                part = local_rows(part, par.n, par.index)
            l, metrics, g = value_and_grad(state["params"], part)
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
        groups = None
        if par is not None:
            groups = par.groups(state["params"])
            loss, metrics = par.reduce(grads, par.unsplit(state["params"]),
                                       loss, metrics)
        if tcfg.grad_reduce_dtype != "float32":
            grads = [g.to(rdtype) for g in grads]

        gnorm = global_norm(grads, groups)
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


def batch_axis(sh: ShardingCtx) -> Axis | None:
    """The process group of the ranks that split the ``batch`` rows
    (pod x data), or ``None`` when they are one rank."""
    if sh.mesh.batch_extent == 1:
        return None
    if sh.size("pod") == 1:
        return sh.axis("data")
    if sh.tp == 1:      # pod x data is then the whole world
        return Axis(dist.group.WORLD, dist.get_world_size(), dist.get_rank())
    # the ranks of each model index, in (pod, data) order: one group each,
    # every rank creating all of them in the same order
    ranks = sh.mesh.device_mesh.mesh.reshape(-1, sh.tp)
    mine, _ = dist.new_subgroups_by_enumeration(
        [ranks[:, m].tolist() for m in range(sh.tp)])
    return Axis(mine, sh.mesh.batch_extent, sh.data_index)


class _Parallel:
    """This rank's share of a step on a mesh: its data index among the
    ``n`` batch ranks, the batch axis's group, per parameter leaf the
    mesh axes that split it (from the specs of the full shapes), and the
    dims that ZeRO-3 gathers for the step: those whose logical axis is
    ``embed`` and whose spec splits them over ``data`` (the big configs'
    ``train_sharding_overrides``)."""

    def __init__(self, sh: ShardingCtx, layout: Layout, axes):
        self.sh, self.layout = sh, layout
        self.n, self.index = sh.mesh.batch_extent, sh.data_index
        self.batch = batch_axis(sh)
        self.batch_names = {a for a in ("pod", "data") if sh.size(a) > 1}
        self.zero3 = map_with_axes(lambda spec, ax: [
            d for d, (entry, name) in enumerate(zip(spec, ax or ()))
            if name == "embed" and "data" in entry_names(entry)
            and sh.size("data") > 1], layout.specs, axes)

    @classmethod
    def of(cls, model: ModelAPI, sh: ShardingCtx):
        if sh.mesh is None or sh.mesh.size == 1:
            return None
        if sh.mesh.device_mesh is None:
            raise ValueError(f"a mesh of {sh.mesh.size} ranks needs its "
                             "DeviceMesh (a process group of that size)")
        axes = model.param_axes()
        return cls(sh, Layout(sh, param_shapes(model), axes), axes)

    def gathered(self, params):
        """``params`` with the ZeRO-3 dims gathered whole over ``data``
        for the step (their gradients come back reduce-scattered)."""
        def one(leaf, dims):
            for d in dims:
                leaf = self.sh.gather(leaf, d, axis="data", summed=True)
            return leaf
        return map_with_axes(one, params, self.zero3)

    def _split(self, spec) -> set:
        return {a for e in spec for a in entry_names(e)
                if self.sh.size(a) > 1}

    def groups(self, params) -> list[list[Axis]]:
        """Per leaf of ``params`` (in its order), the groups over which
        its shards lie: the batch group for a split over every batch
        axis (pod and data), that axis's group for a split over one, the
        model group for one over model."""
        def axes(_, spec):
            names = self._split(spec)
            split = names & self.batch_names
            out = []
            if split == self.batch_names and split:
                out.append(self.batch)
            elif split:
                out.append(self.sh.axis(split.pop()))
            if "model" in names:
                out.append(self.sh.axis("model"))
            return out
        return tree_leaves(map_with_axes(axes, params, self.layout.specs))

    def unsplit(self, params) -> list[set]:
        """Per leaf, the batch axes that do not split it: its gradient is
        summed over them."""
        return tree_leaves(map_with_axes(
            lambda _, spec: self.batch_names - self._split(spec), params,
            self.layout.specs))

    def weigh(self, loss, metrics):
        """Scale this rank's loss, ``ce`` and ``aux`` by its share of the
        microbatch's tokens (before the backward); ``ntok`` becomes the
        microbatch's."""
        ntok = self.batch.all_reduce(metrics["ntok"].detach())
        w = metrics["ntok"] / ntok
        metrics = dict(metrics, ce=metrics["ce"] * w, aux=metrics["aux"] * w,
                       ntok=ntok)
        return loss * w, metrics

    def reduce(self, grads, unsplit, loss, metrics):
        """Sum the weighted gradients of the leaves over the batch axes
        that do not split them (all of them for a replicated leaf; pod
        for one split over data alone, whose gather over data summed
        its gradient there), and the loss and metrics over the batch
        axis."""
        if self.batch is None:
            return loss, metrics
        for g, rest in zip(grads, unsplit):
            if rest == self.batch_names:
                dist.all_reduce(g, group=self.batch.group)
            elif rest:
                dist.all_reduce(g, group=self.sh.axis(rest.pop()).group)
        sums = self.batch.all_reduce(torch.stack(
            [loss, metrics["ce"], metrics["aux"]]).to(torch.float32))
        return sums[0], dict(metrics, ce=sums[1], aux=sums[2])
