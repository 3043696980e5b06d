"""Mixture-of-Experts FFN: top-k routing and sort-based capacity dispatch
(the JAX package's ``models/moe.py``, on one device).

  assignments -> stable argsort by expert -> position in expert from
  the counts' exclusive cumsum -> write into an (E, C, D) buffer
  (overflow dropped) -> one batched product per projection over the
  experts -> read back with the combine weights.

The capacity ``C = max(8, ceil(cf * T * K / E))`` is fixed by the shapes,
as in the reference.  Overflowing assignments are kept out by an
explicit mask: their slot is a drop row past the buffer's ``E * C`` rows,
which is never read as an expert's input and reads back as zero (the
reference's ``mode="drop"`` scatter and zeroed combine weight).  The
combine puts each assignment's contribution back in its token's order
(the inverse of the sort) and sums the ``K`` of a token, so the result
does not depend on the order of atomic adds.

On a mesh the expert weights are the shards their specs name.  With
the default rules (``experts`` on ``data``, ``expert_ff`` on ``model``)
the experts are gathered over the data axis, whose ranks route other
rows, and ``expert_ff`` is tensor-parallel: each rank computes its
block of every expert's hidden columns and the down projection's
partial outputs are summed over the model axis.  With ``experts`` on
``model`` and ``expert_ff`` on ``data`` (the MoE configs' train and
prefill overrides) :func:`apply_moe_ep_shardmap` runs the reference's
expert parallelism: each model rank owns E/tp experts, routes its data
rows to its own experts only (a per-rank capacity, the drop slot
``E_loc``), and one sum over the model axis combines the partial
outputs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (ShardingCtx, entry_names,
                                              safe_spec)
from repro_torch.models import common


def init_moe(kg: common.KeyGen, cfg: ArchConfig, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    depth_std = (f ** -0.5) / max(cfg.num_layers, 1) ** 0.5
    return {
        "router": common.normal(kg(), (d, e), torch.float32),
        "w_gate": common.normal(kg(), (e, d, f), dtype),
        "w_up": common.normal(kg(), (e, d, f), dtype),
        "w_down": common.normal(kg(), (e, f, d), dtype, std=depth_std),
    }


def axes_moe(cfg: ArchConfig) -> dict:
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "expert_ff"),
        "w_up": ("experts", "embed", "expert_ff"),
        "w_down": ("experts", "expert_ff", "embed"),
    }


def capacity(cfg: ArchConfig, tokens: int,
             capacity_factor: float | None = None) -> int:
    """Slots per expert for ``tokens`` tokens (the reference's static C)."""
    cf = capacity_factor or cfg.moe_capacity_factor
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    return max(8, int(-(-cf * tokens * K // E)))


def _counts(e: torch.Tensor, n: int) -> torch.Tensor:
    """How many entries of ``e`` take each value below ``n``:
    ``torch.bincount`` at a fixed length, which ``meta`` tensors (the
    dry run) take too."""
    return torch.zeros(n, dtype=torch.int64, device=e.device).index_add_(
        0, e, torch.ones_like(e))


def route(router: torch.Tensor, xf: torch.Tensor, cfg: ArchConfig):
    """(T, D) tokens -> (top_w (T,K) in x's dtype, top_e (T,K), aux):
    top-k of the softmax of float32 router logits, weights renormalised,
    and the Switch load-balancing loss ``coef * E * sum_e f_e * p_e``."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    # float32 logits without a float32 copy of the (T, D) activations:
    # the product in x's dtype (float32 accumulation on the card), its
    # (T, E) result widened
    logits = torch.matmul(xf, router.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    fe = _counts(top_e.reshape(-1), E).to(torch.float32) / xf.shape[0]
    aux = cfg.router_aux_loss_coef * E * torch.sum(fe * me)
    return top_w.to(xf.dtype), top_e, aux


def dispatch(top_e: torch.Tensor, E: int, C: int):
    """The sort-based slot assignment of the (T, K) choices ``top_e``:
    ``(order, slot, keep)`` in sorted order — ``order`` the stable
    argsort by expert, ``slot`` the flat row ``e * C + pos`` of each
    kept assignment in the (E*C, D) buffer and the drop row ``E * C``
    of each dropped one, ``keep`` whether its position in its expert is
    below ``C`` (a choice of ``E`` itself, the expert-parallel route's
    drop slot, is never kept)."""
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _counts(sorted_e, E + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=flat_e.device) - starts[sorted_e]
    keep = (pos < C) & (sorted_e < E)
    slot = torch.where(keep, sorted_e * C + pos,
                       torch.full_like(pos, E * C))
    return order, slot, keep


def _experts(p, cfg: ArchConfig, sh: ShardingCtx, dims):
    """The expert weights with the dim that ``dims`` names (leaf -> dim)
    gathered over the data axis where the leaf's spec splits it there
    (the first logical axis that claims ``data`` takes it: under the
    ZeRO-3 train rules ``embed`` does, which the train step gathers):
    the data ranks route other rows, so each one's gradient share is
    summed back."""
    out = []
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    full = {"w_gate": (E, d, f), "w_up": (E, d, f), "w_down": (E, f, d)}
    axes = axes_moe(cfg)
    for name in ("w_gate", "w_up", "w_down"):
        w, dim = p[name], dims[name]
        if sh.size("data") > 1:
            spec = tuple(safe_spec(full[name], axes[name], sh.rules,
                                   sh.mesh)) + (None,) * 3
            if "data" in entry_names(spec[dim]):
                w = sh.gather(w, dim, axis="data", summed=True)
        out.append(w)
    return out


def _ffn(buf, wg, wu, wd, sh: ShardingCtx, split: bool):
    """The grouped SwiGLU of an (E, C, D) buffer; ``split``: the weights
    hold this rank's block of ``expert_ff``, the partial outputs summed
    over the model axis."""
    bc = sh.copy(buf) if split else buf
    h = common.swiglu(torch.bmm(bc, wg), torch.bmm(bc, wu))
    h = sh(h, "experts", None, "act_ff")
    out = torch.bmm(h, wd)
    return sh.reduce(out) if split else out


def _combine(out, slot, order, weights, T, K):
    """Each kept assignment's output row times its weight, back in token
    order, the ``K`` of a token summed (the drop row reads zero)."""
    D = out.shape[-1]
    out = torch.cat([out.reshape(-1, D), out.new_zeros((1, D))])
    contrib = out[slot] * weights.reshape(-1)[order][:, None]
    per_choice = torch.empty_like(contrib)
    per_choice[order] = contrib
    return per_choice.view(T, K, D).sum(dim=1)


def apply_moe(p: dict, x: torch.Tensor, *, cfg: ArchConfig, sh: ShardingCtx,
              capacity_factor: float | None = None):
    """Returns (output (B,S,D), aux load-balancing loss scalar)."""
    if _use_shardmap_ep(cfg, sh):
        return apply_moe_ep_shardmap(p, x, cfg=cfg, sh=sh,
                                     capacity_factor=capacity_factor)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    C = capacity(cfg, T, capacity_factor)
    xf = x.reshape(T, D)
    top_w, top_e, aux = route(p["router"], xf, cfg)
    order, slot, _ = dispatch(top_e, E, C)
    token_of = order // K

    # ---- dispatch: one row per kept assignment, the rest to the drop row
    buf = x.new_zeros((E * C + 1, D))
    buf[slot] = xf[token_of]
    buf = sh(buf[:E * C].view(E, C, D), "experts", None, "embed")

    # ---- grouped expert FFN (SwiGLU), then the combine
    wg, wu, wd = _experts(p, cfg, sh, {"w_gate": 0, "w_up": 0, "w_down": 0})
    out = _ffn(buf, wg, wu, wd, sh, sh.split("expert_ff", cfg.d_ff))
    y = _combine(out, slot, order, top_w, T, K)
    return y.reshape(B, S, D), aux


def apply_moe_ep_shardmap(p, x, *, cfg: ArchConfig, sh: ShardingCtx,
                          capacity_factor=None):
    """Expert parallelism on the model axis (the reference's shard_map
    schedule, on local tensors): each model rank owns E/tp experts
    (its ``experts`` block; ``expert_ff`` regathered over ``data`` when
    that axis has several ranks) and routes its LOCAL tokens — its data
    rows, replicated over ``model`` — to its OWN experts only, with a
    per-rank capacity and ``E_loc`` as the drop slot; the partial
    outputs are summed over ``model``, the one collective of the layer,
    and ``aux`` is averaged over ``model`` (equal there) and ``data``."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    E_loc = E // sh.tp
    col = sh.model_index
    T = B * S
    C = capacity(cfg, T, capacity_factor)
    xf = x.reshape(T, D)
    top_w, top_e, aux = route(p["router"], xf, cfg)
    owned = (top_e // E_loc) == col
    local_e = torch.where(owned, top_e - col * E_loc,
                          torch.full_like(top_e, E_loc))
    weights = sh.copy(top_w) * owned.to(top_w.dtype)
    order, slot, _ = dispatch(local_e, E_loc, C)
    token_of = order // K

    buf = x.new_zeros((E_loc * C + 1, D))
    buf[slot] = sh.copy(xf)[token_of]
    buf = buf[:E_loc * C].view(E_loc, C, D)
    wg, wu, wd = _experts(p, cfg, sh, {"w_gate": 2, "w_up": 2, "w_down": 1})
    out = _ffn(buf, wg, wu, wd, sh, False)
    y = sh.reduce(_combine(out, slot, order, weights, T, K))
    n = sh.size("data")
    if n > 1:
        aux = sh.copy(sh.reduce(aux, "data"), "data") / n
    return y.reshape(B, S, D), aux


def _use_shardmap_ep(cfg: ArchConfig, sh: ShardingCtx) -> bool:
    """The reference's choice: a mesh with a ``model`` axis that divides
    the experts, under rules that put ``experts`` on ``model`` and
    ``expert_ff`` on ``data``."""
    if sh.mesh is None or sh.rules.get("experts") != "model":
        return False
    sizes = sh.mesh.sizes
    return ("model" in sizes and cfg.num_experts % sizes["model"] == 0
            and sh.rules.get("expert_ff") == "data")
