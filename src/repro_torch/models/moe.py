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

Expert parallelism over a mesh's model axis (the reference's
``apply_moe_ep_shardmap``) is not ported: a mesh runs data parallelism
only (``ShardingCtx`` refuses a model axis above one rank), where each
rank routes its own rows over replicated experts, its capacity and aux
loss counted over those rows.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
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
    fe = torch.bincount(top_e.reshape(-1), minlength=E).to(torch.float32) \
        / xf.shape[0]
    aux = cfg.router_aux_loss_coef * E * torch.sum(fe * me)
    return top_w.to(xf.dtype), top_e, aux


def dispatch(top_e: torch.Tensor, E: int, C: int):
    """The sort-based slot assignment of the (T, K) choices ``top_e``:
    ``(order, slot, keep)`` in sorted order — ``order`` the stable
    argsort by expert, ``slot`` the flat row ``e * C + pos`` of each
    kept assignment in the (E*C, D) buffer and the drop row ``E * C``
    of each dropped one, ``keep`` whether its position in its expert is
    below ``C``."""
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(sorted_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=flat_e.device) - starts[sorted_e]
    keep = pos < C
    slot = torch.where(keep, sorted_e * C + pos,
                       torch.full_like(pos, E * C))
    return order, slot, keep


def apply_moe(p: dict, x: torch.Tensor, *, cfg: ArchConfig, sh: ShardingCtx,
              capacity_factor: float | None = None):
    """Returns (output (B,S,D), aux load-balancing loss scalar)."""
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

    # ---- grouped expert FFN (SwiGLU)
    h = common.swiglu(torch.bmm(buf, p["w_gate"]), torch.bmm(buf, p["w_up"]))
    h = sh(h, "experts", None, "act_ff")
    out = torch.cat([torch.bmm(h, p["w_down"]).reshape(E * C, D),
                     x.new_zeros((1, D))])     # the drop row reads zero

    # ---- combine: back to token order, then the K choices summed
    contrib = out[slot] * top_w.reshape(-1)[order][:, None]
    per_choice = torch.empty_like(contrib)
    per_choice[order] = contrib
    y = per_choice.view(T, K, D).sum(dim=1)
    return y.reshape(B, S, D), aux
