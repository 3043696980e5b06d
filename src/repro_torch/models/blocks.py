"""Composable residual blocks built from the layer library: the
transformer block (attention, optional cross-attention, SwiGLU or GELU
MLP or MoE, RMSNorm or LayerNorm) and the Mamba2 block."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import attention, common, mamba2, mlp, moe


def residual_scale(cfg: ArchConfig) -> float:
    """MiniCPM depth-scaled residual; 1.0 when disabled."""
    if cfg.scale_depth > 0:
        return cfg.scale_depth / (cfg.num_layers ** 0.5)
    return 1.0


# ---------------------------------------------------------------- dense
def init_tblock(kg, cfg: ArchConfig, dtype, *, use_moe=False, cross=False,
                mlp_kind="swiglu", norm="rms") -> dict:
    dev = kg.device
    p = {
        "ln1": common.ones((cfg.d_model,), dtype, dev),
        "attn": attention.init_attention(kg, cfg, dtype),
        "ln2": common.ones((cfg.d_model,), dtype, dev),
    }
    if norm == "layer":
        p["ln1_b"] = common.zeros((cfg.d_model,), dtype, dev)
        p["ln2_b"] = common.zeros((cfg.d_model,), dtype, dev)
    if cross:
        p["ln_x"] = common.ones((cfg.d_model,), dtype, dev)
        p["xattn"] = attention.init_attention(kg, cfg, dtype)
        if norm == "layer":
            p["ln_x_b"] = common.zeros((cfg.d_model,), dtype, dev)
    if use_moe:
        p["moe"] = moe.init_moe(kg, cfg, dtype)
    else:
        p["mlp"] = mlp.init_mlp(kg, cfg, dtype, kind=mlp_kind)
    return p


def axes_tblock(cfg: ArchConfig, *, use_moe=False, cross=False,
                mlp_kind="swiglu", norm="rms") -> dict:
    ax = {"ln1": (None,), "attn": attention.axes_attention(cfg),
          "ln2": (None,)}
    if norm == "layer":
        ax["ln1_b"] = (None,)
        ax["ln2_b"] = (None,)
    if cross:
        ax["ln_x"] = (None,)
        ax["xattn"] = attention.axes_attention(cfg)
        if norm == "layer":
            ax["ln_x_b"] = (None,)
    if use_moe:
        ax["moe"] = moe.axes_moe(cfg)
    else:
        ax["mlp"] = mlp.axes_mlp(cfg, kind=mlp_kind)
    return ax


def _norm(x, p, name, cfg, norm):
    if norm == "layer":
        return common.layer_norm(x, p[name], p[name + "_b"], cfg.norm_eps)
    return common.rms_norm(x, p[name], cfg.norm_eps)


def apply_tblock(
    p: dict,
    x: torch.Tensor,
    *,
    cfg: ArchConfig,
    sh: ShardingCtx,
    causal: bool = True,
    positions=None,
    kv_cache=None,
    cache_index=None,
    enc=None,                  # encoder output: cross-attention over it
    cross_cache=None,          # encoder K/V for decode cross-attention
    use_moe=False,
    mlp_kind="swiglu",
    norm="rms",
) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """Returns (x, kv_cache written in place or None, moe_aux)."""
    rs = residual_scale(cfg)
    h, new_cache = attention.apply_attention(
        p["attn"], _norm(x, p, "ln1", cfg, norm), cfg=cfg, sh=sh,
        causal=causal, positions=positions, kv_cache=kv_cache,
        cache_index=cache_index)
    x = x + rs * h
    if enc is not None:
        hx, _ = attention.apply_attention(
            p["xattn"], _norm(x, p, "ln_x", cfg, norm), cfg=cfg, sh=sh,
            causal=False, use_rope=False, xk=enc)
        x = x + rs * hx
    elif cross_cache is not None:
        hx = attention.apply_cross_attention_cached(
            p["xattn"], _norm(x, p, "ln_x", cfg, norm), cross_cache,
            cfg=cfg, sh=sh)
        x = x + rs * hx
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if use_moe:
        h, aux = moe.apply_moe(p["moe"], _norm(x, p, "ln2", cfg, norm),
                               cfg=cfg, sh=sh)
    else:
        h = mlp.apply_mlp(p["mlp"], _norm(x, p, "ln2", cfg, norm), sh=sh,
                          kind=mlp_kind, cfg=cfg)
    x = x + rs * h
    return sh(x, "batch", "seq", "embed"), new_cache, aux


# ---------------------------------------------------------------- mamba
def init_mblock(kg, cfg: ArchConfig, dtype) -> dict:
    return {"ln": common.ones((cfg.d_model,), dtype, kg.device),
            "mixer": mamba2.init_mamba2(kg, cfg, dtype)}


def axes_mblock(cfg: ArchConfig) -> dict:
    return {"ln": (None,), "mixer": mamba2.axes_mamba2(cfg)}


def apply_mblock(p, x, *, cfg, sh, conv_state=None, ssm_state=None):
    h, nc, ns = mamba2.apply_mamba2(
        p["mixer"], common.rms_norm(x, p["ln"], cfg.norm_eps),
        cfg=cfg, sh=sh, conv_state=conv_state, ssm_state=ssm_state)
    return sh(x + h, "batch", "seq", "embed"), nc, ns
