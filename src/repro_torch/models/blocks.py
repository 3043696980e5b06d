"""Composable residual blocks built from the layer library: the
decoder's transformer block (attention + SwiGLU MLP, RMSNorm) and the
Mamba2 block.  MoE and cross-attention come with later slices."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import attention, common, mamba2, mlp


def residual_scale(cfg: ArchConfig) -> float:
    """MiniCPM depth-scaled residual; 1.0 when disabled."""
    if cfg.scale_depth > 0:
        return cfg.scale_depth / (cfg.num_layers ** 0.5)
    return 1.0


def _unported(use_moe=False, cross=False, enc=None, cross_cache=None):
    if use_moe:
        raise NotImplementedError("MoE blocks are not ported yet: they come "
                                  "with the MoE slice (models/moe.py)")
    if cross or enc is not None or cross_cache is not None:
        raise NotImplementedError(
            "cross-attention is not ported yet: it comes with the "
            "encoder-decoder slice (models/encdec.py)")


# ---------------------------------------------------------------- dense
def init_tblock(kg, cfg: ArchConfig, dtype, *, use_moe=False,
                cross=False) -> dict:
    _unported(use_moe, cross)
    dev = kg.device
    p = {
        "ln1": common.ones((cfg.d_model,), dtype, dev),
        "attn": attention.init_attention(kg, cfg, dtype),
        "ln2": common.ones((cfg.d_model,), dtype, dev),
    }
    p["mlp"] = mlp.init_mlp(kg, cfg, dtype)
    return p


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
    enc=None,
    cross_cache=None,
    use_moe=False,
) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """Returns (x, kv_cache written in place or None, moe_aux)."""
    _unported(use_moe, False, enc, cross_cache)
    rs = residual_scale(cfg)
    h, new_cache = attention.apply_attention(
        p["attn"], common.rms_norm(x, p["ln1"], cfg.norm_eps), cfg=cfg,
        sh=sh, causal=causal, positions=positions, kv_cache=kv_cache,
        cache_index=cache_index)
    x = x + rs * h
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = mlp.apply_mlp(p["mlp"], common.rms_norm(x, p["ln2"], cfg.norm_eps),
                      sh=sh)
    x = x + rs * h
    return sh(x, "batch", "seq", "embed"), new_cache, aux


# ---------------------------------------------------------------- mamba
def init_mblock(kg, cfg: ArchConfig, dtype) -> dict:
    return {"ln": common.ones((cfg.d_model,), dtype, kg.device),
            "mixer": mamba2.init_mamba2(kg, cfg, dtype)}


def apply_mblock(p, x, *, cfg, sh, conv_state=None, ssm_state=None):
    h, nc, ns = mamba2.apply_mamba2(
        p["mixer"], common.rms_norm(x, p["ln"], cfg.norm_eps),
        cfg=cfg, sh=sh, conv_state=conv_state, ssm_state=ssm_state)
    return sh(x + h, "batch", "seq", "embed"), nc, ns
