"""Multi-head attention with GQA, qk-norm, QKV bias and rope (qwen3
qk_norm, qwen1.5/internvl2 bias, GQA, whisper cross-attention, zamba2
shared blocks).

Caches are preallocated ``(B, S_max, Hkv, D)`` tensors written in place
at ``cache_index`` (the JAX package's ``dynamic_update_slice`` into a
donated cache computes the same thing).  Attention longer than 1024
positions (queries or keys: whisper's cross-attention over 1,500
encoder frames takes it for a few decoder rows) takes the JAX package's
chunked route, ``flash_vjp``: the flash-attention kernel (K3) for CUDA
tensors, its plain translation on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_vjp import flash_attention as flash_vjp
from repro_torch.models import common
from repro_torch.models.rope import apply_rope


def init_attention(kg: common.KeyGen, cfg: ArchConfig, dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qdim, kvdim = cfg.num_heads * hd, cfg.num_kv_heads * hd
    p = {
        "wq": common.normal(kg(), (d, qdim), dtype),
        "wk": common.normal(kg(), (d, kvdim), dtype),
        "wv": common.normal(kg(), (d, kvdim), dtype),
        "wo": common.normal(kg(), (qdim, d), dtype,
                            std=(qdim ** -0.5) / max(cfg.num_layers, 1) ** 0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = common.zeros((qdim,), dtype, kg.device)
        p["bk"] = common.zeros((kvdim,), dtype, kg.device)
        p["bv"] = common.zeros((kvdim,), dtype, kg.device)
    if cfg.qk_norm:
        p["q_norm"] = common.ones((hd,), dtype, kg.device)
        p["k_norm"] = common.ones((hd,), dtype, kg.device)
    return p


def axes_attention(cfg: ArchConfig) -> dict:
    ax = {
        "wq": ("embed", "heads_fused"),
        "wk": ("embed", "kv_fused"),
        "wv": ("embed", "kv_fused"),
        "wo": ("heads_fused", "embed"),
    }
    if cfg.qkv_bias:
        ax["bq"] = ("heads_fused",)
        ax["bk"] = ("kv_fused",)
        ax["bv"] = ("kv_fused",)
    if cfg.qk_norm:
        ax["q_norm"] = (None,)
        ax["k_norm"] = (None,)
    return ax


def _project_qkv(p, x, xk, cfg: ArchConfig, sh: ShardingCtx):
    hd = cfg.resolved_head_dim
    B, S = x.shape[:2]
    Sk = xk.shape[1]
    q = common.dot(x, p["wq"])
    k = common.dot(xk, p["wk"])
    v = common.dot(xk, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, Sk, cfg.num_kv_heads, hd)
    v = v.reshape(B, Sk, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = common.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = sh(q, "batch", "seq", "act_heads", None)
    k = sh(k, "batch", "seq", "cache_heads", None)
    v = sh(v, "batch", "seq", "cache_heads", None)
    return q, k, v


def _pick_impl(seq: int) -> str:
    # naive materializes (Sq,Sk) logits — fine for short seq, flash beyond
    return "naive" if seq <= 1024 else "chunked"


def apply_attention(
    p: dict,
    x: torch.Tensor,                     # (B, S, d)
    *,
    cfg: ArchConfig,
    sh: ShardingCtx,
    positions: torch.Tensor | None = None,  # (S,) or (B,S)
    causal: bool = True,
    use_rope: bool = True,
    xk: torch.Tensor | None = None,      # cross-attention source
    kv_cache: dict | None = None,        # {"k": (B,Smax,Hkv,D), "v": ...}
    cache_index: int | None = None,      # write offset / valid length
) -> tuple[torch.Tensor, dict | None]:
    """Returns (output, kv_cache written in place, or None).

    Modes:
    - no cache: full (causal) attention over x, or over ``xk`` when it is
      given (cross-attention: no rope, no cache);
    - cache + S>=1: prefill-into-cache or single-token decode; new keys
      are written at ``cache_index`` and attention spans the first
      ``cache_index + S`` cache slots.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    xk_src = x if xk is None else xk
    q, k, v = _project_qkv(p, x, xk_src, cfg, sh)

    if use_rope and cfg.pos_scheme == "rope" and xk is None:
        if positions is None:
            base = 0 if cache_index is None else cache_index
            positions = base + torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None and xk is None:
        idx = 0 if cache_index is None else int(cache_index)
        kc, vc = kv_cache["k"], kv_cache["v"]
        if idx + S > kc.shape[1]:
            raise ValueError(f"cache of {kc.shape[1]} slots cannot take "
                             f"{S} positions at {idx}")
        kc[:, idx:idx + S] = k.to(kc.dtype)
        vc[:, idx:idx + S] = v.to(vc.dtype)
        new_cache = kv_cache
        if S == 1:
            out = kops.decode_attention(q, kc, vc, idx + 1)
        else:
            # prefill into cache: with causal masking at offset ``idx`` the
            # not-yet-written cache tail (> idx+S) is never attended.
            if _pick_impl(kc.shape[1]) == "naive":
                out = kref.naive_attention(q, kc, vc, causal=causal,
                                           kv_len=idx + S, q_offset=idx)
            else:
                out = flash_vjp(q, kc, vc, idx, True, None, 512, 1024)
    else:
        impl = _pick_impl(max(S, xk_src.shape[1]))
        if impl == "chunked":
            # flash with a flash backward (O(block^2) memory both passes)
            out = flash_vjp(q, k, v, 0, causal, None, 512, 1024)
        else:
            out = kops.flash_attention(q, k, v, causal=causal, impl=impl)

    out = sh(out, "batch", "seq", "act_heads", None)
    out = out.reshape(B, S, cfg.num_heads * hd)
    return common.dot(out, p["wo"]), new_cache


def apply_cross_attention_cached(
    p: dict,
    x: torch.Tensor,          # (B, S, d) decoder hidden
    cross_cache: dict,        # {"k": (B,Se,Hkv,D), "v": ...} from the encoder
    *,
    cfg: ArchConfig,
    sh: ShardingCtx,
) -> torch.Tensor:
    """Decode-time cross-attention: q from x, K/V from the prefill cache
    (every encoder slot valid), on the plain decode attention."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = common.dot(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, p["q_norm"], cfg.norm_eps)
    out = kops.decode_attention(q, cross_cache["k"], cross_cache["v"],
                                cross_cache["k"].shape[1])
    out = out.reshape(B, S, cfg.num_heads * hd)
    return common.dot(out, p["wo"])


def make_cross_cache(p: dict, enc: torch.Tensor, cfg: ArchConfig,
                     sh: ShardingCtx) -> dict:
    """K/V of the encoder output for the decoder's cross-attention."""
    B, Se, _ = enc.shape
    hd = cfg.resolved_head_dim
    k = common.dot(enc, p["wk"])
    v = common.dot(enc, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(B, Se, cfg.num_kv_heads, hd)
    v = v.reshape(B, Se, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        k = common.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return {"k": sh(k, "batch", "seq", "cache_heads", None),
            "v": sh(v, "batch", "seq", "cache_heads", None)}
