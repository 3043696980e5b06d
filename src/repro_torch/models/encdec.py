"""Whisper-style encoder-decoder.  The conv/mel frontend is a stub, as in
the JAX package: the encoder takes precomputed frame embeddings
(B, Se, d).

Parameters are laid out as the JAX package's tree (``enc_blocks`` and
``dec_blocks`` stacked on a leading layer axis), so
``repro_torch.interop.params_from_jax`` carries one over leaf for leaf.
The reference's ``lax.scan`` over the stack becomes a Python loop over
per-layer views, and the caches — self-attention ``k``/``v`` of
``max_cache`` slots and the encoder's cross-attention ``xk``/``xv`` —
are preallocated stacked tensors written in place.  On a card the
encoder's self-attention over more than 1024 frames and the decoder's
cross-attention over them take the flash route (K3, not causal).
Under tensor parallelism the encoder, the decoder's self- and
cross-attention and the tied vocab-parallel embedding go through the
same functions as the decoder-only models (``models/lm.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import attention, blocks, common
from repro_torch.models.lm import (cache_slots, kv_layer, layer,
                                  local_cache, prepend_axis, run_body,
                                  stack_init, unstack, vocab_head,
                                  vocab_lookup)

_BLOCK = dict(mlp_kind="gelu", norm="layer")


def init_encdec(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32) -> dict:
    """Random parameters drawn from ``generator`` on its device."""
    kg = common.KeyGen(generator)
    dev = kg.device
    return {
        "embed": common.normal(kg(), (cfg.padded_vocab, cfg.d_model), dtype,
                               std=0.02),
        "enc_blocks": stack_init(
            lambda k: blocks.init_tblock(k, cfg, dtype, **_BLOCK),
            kg, cfg.num_encoder_layers),
        "enc_norm": common.ones((cfg.d_model,), dtype, dev),
        "enc_norm_b": common.zeros((cfg.d_model,), dtype, dev),
        "dec_blocks": stack_init(
            lambda k: blocks.init_tblock(k, cfg, dtype, cross=True, **_BLOCK),
            kg, cfg.num_layers),
        "dec_norm": common.ones((cfg.d_model,), dtype, dev),
        "dec_norm_b": common.zeros((cfg.d_model,), dtype, dev),
    }


def encdec_axes(cfg: ArchConfig) -> dict:
    return {
        "embed": ("vocab", "embed"),
        "enc_blocks": prepend_axis(blocks.axes_tblock(cfg, **_BLOCK)),
        "enc_norm": (None,), "enc_norm_b": (None,),
        "dec_blocks": prepend_axis(blocks.axes_tblock(cfg, cross=True,
                                                      **_BLOCK)),
        "dec_norm": (None,), "dec_norm_b": (None,),
    }


def encode(params, frames, cfg: ArchConfig, sh: ShardingCtx,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, Se, d) precomputed frontend embeddings.  With
    ``remat`` each encoder layer is recomputed in the backward."""
    pos = common.sinusoidal_positions(
        torch.arange(frames.shape[1], device=frames.device), cfg.d_model,
        frames.dtype)
    h = sh(frames + pos[None], "batch", "seq", "embed")

    def body(x, bp):
        return blocks.apply_tblock(bp, x, cfg=cfg, sh=sh, causal=False,
                                   **_BLOCK)[0]
    for bp in unstack(params["enc_blocks"]):
        h = run_body(body, remat, h, bp)
    return common.layer_norm(h, params["enc_norm"], params["enc_norm_b"],
                             cfg.norm_eps)


def _dec_embed(params, tokens, cfg, sh, offset=0):
    h = vocab_lookup(params["embed"], tokens, cfg, sh)
    pos = common.sinusoidal_positions(
        torch.arange(tokens.shape[1], device=h.device) + offset, cfg.d_model,
        h.dtype)
    return sh(h + pos[None], "batch", "seq", "embed")


def _logits(params, h, cfg, sh):
    h = common.layer_norm(h, params["dec_norm"], params["dec_norm_b"],
                          cfg.norm_eps)
    # whisper ties the decoder embedding
    return vocab_head(h, params["embed"].T, cfg, sh)


def forward(params, frames, tokens, cfg: ArchConfig, sh: ShardingCtx,
            *, remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced pass -> (logits (B,S,Vp), aux=0).  With ``remat``
    each encoder and each decoder layer is recomputed in the backward."""
    enc = encode(params, frames, cfg, sh, remat=remat)
    h = _dec_embed(params, tokens, cfg, sh)

    def body(x, bp, enc):
        return blocks.apply_tblock(bp, x, cfg=cfg, sh=sh, causal=True,
                                   enc=enc, **_BLOCK)[0]
    for bp in unstack(params["dec_blocks"]):
        h = run_body(body, remat, h, bp, enc)
    logits = sh(_logits(params, h, cfg, sh), "batch", "seq", "vocab")
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, device=None, enc_len: int | None = None,
               sh: ShardingCtx | None = None) -> dict:
    """Self-attention ``k``/``v`` of ``max_seq`` slots and cross-attention
    ``xk``/``xv`` of ``enc_len`` (default ``cfg.encoder_seq_len``); under
    a model axis above one rank, this rank's shards of them."""
    if sh is not None and sh.tp > 1:
        full = init_cache(cfg, batch, max_seq, dtype, "meta", enc_len)
        return local_cache(full, cache_axes(cfg), sh, max_seq, device)
    hd = cfg.resolved_head_dim
    L, H = cfg.num_layers, cfg.num_kv_heads
    Se = cfg.encoder_seq_len if enc_len is None else enc_len

    def z(n):
        return torch.zeros((L, batch, n, H, hd), dtype=dtype, device=device)

    return {"k": z(max_seq), "v": z(max_seq), "xk": z(Se), "xv": z(Se)}


def cache_axes(cfg: ArchConfig) -> dict:
    """The logical axes of every leaf of :func:`init_cache`'s tree."""
    kv = ("layers", "batch", "cache_seq", "cache_heads", None)
    enc_kv = ("layers", "batch", None, "cache_heads", None)
    return {"k": kv, "v": kv, "xk": enc_kv, "xv": enc_kv}


def prefill(params, frames, tokens, cfg: ArchConfig, sh: ShardingCtx,
            max_cache: int, cache_dtype=None) -> tuple[torch.Tensor, dict]:
    """Encode the frames + prefill the decoder tokens -> (last logits
    (B,Vp), cache)."""
    enc = encode(params, frames, cfg, sh)
    h = _dec_embed(params, tokens, cfg, sh)
    cache = init_cache(cfg, tokens.shape[0], max_cache,
                       cache_dtype or h.dtype, h.device, enc.shape[1], sh=sh)
    for li in range(cfg.num_layers):
        bp = layer(params["dec_blocks"], li)
        h, _, _ = blocks.apply_tblock(
            bp, h, cfg=cfg, sh=sh, causal=True, enc=enc,
            kv_cache={"k": cache["k"][li], "v": cache["v"][li],
                      "slots": max_cache},
            cache_index=0, **_BLOCK)
        xc = attention.make_cross_cache(bp["xattn"], enc, cfg, sh)
        cache["xk"][li] = xc["k"]
        cache["xv"][li] = xc["v"]
    return _logits(params, h[:, -1:], cfg, sh)[:, 0], cache


def decode_step(params, tokens, cache, cache_index: int, cfg: ArchConfig,
                sh: ShardingCtx) -> tuple[torch.Tensor, dict]:
    """tokens (B,1); returns (logits (B,Vp), the cache, updated in place)."""
    cache_index = int(cache_index)
    slots = cache_slots(cache)
    h = _dec_embed(params, tokens, cfg, sh, offset=cache_index)
    for li in range(cfg.num_layers):
        h, _, _ = blocks.apply_tblock(
            layer(params["dec_blocks"], li), h, cfg=cfg, sh=sh, causal=True,
            kv_cache=kv_layer(cache, li, slots), cache_index=cache_index,
            cross_cache={"k": cache["xk"][li], "v": cache["xv"][li]},
            **_BLOCK)
    return _logits(params, h, cfg, sh)[:, 0], cache
