"""ModelAPI: one uniform surface over the ported architectures.

``get_model(cfg)`` returns callables the serving and launch layers use
without knowing the family (dense, moe, vlm, rwkv, hybrid or the
encoder-decoder): init / forward / loss / prefill / decode_step /
init_cache, and the logical-axis trees of the parameters and of the
cache (what the sharding rules map onto a mesh); :func:`param_shapes`
gives the full shapes of the parameters without storage.  A
``vit_stub`` model's batch carries
``patch_embeds`` (B, P, d), an encoder-decoder's ``frames`` (B, Se, d).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import common, encdec, lm


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., dict]
    param_axes: Callable[[], dict]
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    loss: Callable[..., tuple[torch.Tensor, dict]]
    prefill: Callable[..., tuple[torch.Tensor, dict]]
    decode_step: Callable[..., tuple[torch.Tensor, dict]]
    init_cache: Callable[..., dict]
    cache_axes: Callable[[], dict]


def token_start(cfg: ArchConfig) -> int:
    """Cache slots ahead of the first token: a ``vit_stub`` model's
    patches (the serving layer's prompt offset)."""
    return cfg.num_patches if cfg.frontend == "vit_stub" else 0


def vocab_split(cfg: ArchConfig, sh: ShardingCtx) -> ShardingCtx | None:
    """``sh`` when its model axis splits the vocabulary (the logits are
    then this rank's block of it), else ``None``."""
    return sh if sh.split("vocab", cfg.padded_vocab) else None


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: an init
    through it gives the parameters' shapes and dtypes, no storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


class HostGenerator(torch.Generator):
    """A card's generator whose init keeps the tree in host memory: each
    drawn leaf is drawn on the card (the values of an init through a
    plain generator of that card) and moved to the host, and every other
    leaf is made there, so the card holds one leaf at a time.  A rank of
    a sharded mesh starts from it and takes its shards to the card."""

    @property
    def device(self) -> torch.device:
        return torch.device("cpu")

    @property
    def draws_on(self) -> torch.device:
        return torch.Generator.device.__get__(self)


def param_shapes(model: ModelAPI, dtype=torch.float32) -> dict:
    """The parameter tree of ``model`` as ``meta`` tensors (full
    shapes)."""
    return model.init(_MetaGenerator(), dtype=dtype)


def get_model(cfg: ArchConfig) -> ModelAPI:
    if cfg.is_encoder_decoder:
        return _encdec_api(cfg)
    return _lm_api(cfg)


# ----------------------------------------------------------------- LM
def _next_tokens(batch):
    """Next-token labels and their mask: every token after the first
    (the logits that predict them run from the first token's slot, past
    a vit_stub model's patches, to the one before the last)."""
    mask = batch.get("mask")
    return batch["tokens"][:, 1:], None if mask is None else mask[:, 1:]


def _lm_api(cfg: ArchConfig) -> ModelAPI:
    P = token_start(cfg)

    def init(generator: torch.Generator, dtype=torch.float32):
        return lm.init_lm(generator, cfg, dtype)

    def forward(params, batch, sh: ShardingCtx, remat=False):
        return lm.forward(params, batch["tokens"], cfg, sh,
                          extra_embeds=batch.get("patch_embeds"), remat=remat)

    def loss(params, batch, sh: ShardingCtx, remat=True):
        logits, aux = forward(params, batch, sh, remat=remat)
        labels, mask = _next_tokens(batch)
        ce, ntok = common.cross_entropy_loss(logits[:, P:-1], labels,
                                             cfg.vocab_size, mask,
                                             vocab_split(cfg, sh))
        return ce + aux, {"ce": ce, "aux": aux, "ntok": ntok}

    def prefill(params, batch, sh: ShardingCtx, max_cache: int,
                cache_dtype=None):
        return lm.prefill(params, batch["tokens"], cfg, sh, max_cache,
                          extra_embeds=batch.get("patch_embeds"),
                          cache_dtype=cache_dtype)

    def decode_step(params, tokens, cache, cache_index, sh: ShardingCtx):
        return lm.decode_step(params, tokens, cache, cache_index, cfg, sh)

    def init_cache(batch, max_seq, dtype=torch.float32, device=None,
                   sh: ShardingCtx | None = None):
        return lm.init_cache(cfg, batch, max_seq, dtype, device, sh=sh)

    return ModelAPI(cfg=cfg, init=init, param_axes=lambda: lm.lm_axes(cfg),
                    forward=forward, loss=loss, prefill=prefill,
                    decode_step=decode_step, init_cache=init_cache,
                    cache_axes=lambda: lm.cache_axes(cfg))


# ------------------------------------------------------------- enc-dec
def _encdec_api(cfg: ArchConfig) -> ModelAPI:
    def init(generator: torch.Generator, dtype=torch.float32):
        return encdec.init_encdec(generator, cfg, dtype)

    def forward(params, batch, sh: ShardingCtx, remat=False):
        return encdec.forward(params, batch["frames"], batch["tokens"], cfg,
                              sh, remat=remat)

    def loss(params, batch, sh: ShardingCtx, remat=True):
        logits, aux = forward(params, batch, sh, remat=remat)
        labels, mask = _next_tokens(batch)
        ce, ntok = common.cross_entropy_loss(logits[:, :-1], labels,
                                             cfg.vocab_size, mask,
                                             vocab_split(cfg, sh))
        return ce + aux, {"ce": ce, "aux": aux, "ntok": ntok}

    def prefill(params, batch, sh: ShardingCtx, max_cache: int,
                cache_dtype=None):
        return encdec.prefill(params, batch["frames"], batch["tokens"], cfg,
                              sh, max_cache, cache_dtype=cache_dtype)

    def decode_step(params, tokens, cache, cache_index, sh: ShardingCtx):
        return encdec.decode_step(params, tokens, cache, cache_index, cfg, sh)

    def init_cache(batch, max_seq, dtype=torch.float32, device=None,
                   sh: ShardingCtx | None = None):
        return encdec.init_cache(cfg, batch, max_seq, dtype, device, sh=sh)

    return ModelAPI(cfg=cfg, init=init,
                    param_axes=lambda: encdec.encdec_axes(cfg),
                    forward=forward, loss=loss, prefill=prefill,
                    decode_step=decode_step, init_cache=init_cache,
                    cache_axes=lambda: encdec.cache_axes(cfg))
