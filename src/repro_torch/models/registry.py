"""ModelAPI: one uniform surface over the ported architectures.

``get_model(cfg)`` returns callables the serving and launch layers use
without knowing the family (dense, rwkv or hybrid): init / forward /
prefill / decode_step / init_cache.  ``loss`` comes with the training
slice; MoE blocks, encoder-decoder models and the ``vit_stub`` frontend
come with later slices and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import lm


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., dict]
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    prefill: Callable[..., tuple[torch.Tensor, dict]]
    decode_step: Callable[..., tuple[torch.Tensor, dict]]
    init_cache: Callable[..., dict]


def get_model(cfg: ArchConfig) -> ModelAPI:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet: they "
            "come with the encoder-decoder slice (models/encdec.py)")
    if cfg.frontend == "vit_stub":
        raise NotImplementedError(
            f"{cfg.name}: the vit_stub frontend is not ported yet: it comes "
            "with the vit_stub frontend slice")
    return _lm_api(cfg)


# ----------------------------------------------------------------- LM
def _lm_api(cfg: ArchConfig) -> ModelAPI:
    def init(generator: torch.Generator, dtype=torch.float32):
        return lm.init_lm(generator, cfg, dtype)

    def forward(params, batch, sh: ShardingCtx, remat=False):
        return lm.forward(params, batch["tokens"], cfg, sh, remat=remat)

    def prefill(params, batch, sh: ShardingCtx, max_cache: int,
                cache_dtype=None):
        return lm.prefill(params, batch["tokens"], cfg, sh, max_cache,
                          cache_dtype=cache_dtype)

    def decode_step(params, tokens, cache, cache_index, sh: ShardingCtx):
        return lm.decode_step(params, tokens, cache, cache_index, cfg, sh)

    def init_cache(batch, max_seq, dtype=torch.float32, device=None):
        return lm.init_cache(cfg, batch, max_seq, dtype, device)

    return ModelAPI(cfg=cfg, init=init, forward=forward, prefill=prefill,
                    decode_step=decode_step, init_cache=init_cache)
