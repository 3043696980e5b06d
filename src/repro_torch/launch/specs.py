"""``input_specs()`` — shape-and-dtype stand-ins for every model input.

No memory is allocated: each stand-in is a tensor on PyTorch's ``meta``
device (the JAX package's ``ShapeDtypeStruct``), with the shape and
dtype of the input it stands for.  The modality front ends are stubs,
so vision cells receive precomputed patch embeddings and audio cells
precomputed frame embeddings as inputs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import get_model


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                      embed_dtype=torch.bfloat16) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.frontend == "vit_stub":
        batch["tokens"] = _meta((B, S - cfg.num_patches), torch.int32)
        batch["patch_embeds"] = _meta((B, cfg.num_patches, cfg.d_model),
                                      embed_dtype)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if cfg.is_encoder_decoder:
        batch["frames"] = _meta((B, cfg.encoder_seq_len, cfg.d_model),
                                embed_dtype)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                        embed_dtype=torch.bfloat16) -> dict:
    return train_batch_specs(cfg, shape, embed_dtype)


def decode_specs(cfg: ArchConfig, shape: ShapeConfig,
                 cache_dtype=torch.bfloat16) -> dict:
    """Inputs for serve_step: one new token + a ``seq_len`` cache."""
    B, S = shape.global_batch, shape.seq_len
    cache = get_model(cfg).init_cache(B, S, cache_dtype, device="meta")
    return {"tokens": _meta((B, 1), torch.int32), "cache": cache,
            "cache_index": _meta((), torch.int32)}


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> dict:
    if shape.kind == "train":
        return train_batch_specs(cfg, shape, dtype)
    if shape.kind == "prefill":
        return prefill_batch_specs(cfg, shape, dtype)
    return decode_specs(cfg, shape, dtype)
