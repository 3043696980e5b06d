"""Feed-forward layer: SwiGLU (llama-family; the GELU MLP of whisper
comes with the encoder-decoder slice)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import common


def init_mlp(kg: common.KeyGen, cfg: ArchConfig, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    depth_std = (f ** -0.5) / max(cfg.num_layers, 1) ** 0.5
    return {
        "w_gate": common.normal(kg(), (d, f), dtype),
        "w_up": common.normal(kg(), (d, f), dtype),
        "w_down": common.normal(kg(), (f, d), dtype, std=depth_std),
    }


def apply_mlp(p: dict, x: torch.Tensor, *, sh: ShardingCtx) -> torch.Tensor:
    h = common.swiglu(x @ p["w_gate"], x @ p["w_up"])
    h = sh(h, "batch", "seq", "act_ff")
    return h @ p["w_down"]
