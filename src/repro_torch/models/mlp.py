"""Feed-forward layers: SwiGLU (llama-family) and GELU (whisper).

Under tensor parallelism ``ff`` is column-parallel (each rank holds a
block of the hidden columns) and the down projection row-parallel:
one sum over the model axis per layer."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import common


def init_mlp(kg: common.KeyGen, cfg: ArchConfig, dtype,
             kind: str = "swiglu") -> dict:
    d, f = cfg.d_model, cfg.d_ff
    depth_std = (f ** -0.5) / max(cfg.num_layers, 1) ** 0.5
    if kind == "swiglu":
        return {
            "w_gate": common.normal(kg(), (d, f), dtype),
            "w_up": common.normal(kg(), (d, f), dtype),
            "w_down": common.normal(kg(), (f, d), dtype, std=depth_std),
        }
    return {
        "w_in": common.normal(kg(), (d, f), dtype),
        "b_in": common.zeros((f,), dtype, kg.device),
        "w_out": common.normal(kg(), (f, d), dtype, std=depth_std),
        "b_out": common.zeros((d,), dtype, kg.device),
    }


def axes_mlp(cfg: ArchConfig, kind: str = "swiglu") -> dict:
    if kind == "swiglu":
        return {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
                "w_down": ("ff", "embed")}
    return {"w_in": ("embed", "ff"), "b_in": ("ff",),
            "w_out": ("ff", "embed"), "b_out": ("embed",)}


def apply_mlp(p: dict, x: torch.Tensor, *, sh: ShardingCtx,
              kind: str = "swiglu", cfg: ArchConfig | None = None
              ) -> torch.Tensor:
    if cfg is None and sh.tp > 1:
        raise ValueError("a tensor-parallel MLP needs its cfg (d_ff)")
    split = cfg is not None and sh.split("ff", cfg.d_ff)
    xc = sh.copy(x) if split else x
    if kind == "swiglu":
        h = common.swiglu(common.dot(xc, p["w_gate"]), common.dot(xc, p["w_up"]))
        h = sh(h, "batch", "seq", "act_ff")
        return common.row_parallel(h, p["w_down"], sh, split)
    # the exact erf form, as the reference's gelu(approximate=False)
    h = F.gelu(common.dot(xc, p["w_in"]) + p["b_in"])
    h = sh(h, "batch", "seq", "act_ff")
    return common.row_parallel(h, p["w_out"], sh, split) + p["b_out"]
