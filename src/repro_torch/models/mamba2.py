"""Mamba2 mixer layer (zamba2 trunk): fused in-proj, causal depthwise
conv, SSD selective-state-space scan, gated RMSNorm, out-proj."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.kernels import ops as kops
from repro_torch.models import common


def conv_dim(cfg: ArchConfig) -> int:
    return cfg.mamba_d_inner + 2 * cfg.mamba_ngroups * cfg.ssm_state


def init_mamba2(kg: common.KeyGen, cfg: ArchConfig, dtype) -> dict:
    d, di = cfg.d_model, cfg.mamba_d_inner
    H, N, G, W = (cfg.mamba_nheads, cfg.ssm_state, cfg.mamba_ngroups,
                  cfg.mamba_conv_width)
    cd = conv_dim(cfg)
    dev = kg.device
    f32 = torch.float32
    a_log = np.log(np.linspace(1.0, 16.0, H, dtype=np.float32))
    dt_bias = np.log(np.expm1(np.linspace(1e-3, 0.1, H, dtype=np.float32)))
    return {
        "in_proj": common.normal(kg(), (d, 2 * di + 2 * G * N + H), dtype),
        "conv_w": common.normal(kg(), (W, cd), dtype, std=W ** -0.5),
        "conv_b": common.zeros((cd,), dtype, dev),
        "A_log": torch.from_numpy(a_log.astype(np.float32)).to(dev, f32),
        "D": common.ones((H,), f32, dev),
        "dt_bias": torch.from_numpy(dt_bias.astype(np.float32)).to(dev, f32),
        "norm": common.ones((di,), dtype, dev),
        "out_proj": common.normal(
            kg(), (di, d), dtype,
            std=(di ** -0.5) / max(cfg.num_layers, 1) ** 0.5),
    }


def axes_mamba2(cfg: ArchConfig) -> dict:
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": ("conv_k", "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv via static shift-sum (W is small).

    xBC: (B, S, cd); conv_state: (B, W-1, cd) trailing context or None.
    Returns (out (B,S,cd), new_state (B, W-1, cd))."""
    W = conv_w.shape[0]
    B, S, cd = xBC.shape
    if conv_state is None:
        conv_state = torch.zeros((B, W - 1, cd), dtype=xBC.dtype,
                                 device=xBC.device)
    xp = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)  # (B, S+W-1, cd)
    out = conv_w[0] * xp[:, 0:S]
    for i in range(1, W):
        out = out + conv_w[i] * xp[:, i:i + S]
    out = out + conv_b
    new_state = xp[:, S:S + W - 1]
    return out, new_state


def apply_mamba2(
    p: dict,
    x: torch.Tensor,                          # (B, S, d)
    *,
    cfg: ArchConfig,
    sh: ShardingCtx,
    conv_state: torch.Tensor | None = None,   # (B, W-1, cd)
    ssm_state: torch.Tensor | None = None,    # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """Returns (out, new_conv_state, new_ssm_state); states None <=> no
    cache.  Prefill and no-cache forward run the SSD scan through
    ``kernels.ops.mamba2_ssd`` (the kernel on CUDA); a one-token step
    with a cache is the O(1) recurrence in plain code."""
    B, S, _ = x.shape
    di, H, N, G = (cfg.mamba_d_inner, cfg.mamba_nheads, cfg.ssm_state,
                   cfg.mamba_ngroups)
    P = cfg.mamba_head_dim
    caching = conv_state is not None
    f32 = torch.float32

    proj = x @ p["in_proj"]
    proj = sh(proj, "batch", "seq", "ssm_inner")
    # jnp.split takes indices [di, 2di+2GN]; torch.split takes sizes
    z, xBC, dt = torch.split(proj, [di, di + 2 * G * N, H], dim=-1)

    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                 conv_state if caching else None)
    xBC = F.silu(xBC)
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    xh = xs.reshape(B, S, H, P)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if caching and S == 1:
        # O(1) recurrent decode step
        rep = H // G
        bt = Bm[:, 0].to(f32).repeat_interleave(rep, dim=1)      # (B,H,N)
        ct = Cm[:, 0].to(f32).repeat_interleave(rep, dim=1)
        dtt = dt[:, 0]                                           # (B,H)
        decay = torch.exp(A[None] * dtt)[..., None, None]
        x0 = xh[:, 0].to(f32)
        h_new = decay * ssm_state + (dtt[..., None, None] * x0[..., :, None]
                                     * bt[..., None, :])
        y = torch.einsum("bhpn,bhn->bhp", h_new, ct)
        y = y + p["D"][None, :, None] * x0
        y = y[:, None].to(x.dtype)                               # (B,1,H,P)
        new_ssm = h_new
    else:
        y, new_ssm = kops.mamba2_ssd(xh, dt, A, Bm, Cm, p["D"],
                                     state=ssm_state if caching else None)

    y = y.reshape(B, S, di)
    y = common.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    y = sh(y, "batch", "seq", "ssm_inner")
    out = y @ p["out_proj"]
    return out, (new_conv if caching else None), (new_ssm if caching else None)
