"""Mamba2 mixer layer (zamba2 trunk): fused in-proj, causal depthwise
conv, SSD selective-state-space scan, gated RMSNorm, out-proj.

Under tensor parallelism each rank keeps the shards its specs name:
``in_proj``'s fused ``[z | xBC | dt]`` columns split contiguously, which
is not head-aligned (at zamba2's width rank 0 of 2 holds all of ``z``
and 104 columns of ``xBC``).  The layer regroups the projection's
output with one all-gather over the model axis of the whole fused
(B, S, 2·d_inner + 2·G·N + H) projection — B·S·10,448 floats at
zamba2's width, 128 MB in float32 at 2 × 1,536 tokens, each rank
receiving the others' blocks — then each rank takes its H/tp heads'
``z``, ``x`` and ``dt`` and the shared ``B`` and ``C``.  The
conv weights (``ssm_inner``-split, equally cut across heads) are
gathered — a (W, conv_dim) leaf — and the conv runs on the rank's
channels; the conv state keeps its spec's block of channels and the
replicated SSM state every head, each rebuilt from the gathered
values.  K4 (the SSD scan) runs on the rank's heads, the gated RMSNorm
takes its sum of squares over the model axis, and ``out_proj``, whose
rows are head-aligned, is row-parallel.  At one rank every collective
is the identity and the rank holds every head, so the same code is the
single-device layer.  Where the heads (or groups, or ``d_inner``) do
not split into whole heads over the model axis, the reference's rules
replicate the dim: every rank gathers the split leaves and computes
every head (:func:`_apply_whole`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import REPLICATED, ShardingCtx
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
    with a cache is the O(1) recurrence in plain code.  The scan runs on
    this rank's H/tp heads (every head at tp 1; see the module docstring
    for the layout)."""
    B, S, _ = x.shape
    di, H, N, G = (cfg.mamba_d_inner, cfg.mamba_nheads, cfg.ssm_state,
                   cfg.mamba_ngroups)
    P, tp, f32 = cfg.mamba_head_dim, sh.tp, torch.float32
    cd = conv_dim(cfg)
    nh = H // tp
    if tp > 1 and (H % tp or (G > 1 and nh % (H // G))
                   or not sh.split("ssm_inner", di)):
        return _apply_whole(p, x, cfg, sh, conv_state, ssm_state)
    h0 = sh.model_index * nh
    g0, ng = (h0 * G // H, max(nh * G // H, 1))
    caching = conv_state is not None
    dev = x.device

    # the regroup: every rank the whole fused projection, then its part
    if sh.split("ssm_inner", 2 * di + 2 * G * N + H):
        proj = sh.gather(common.dot(sh.copy(x), p["in_proj"]), -1,
                         summed=True)
    else:
        proj = sh.copy(common.dot(x, p["in_proj"]))
    z = proj[..., h0 * P:(h0 + nh) * P]
    xbc_all = proj[..., di:di + cd]
    dt = proj[..., di + cd + h0:di + cd + h0 + nh]
    chans = None
    if nh < H:   # this rank's conv channels: its heads' x, its groups' B, C
        chans = torch.cat([
            torch.arange(h0 * P, (h0 + nh) * P, device=dev),
            di + torch.arange(g0 * N, (g0 + ng) * N, device=dev),
            di + G * N + torch.arange(g0 * N, (g0 + ng) * N, device=dev)])

    def own(t):
        return t if chans is None else t.index_select(-1, chans)

    conv_split = sh.split("ssm_inner", cd)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if conv_split:
        conv_w = sh.gather(conv_w, -1, summed=True)
        conv_b = sh.gather(conv_b, -1, summed=True)
    else:
        conv_w, conv_b = sh.copy(conv_w), sh.copy(conv_b)
    state_all = None
    if caching:
        state_all = sh.gather(conv_state, -1) if conv_split else conv_state
    xbc, _ = _causal_conv(own(xbc_all), own(conv_w), own(conv_b),
                          None if state_all is None else own(state_all))
    new_conv = None
    if caching:
        W = conv_w.shape[0]
        new_conv = torch.cat([state_all.to(xbc_all.dtype), xbc_all],
                             dim=1)[:, S:S + W - 1]
        if conv_split:
            new_conv = sh.axis("model").block(new_conv, -1)
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [nh * P, ng * N, ng * N], dim=-1)
    Bm = Bm.reshape(B, S, ng, N)
    Cm = Cm.reshape(B, S, ng, N)
    xh = xs.reshape(B, S, nh, P)
    mine = slice(h0, h0 + nh)
    dt = F.softplus(dt.to(f32) + sh.copy(p["dt_bias"])[mine])
    A = -torch.exp(sh.copy(p["A_log"])[mine])
    D = sh.copy(p["D"])[mine]

    state0 = ssm_state[:, mine] if caching else None
    if caching and S == 1:
        y, new_ssm = _ssm_step(xh, dt, A, Bm, Cm, D, state0, x.dtype)
    else:
        y, new_ssm = kops.mamba2_ssd(xh, dt, A, Bm, Cm, D, state=state0)

    # gated RMSNorm over the whole d_inner: the sum of squares over ranks
    g = (y.reshape(B, S, nh * P) * F.silu(z)).to(f32)
    ss = sh.copy(sh.reduce(torch.sum(torch.square(g), -1, keepdim=True)))
    y = (g * torch.rsqrt(ss / di + cfg.norm_eps)
         * p["norm"].to(f32)).to(x.dtype)
    out = common.row_parallel(y, p["out_proj"], sh, True)
    if not caching:
        return out, None, None
    return out, new_conv, sh.gather(new_ssm, 1)


def _apply_whole(p, x, cfg, sh, conv_state, ssm_state):
    """The layer on every rank with every head, when its heads (or
    groups, or ``d_inner``) do not split into whole heads over the model
    axis: the reference's rules then replicate the dim, so the rank
    gathers the leaves its specs split, computes the single-device
    layer, and keeps its block of a conv state split by channels."""
    d, di = cfg.d_model, cfg.mamba_d_inner
    H, N, G, W = (cfg.mamba_nheads, cfg.ssm_state, cfg.mamba_ngroups,
                  cfg.mamba_conv_width)
    cd = conv_dim(cfg)
    full = {"in_proj": (d, 2 * di + 2 * G * N + H), "conv_w": (W, cd),
            "conv_b": (cd,), "norm": (di,), "out_proj": (di, d)}
    p = common.gather_whole(p, full, axes_mamba2(cfg), sh)
    conv_split = sh.split("ssm_inner", cd)
    if conv_state is not None and conv_split:
        conv_state = sh.gather(conv_state, -1)
    out, new_conv, new_ssm = apply_mamba2(p, x, cfg=cfg, sh=REPLICATED,
                                          conv_state=conv_state,
                                          ssm_state=ssm_state)
    if new_conv is not None and conv_split:
        new_conv = sh.axis("model").block(new_conv, -1)
    return out, new_conv, new_ssm


def _ssm_step(xh, dt, A, Bm, Cm, D, ssm_state, dtype):
    """The O(1) recurrent decode step of (B, 1, H, P) inputs."""
    f32 = torch.float32
    rep = xh.shape[2] // Bm.shape[2]
    bt = Bm[:, 0].to(f32).repeat_interleave(rep, dim=1)          # (B,H,N)
    ct = Cm[:, 0].to(f32).repeat_interleave(rep, dim=1)
    dtt = dt[:, 0]                                               # (B,H)
    decay = torch.exp(A[None] * dtt)[..., None, None]
    x0 = xh[:, 0].to(f32)
    h_new = decay * ssm_state + (dtt[..., None, None] * x0[..., :, None]
                                 * bt[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", h_new, ct)
    y = y + D[None, :, None] * x0
    return y[:, None].to(dtype), h_new
