"""Shared building blocks: initializers, norms, positions, the loss."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


class KeyGen:
    """Deterministic stream of random draws over one explicit
    ``torch.Generator`` (the JAX package's fold_in counter becomes the
    generator's consumption order: the same calls in the same order give
    the same tensors)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def __call__(self) -> torch.Generator:
        return self.generator


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def normal(gen: torch.Generator, shape, dtype, std: float | None = None):
    """Truncated-normal init in [-3, 3] standard deviations; default std
    = 1/sqrt(fan_in), fan_in = shape[0] for a matrix.  Drawn by inverse
    transform (uniform in [phi(-3), phi(3)], then erfinv) on the
    generator's device, in float32, then cast."""
    if std is None:
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
        std = fan_in ** -0.5
    lo, hi = _phi(-3.0), _phi(3.0)
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0).mul_(std)
    return t.to(dtype)


def zeros(shape, dtype, device=None):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, dtype, device=None):
    return torch.ones(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over the last dim split into ``groups`` (RWKV head norm)."""
    dtype = x.dtype
    *lead, d = x.shape
    x = x.to(torch.float32).reshape(*lead, groups, d // groups)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = ((x - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dtype)


# ------------------------------------------------------------- positions
def sinusoidal_positions(positions: torch.Tensor, dim: int,
                         dtype=torch.float32) -> torch.Tensor:
    """Transformer sinusoidal embeddings for integer ``positions`` (...,)."""
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(positions.device)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ------------------------------------------------------------------ loss
def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_size: int, mask: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked token-mean cross entropy in float32 over (..., V_padded)
    logits -> (loss, token count, at least 1).  Padded vocabulary slots
    get ``-1e30`` before the log-sum-exp, so they stay out of the
    normaliser."""
    logits = logits.to(torch.float32)
    v_pad = logits.shape[-1]
    if v_pad > vocab_size:
        bias = torch.zeros(v_pad, dtype=torch.float32, device=logits.device)
        bias[vocab_size:] = -1e30
        logits = logits + bias
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].to(
        device=logits.device, dtype=torch.int64))[..., 0]
    nll = logz - picked
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    mask = mask.to(device=logits.device, dtype=torch.float32)
    total = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / total, total


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the JAX package's type promotion: operands of two
    dtypes (an encoder-decoder's float32 frames against bfloat16
    weights) meet in the wider one, where ``@`` would raise."""
    if x.dtype != w.dtype:
        t = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(t), w.to(t)
    return x @ w


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up
