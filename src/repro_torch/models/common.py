"""Shared building blocks: initializers, norms, positions, the loss, and
the tensor-parallel products (a local product, then the sum over the
model axis where the contracted dim is split)."""
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
    generator's device (a :class:`registry.HostGenerator`'s card), in
    float32, then cast and put on ``gen.device``."""
    if std is None:
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
        std = fan_in ** -0.5
    lo, hi = _phi(-3.0), _phi(3.0)
    t = torch.empty(shape, dtype=torch.float32,
                    device=getattr(gen, "draws_on", gen.device))
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0).mul_(std)
    return t.to(gen.device, dtype)


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
                       vocab_size: int, mask: torch.Tensor | None = None,
                       sh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked token-mean cross entropy in float32 over (..., V_padded)
    logits -> (loss, token count, at least 1).  Padded vocabulary slots
    get ``-1e30`` before the log-sum-exp, so they stay out of the
    normaliser.  ``sh``, when given, is the context whose model axis
    splits the vocabulary: the logits hold this rank's block, and the
    loss takes the vocab-parallel form (the per-rank log-sum-exps
    gathered and combined, the target's logit summed from its owner)."""
    logits = logits.to(torch.float32)
    v_loc = logits.shape[-1]
    v0 = 0
    parallel = sh is not None and sh.tp > 1
    if parallel:
        v0 = sh.model_index * v_loc
    if v0 + v_loc > vocab_size:
        ids = torch.arange(v0, v0 + v_loc, device=logits.device)
        logits = logits + torch.where(ids < vocab_size, 0.0, -1e30)
    labels = labels[..., None].to(device=logits.device, dtype=torch.int64)
    if parallel:
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        logz = torch.logsumexp(sh.gather(lse, -1), dim=-1)
        local = labels - v0
        mine = (local >= 0) & (local < v_loc)
        picked = torch.gather(logits, -1, local.clamp(0, v_loc - 1))
        picked = sh.reduce(torch.where(mine, picked, 0.0))[..., 0]
    else:
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels)[..., 0]
    nll = logz - picked
    if mask is None:
        mask = torch.ones(labels.shape[:-1], dtype=torch.float32,
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


# ------------------------------------------------------- tensor parallel
def col_parallel(x: torch.Tensor, w: torch.Tensor, sh, split: bool
                 ) -> torch.Tensor:
    """``x @ w`` where ``w`` holds this rank's block of output columns
    (``split``): the replicated ``x`` enters through ``sh.copy``, so its
    gradient sums every rank's share."""
    return dot(sh.copy(x) if split else x, w)


def row_parallel(x: torch.Tensor, w: torch.Tensor, sh, split: bool
                 ) -> torch.Tensor:
    """``x @ w`` where ``x`` and ``w`` hold this rank's block of the
    contracted dim (``split``): the local product, then its sum over the
    model axis."""
    y = dot(x, w)
    return sh.reduce(y) if split else y


def gather_whole(p: dict, full_shapes: dict, axes: dict, sh) -> dict:
    """``p`` with each leaf named in ``full_shapes`` gathered whole over
    the model axis along every dim that its logical ``axes`` split there
    (the reference's rules at the leaf's full shape).  For a layer whose
    heads do not split over the ranks: every rank computes every head
    alike, so each keeps its block of a gathered leaf's gradient."""
    out = dict(p)
    for name, full in full_shapes.items():
        for dim, (logical, size) in enumerate(zip(axes[name], full)):
            if logical is not None and sh.split(logical, size):
                out[name] = sh.gather(out[name], dim)
    return out
