"""Numerics the plain references share: matrix products in a stated
precision, norms and rotary positions, all in float32.

``precision`` is ``"fp32"`` (float32 products, TF32 off: what the
configurations state) or ``"tf32"`` (each operand rounded to TF32, ten
bits of mantissa, before a float32 product: the control, the nearest
precision below).  The rounding is done by hand, so the control reads
the same on the CPU as on the card."""
from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even:
    the low 13 of the 23 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32, operands first rounded to TF32 when
    ``precision`` is ``"tf32"``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    a, b = a.to(torch.float32), b.to(torch.float32)
    if precision == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    return xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps) * w + b


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0.. on (B, S, H, D): the first and second halves
    of each head rotated as pairs, frequency ``theta ** (-2i / D)``."""
    S, D = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                  device=x.device) / D)
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None]
           * inv).to(torch.float32)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, precision):
    """Softmax attention of (B, S, H, D) queries over (B, S, Hkv, D) keys
    and values, each position seeing itself and those before it; both
    products' operands rounded as :func:`matmul` rounds them."""
    B, S, H, D = q.shape
    if precision == "tf32":
        q, k, v = tf32_round(q), tf32_round(k), tf32_round(v)
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    if precision == "tf32":
        p = tf32_round(p)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
