"""Rotary position embeddings (llama-style half-rotation)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)   # a Python scalar base: no host copy


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions.to(torch.float32)[..., None] * freqs   # (B,S,D/2) | (S,D/2)
    if ang.ndim == 2:  # (S, D/2) -> broadcast batch
        ang = ang[None]
    cos = torch.cos(ang)[..., None, :]  # (B,S,1,D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
