"""Gradient compression for the data-parallel reduction.

Two mechanisms, as in the JAX package:

1. Gradient rounding (``TrainConfig.grad_reduce_dtype``, bfloat16 by
   default): the train step rounds the reduced gradients to that dtype.

2. int8 + error feedback (this module): for pure data-parallel meshes,
   :func:`compressed_psum_int8` is a two-phase quantized mean over a
   process group — per-member int8 quantization of the chunks, an
   all-to-all (the reduce-scatter phase, int8 on the wire), a float32
   accumulate, re-quantization, and an all-gather (int8 on the wire).
   Only int8 values and one float32 scale per member cross the wire.
   :class:`ErrorFeedback` keeps the quantization residual and folds it
   into the next step (Karimireddy et al.).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.lm import tree_map


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale): amax
    floored at 1e-12, scale amax / 127, round half to even, clip ±127."""
    amax = torch.clamp(x.abs().max(), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def compressed_psum_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the ranks of ``group`` (the default group when ``None``)
    with int8 wire traffic.  x: (1, size) this rank's gradient vector,
    size divisible by the group's size.  Returns (1, size): every rank
    holds the mean."""
    n = dist.get_world_size(group)
    v = x[0].to(torch.float32)
    cs = v.shape[0] // n
    q, scale = _quantize_int8(v.reshape(n, cs))       # one scale per member
    # phase 1 (reduce-scatter shape): rank j receives every member's chunk j
    q_t = torch.empty_like(q)
    dist.all_to_all_single(q_t, q, group=group)       # row i: rank i's chunk
    scales = _gather(scale, n, group)                 # (n,)
    mean_chunk = (q_t.to(torch.float32) * scales[:, None]).sum(0) / n
    # phase 2: publish the owned mean chunk
    q2, s2 = _quantize_int8(mean_chunk)
    gathered = _gather(q2, n, group)                  # (n, cs) int8
    s_all = _gather(s2, n, group)                     # (n,)
    out = gathered.to(torch.float32) * s_all[:, None]
    return out.reshape(1, n * cs)


def make_compressed_grad_reducer(mesh, axis: str = "data"):
    """Returns ``reduce(grads_tree)``: each leaf is this rank's row (1,
    ...) of an (n, ...) gradient sharded over ``axis`` (row i on the
    axis's rank i); the result is the same shape, holding the int8-wire
    mean of the n rows on every rank.  Each row is flattened and padded
    to a multiple of n.  ``mesh`` must carry its ``DeviceMesh``."""
    n = mesh.sizes[axis]
    group = mesh.device_mesh.get_group(axis)

    def one(g):
        if g.shape[0] != 1:
            raise ValueError(f"a leaf holds this rank's row (1, ...), got "
                             f"{tuple(g.shape)}")
        size = g[0].numel()
        flat = g.reshape(1, size).to(torch.float32)
        pad = (-size) % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros((1, pad))], dim=1)
        return compressed_psum_int8(flat, group)[:, :size].reshape(g.shape)

    def reduce_tree(grads):
        return tree_map(one, grads)

    return reduce_tree


class ErrorFeedback:
    """e_t = g_t + e_{t-1} - Q(g_t + e_{t-1}); carried in the train state."""

    @staticmethod
    def init(params) -> Any:
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    @staticmethod
    def apply(grads, ef_state, quantize=_quantize_int8):
        """(what is sent: Q(g + e) dequantized, the new residual)."""
        def one(g, e):
            c = g.to(torch.float32) + e
            sent = _dequantize(*quantize(c))
            return sent, c - sent

        out = _zip_map(one, grads, ef_state)
        return tree_map(lambda p: p[0], out), tree_map(lambda p: p[1], out)


def _zip_map(fn, a, b):
    """``fn(a_leaf, b_leaf)`` over two trees of one dict structure."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)
