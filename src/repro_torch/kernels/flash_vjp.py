"""Flash attention with a flash *backward*: the JAX package's
``kernels/flash_vjp.py`` as a ``torch.autograd.Function``.

The attention route the model takes beyond 1024 positions.  The
forward is the flash-attention kernel (K3) for a CUDA tensor and the
plain online-softmax forward
:func:`repro_torch.kernels.ref.flash_attention_chunked` (a translation
of the reference's ``_fwd_impl``) for a CPU tensor; both return the
output and the log-sum-exp.  The forward saves only ``(q, k, v, out,
lse)`` and the ``q_offset``; the backward recomputes the probability
blocks pair by pair (FlashAttention-2's scheme, the reference's
``_bwd``), so neither pass holds more than one (q block, kv block) of
logits.  The backward is the backward kernel
(``csrc/flash_attention_bwd.cu``, through
:func:`repro_torch.kernels.flash_attention.flash_attention_backward_cuda`)
for a CUDA tensor, a record of its launch for a meta tensor, and
:func:`flash_backward` for a CPU tensor: the reference's ``_bwd``
blockwise in ``torch.einsum``, float32, which is the kernel's plain
version.  GQA is handled by grouping the q heads per kv head (no
materialised repeat).

Under remat (``torch.utils.checkpoint``) the forward runs twice per
layer: once in the forward pass and once when the backward recomputes
the layer.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    flash_attention_backward_cuda, flash_attention_backward_meta,
    flash_attention_cuda, flash_attention_meta)

NEG_INF = -1e30


def _wide(q, k, v):
    """The dtype the kernels run mixed operands in: the widest of the
    three, a float8 counting as bfloat16."""
    return functools.reduce(torch.promote_types, (
        torch.bfloat16 if t.is_floating_point and t.itemsize == 1 else t
        for t in (q.dtype, k.dtype, v.dtype)))


def _forward(q, k, v, q_offset, causal, sm_scale, q_block, kv_block):
    """(out in q's dtype, lse): the kernel on a CUDA tensor, the plain
    chunked forward on a CPU tensor (which tiles by ``q_block`` and
    ``kv_block``; the kernel tiles by its own), the kernel's shapes and
    a record of its launch on a meta tensor.  Operands of mixed
    dtypes (a bfloat16 decoder's queries against an encoder's float32
    keys) run the kernel in the wider dtype, as the plain forward
    computes in float32; a float8 operand (float8 parameters' queries
    against a bfloat16 cache), which the kernel does not take and torch
    does not promote, counts as bfloat16."""
    if q.device.type in ("cuda", "meta"):
        wide = _wide(q, k, v)
        kernel = flash_attention_cuda if q.is_cuda else flash_attention_meta
        out, lse = kernel(q.to(wide), k.to(wide), v.to(wide),
                          q_offset=q_offset, causal=causal, sm_scale=sm_scale)
        return out.to(q.dtype), lse
    if q.device.type != "cpu":
        raise ValueError(f"no kernel and no plain path for tensors on "
                         f"{q.device}")
    return ref.flash_attention_chunked(
        q, k, v, causal=causal, sm_scale=sm_scale, q_block=q_block,
        kv_block=kv_block, q_offset=q_offset)


def flash_backward(q, k, v, out, lse, do, *, q_offset=0, causal=True,
                   sm_scale=None, q_block=512, kv_block=1024):
    """(dq, dk, dv) in the inputs' dtypes: the reference's ``_bwd``.

    ``delta = rowsum(dO·O)`` in float32; then per (q block, kv block)
    pair ``p = exp(s − lse)`` under the same ``-1e30`` mask as the
    forward, ``dV += pᵀ dO``, ``dP = dO Vᵀ``, ``dS = p (dP − delta)
    scale``, ``dQ += dS K`` and ``dK += dSᵀ Q``.  A key block that lies
    wholly past the causal edge of a q block is skipped: its ``p`` is
    exactly zero."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    q_block = min(q_block, max(Sq, 1))
    kv_block = min(kv_block, max(Sk, 1))
    f32 = torch.float32
    pq, pk = (-Sq) % q_block, (-Sk) % kv_block
    qp = F.pad(q.to(f32), (0, 0, 0, 0, 0, pq))
    kp = F.pad(k.to(f32), (0, 0, 0, 0, 0, pk))
    vp = F.pad(v.to(f32), (0, 0, 0, 0, 0, pk))
    dop = F.pad(do.to(f32), (0, 0, 0, 0, 0, pq))
    lsep = F.pad(lse.to(f32), (0, 0, 0, pq))
    delta = (do.to(f32) * out.to(f32)).sum(-1)
    deltap = F.pad(delta, (0, 0, 0, pq))
    nq, nk = qp.shape[1] // q_block, kp.shape[1] // kv_block
    dev = q.device
    dq = torch.empty((B, nq * q_block, H, D), dtype=f32, device=dev)
    dk = torch.zeros_like(kp)
    dv = torch.zeros_like(vp)
    for qi in range(nq):
        rows = slice(qi * q_block, (qi + 1) * q_block)
        qb = qp[:, rows].reshape(B, q_block, Hkv, G, D)
        dob = dop[:, rows].reshape(B, q_block, Hkv, G, D)
        lseb = lsep[:, rows].reshape(B, q_block, Hkv, G).permute(0, 2, 3, 1)
        delb = deltap[:, rows].reshape(B, q_block, Hkv, G).permute(0, 2, 3, 1)
        qpos = qi * q_block + torch.arange(q_block, device=dev) + q_offset
        last = qi * q_block + q_block - 1 + q_offset
        dq_b = torch.zeros((B, q_block, Hkv, G, D), dtype=f32, device=dev)
        for ki in range(nk):
            if causal and ki * kv_block > last:
                break
            cols = slice(ki * kv_block, (ki + 1) * kv_block)
            kb, vb = kp[:, cols], vp[:, cols]
            kpos = ki * kv_block + torch.arange(kv_block, device=dev)
            valid = (kpos[None, :] < Sk) & (qpos[:, None] < Sq + q_offset)
            if causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            s = s + torch.where(valid, 0.0, NEG_INF).to(f32)
            p = torch.exp(s - lseb[..., None])              # (B,Hkv,G,qb,kb)
            dv[:, cols] += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vb)
            ds = p * (dp - delb[..., None]) * scale
            dq_b += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
            dk[:, cols] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb)
        dq[:, rows] = dq_b.reshape(B, q_block, H, D)
    return (dq[:, :Sq].to(q.dtype), dk[:, :Sk].to(k.dtype),
            dv[:, :Sk].to(v.dtype))


def _backward(q, k, v, out, lse, do, q_offset, causal, sm_scale):
    """(dq, dk, dv) in q's, k's and v's dtypes from the backward kernel
    on a CUDA tensor, or its shapes and a record of its launch on a meta
    tensor, run in the dtype the forward ran (mixed operands in the
    wider, as :func:`_forward`)."""
    wide = _wide(q, k, v)
    kernel = (flash_attention_backward_cuda if q.is_cuda
              else flash_attention_backward_meta)
    dq, dk, dv = kernel(q.to(wide), k.to(wide), v.to(wide), out.to(wide),
                        lse, do.to(wide), q_offset=q_offset, causal=causal,
                        sm_scale=sm_scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Autograd's view of the flash route: the kernel (or the plain
    chunked forward) forward; the backward kernel (or, for a CPU tensor,
    :func:`flash_backward`) backward; no cotangent for ``q_offset`` or
    the static arguments."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, sm_scale, q_block, kv_block):
        q_offset = int(q_offset)
        out, lse = _forward(q, k, v, q_offset, causal, sm_scale, q_block,
                            kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(q_offset=q_offset, causal=causal, sm_scale=sm_scale,
                        q_block=q_block, kv_block=kv_block)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        a = ctx.args
        if q.device.type in ("cuda", "meta"):
            dq, dk, dv = _backward(q, k, v, out, lse, do, a["q_offset"],
                                   a["causal"], a["sm_scale"])
        else:
            dq, dk, dv = flash_backward(q, k, v, out, lse, do, **a)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, q_offset=0, causal=True, sm_scale=None,
                    q_block=512, kv_block=1024) -> torch.Tensor:
    """(B,Sq,H,D), (B,Sk,Hkv,D) -> (B,Sq,H,D): the JAX package's
    ``flash_vjp.flash_attention``, in its argument order, differentiable
    in q, k and v.  Query row i sits at position ``q_offset + i``."""
    return FlashAttention.apply(q, k, v, q_offset, causal, sm_scale,
                                q_block, kv_block)
