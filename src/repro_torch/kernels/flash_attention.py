"""FlashAttention forward CUDA kernel (``csrc/flash_attention.cu``) on
Hopper's tensor cores; the operand type picks the route.

- bfloat16: ``wgmma``.  One CTA per (128-row q tile, head, batch): a
  producer warp keeps 128-key tiles of K and V in flight by TMA, two
  warpgroups of 64 rows take ``S = Q Kᵀ`` with both operands in shared
  memory, then ``P`` (rounded to bf16) from registers against V.  At
  head dim 80 the tiles are padded to 128 columns, which TMA fills with
  zeros past column 80.
- float32: ``mma.sync`` in 3xTF32 (each operand split into two halves
  rounded to TF32, about 22 bits of it).  One CTA per (64-row q tile, head, batch),
  four warps of 16 rows, 64-key tiles (32 at D = 128) staged by
  ``cp.async``.

Both walk double-buffered key tiles up to the causal edge, with the
running max, sum and output in registers, masked with the finite
``-1e30`` of the JAX package's ``flash_vjp`` (padded keys and, when
causal, keys past
``q_offset + row``).  GQA reads kv head ``h // (H/Hkv)``; q, k and v go
in through their batch and sequence strides, which with the base
pointers must be 16-byte aligned (:func:`_build.strided` copies
otherwise).  The kernel also writes the log-sum-exp ``lse`` (B, Sq, H)
for the recomputing backward.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention_chunked`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, work

launches = _build.LaunchCounter("flash_attention")

HEAD_DIMS = (16, 32, 64, 80, 128)   # the kernel's compiled head sizes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_build.declare("flash_attention", "flash_attention.cu", {
    "repro_flash_attention": [ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_longlong] * 6
    + [ctypes.c_void_p]})


def flash_attention_cuda(
    q: torch.Tensor,    # (B, Sq, H, D) float32 | bfloat16, on CUDA
    k: torch.Tensor,    # (B, Sk, Hkv, D), q's dtype
    v: torch.Tensor,    # (B, Sk, Hkv, D), q's dtype
    *,
    q_offset: int = 0,
    causal: bool = True,
    sm_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the flash-attention kernel on the current CUDA stream.
    Returns ``out`` (B, Sq, H, D) in q's dtype and ``lse`` (B, Sq, H) in
    float32.  Query row i sits at position ``q_offset + i``."""
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda takes CUDA tensors, got q on "
                         f"{q.device}")
    _build.refuse_grad("flash_attention (call it through "
                       "flash_vjp.flash_attention for a gradient)", q, k, v)
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k and v must have q's dtype {q.dtype}, got "
                        f"{k.dtype} and {v.dtype}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"expected q (B,Sq,H,D) and k (B,Sk,Hkv,D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    batch, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (batch, Sk, Hkv, D) or v.shape != k.shape:
        raise ValueError("flash_attention_cuda: inconsistent shapes")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"kv heads Hkv={Hkv} must divide heads H={H}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if batch > 65535 or H > 65535:
        raise ValueError(f"batch {batch} or heads {H} exceed the grid's 65535")
    scale = float(sm_scale if sm_scale is not None else D ** -0.5)
    out = torch.empty((batch, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((batch, Sq, H), dtype=torch.float32, device=q.device)
    if batch == 0 or Sq == 0:
        return out, lse
    if Sk == 0:
        raise ValueError("flash_attention_cuda needs at least one key")
    q, k, v = (_build.strided(t, D) for t in (q, k, v))
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), batch, Sq, Sk, H, Hkv, D,
            q_offset, int(bool(causal)), scale, *_build.outer(q),
            *_build.outer(k), *_build.outer(v), stream)
    _build.check(err, "flash_attention")
    launches.add()
    return out, lse


def flash_attention_meta(q, k, v, *, q_offset: int = 0, causal: bool = True,
                         sm_scale: float | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's route for ``meta`` tensors: ``out`` and ``lse`` of
    :func:`flash_attention_cuda`'s shapes and dtypes, no values, and one
    launch of the kernel's work (:func:`work.attn_work`) in the active
    cost counter, where the card would launch it.  An operand on
    another device raises, as the CUDA wrapper's does."""
    for name, t in (("k", k), ("v", v)):
        if not t.is_meta:
            raise ValueError(f"{name} is on {t.device}, q on meta")
    batch, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if batch and Sq:
        nbytes, products, _ = work.attn_work(batch, Sq, Sk, H, Hkv, D,
                                              int(q_offset), causal,
                                              q.element_size())
        work.record_kernel("flash_attention", nbytes, products)
    return (torch.empty((batch, Sq, H, D), dtype=q.dtype, device="meta"),
            torch.empty((batch, Sq, H), dtype=torch.float32, device="meta"))
