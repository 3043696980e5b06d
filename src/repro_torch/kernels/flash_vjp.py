"""Flash attention forward on the route the model takes beyond 1024
positions: the JAX package's ``kernels/flash_vjp.py``.

:func:`flash_attention` takes that module's arguments, including a
``q_offset`` (prefill into a cache: query row i sits at position
``q_offset + i``).  A CPU tensor takes the plain online-softmax forward
:func:`repro_torch.kernels.ref.flash_attention_chunked`, a translation
of the reference's ``_fwd_impl``; a CUDA tensor launches the
flash-attention kernel (K3).  Both also give the log-sum-exp that the
recomputing backward reads.  That backward (a
``torch.autograd.Function``) comes with the training slice: until then
a CUDA call with an input that requires a gradient raises, rather than
return an output with no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda


def flash_attention(q, k, v, q_offset=0, causal=True, sm_scale=None,
                    q_block=512, kv_block=1024) -> torch.Tensor:
    """(B,Sq,H,D), (B,Sk,Hkv,D) -> (B,Sq,H,D): the JAX package's
    ``flash_vjp.flash_attention`` forward, in its argument order.  A CPU
    tensor takes the plain forward, a CUDA tensor the kernel (which
    tiles by its own blocks; ``q_block`` and ``kv_block`` shape only the
    plain route).  Both compute the log-sum-exp the backward will read;
    this forward returns the output alone."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"no kernel and no plain path for tensors on "
                             f"{q.device}")
        return ref.flash_attention_chunked(
            q, k, v, causal=causal, sm_scale=sm_scale, q_block=q_block,
            kv_block=kv_block, q_offset=int(q_offset))[0]
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention's recomputing backward comes with the training "
            "slice (a torch.autograd.Function over the kernel); call the "
            "forward under torch.no_grad() or on tensors that need no "
            "gradient")
    return flash_attention_cuda(q, k, v, q_offset=int(q_offset),
                                causal=causal, sm_scale=sm_scale)[0]
