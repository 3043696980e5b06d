"""Mamba2 SSD chunked-scan CUDA kernel (``csrc/mamba2_ssd.cu``) on
Hopper's tensor cores.

One CTA of four warps per (batch, head) walks the sequence in tiles of
up to 32 steps with the P x N fp32 state in accumulator fragments; per
tile it stages x, B and C by ``cp.async`` (the next tile in flight),
and runs the four products ``C Bᵀ`` (causal blocks), ``(C Bᵀ ∘ L ∘
dt) x``, ``exp(la) C hᵀ`` and the state update ``xᵀ diag(w) B`` as
``mma.sync`` in 3xTF32 (each float32 operand as two halves rounded to
TF32, about 22 bits; a bf16 operand is exact in TF32 and skips its
cross term), then writes ``y = ... + D x``.  B and C
are read by group — never repeated to heads — and x, B and C through
their batch and time strides, so the model's slices of the
in-projection go in without a copy.  The plain version is
:func:`repro_torch.kernels.ref.mamba2_ssd_chunked`.

:func:`mamba2_ssd` is the differentiable route (``kernels/ops.py``
takes it on both devices): a ``torch.autograd.Function`` whose forward
is the kernel on a CUDA tensor and the plain chunked form on a CPU
tensor, and whose backward recomputes the plain chunked form under
autograd and differentiates it (:func:`ref.recomputed_vjp`), the
gradient the JAX package takes of ``mamba2_ssd_chunked_jnp`` off the
TPU.  The backward is the same PyTorch code on every device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref, work

launches = _build.LaunchCounter("mamba2_ssd")

MAX_CHUNK = 128     # chunk rows staged per CTA
MAX_P = 64          # head dim the register tiles hold
MAX_N = 64          # state size the register tiles hold
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_build.declare("mamba2_ssd", "mamba2_ssd.cu", {
    "repro_mamba2_ssd": [ctypes.c_int] + [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]})


def mamba2_ssd_cuda(
    x: torch.Tensor,    # (B, T, H, P) float32 | bfloat16, on CUDA
    dt: torch.Tensor,   # (B, T, H)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, T, G, N), x's dtype
    Cm: torch.Tensor,   # (B, T, G, N), x's dtype
    D: torch.Tensor | None = None,       # (H,)
    state: torch.Tensor | None = None,   # (B, H, P, N)
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the SSD kernel on the current CUDA stream.  Returns ``y``
    (B, T, H, P) in x's dtype and the final state (B, H, P, N) in
    float32.  ``chunk`` follows the TPU wrapper's rule,
    ``min(chunk, max(T, 8))``."""
    if not x.is_cuda:
        raise ValueError("mamba2_ssd_cuda takes CUDA tensors, got x on "
                         f"{x.device}")
    _build.refuse_grad("mamba2_ssd", x, dt, A, Bm, Cm, D, state)
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("D", D), ("state", state)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 x, got {x.dtype}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"B and C must have x's dtype {x.dtype}, got "
                        f"{Bm.dtype} and {Cm.dtype}")
    if x.ndim != 4 or Bm.ndim != 4:
        raise ValueError(f"expected x (B,T,H,P) and B (B,T,G,N), got "
                         f"{tuple(x.shape)} and {tuple(Bm.shape)}")
    batch, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (batch, T, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (batch, T, G, N)
            or tuple(Cm.shape) != (batch, T, G, N)
            or (D is not None and tuple(D.shape) != (H,))
            or (state is not None
                and tuple(state.shape) != (batch, H, P, N))):
        raise ValueError("mamba2_ssd_cuda: inconsistent shapes")
    if H % G:
        raise ValueError(f"groups G={G} must divide heads H={H}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"the kernel takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"got P={P}, N={N}")
    chunk = min(chunk, max(T, 8))
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {chunk}")
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's 65535")
    f32 = torch.float32
    state = (torch.zeros((batch, H, P, N), dtype=f32, device=x.device)
             if state is None else state.to(f32).contiguous())
    if T == 0 or batch == 0:
        return torch.empty_like(x), state.clone()
    x = _build.strided(x, P)
    Bm, Cm = _build.strided(Bm, N), _build.strided(Cm, N)
    dt = dt.to(f32).contiguous()
    A = A.to(f32).contiguous()
    D = None if D is None else D.to(f32).contiguous()
    y = torch.empty((batch, T, H, P), dtype=x.dtype, device=x.device)
    h_out = torch.empty((batch, H, P, N), dtype=f32, device=x.device)
    lib = _build.load("mamba2_ssd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_mamba2_ssd(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(),
            None if D is None else D.data_ptr(), state.data_ptr(),
            y.data_ptr(), h_out.data_ptr(), batch, T, H, P, G, N, chunk,
            *_build.outer(x), *_build.outer(Bm), *_build.outer(Cm), stream)
    _build.check(err, "mamba2_ssd")
    launches.add()
    return y, h_out


def mamba2_ssd_meta(x, dt, A, Bm, Cm, D=None, state=None, *,
                    chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's route for ``meta`` tensors: ``y`` and the final
    state of :func:`mamba2_ssd_cuda`'s shapes and dtypes, no values, and
    one launch of the kernel's work (:func:`work.ssd_work`) in the
    active cost counter, where the card would launch it.  An operand on
    another device raises, as the CUDA wrapper's does."""
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("D", D), ("state", state)):
        if t is not None and not t.is_meta:
            raise ValueError(f"{name} is on {t.device}, x on meta")
    batch, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if T and batch:
        nbytes, products, _ = work.ssd_work(batch, T, H, P, G, N,
                                             x.element_size())
        work.record_kernel("mamba2_ssd", nbytes, products)
    return (torch.empty((batch, T, H, P), dtype=x.dtype, device="meta"),
            torch.empty((batch, H, P, N), dtype=torch.float32,
                        device="meta"))


class MambaSSD(torch.autograd.Function):
    """Autograd's view of the SSD scan: the kernel (the plain chunked
    form on the CPU, the kernel's meta route on ``meta``) forward, the
    recomputed plain chunked form's gradient backward.  Saves only the inputs; either output's cotangent may be
    absent (a training step never reads the final state)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, state, chunk):
        if x.is_cuda:
            y, h = mamba2_ssd_cuda(x, dt, A, Bm, Cm, D, state, chunk=chunk)
        elif x.is_meta:
            y, h = mamba2_ssd_meta(x, dt, A, Bm, Cm, D, state, chunk=chunk)
        else:
            y, h = ref.mamba2_ssd_chunked(x, dt, A, Bm, Cm, D, state,
                                          chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        grads = ref.recomputed_vjp(
            ref.mamba2_ssd_chunked, ctx.saved_tensors,
            ctx.needs_input_grad[:7], (dy, dh), chunk=ctx.chunk)
        return (*grads, None)


def mamba2_ssd(x, dt, A, Bm, Cm, D=None, state=None, *, chunk: int = 128):
    """Differentiable chunked SSD: ``(y in x's dtype, final state
    (B,H,P,N) float32)``, the chunk ``min(chunk, max(T, 8))`` (the TPU
    wrapper's rule) on both passes."""
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel and no plain path for tensors on "
                         f"{x.device}")
    return MambaSSD.apply(x, dt, A, Bm, Cm, D, state,
                          min(chunk, max(x.shape[1], 8)))
