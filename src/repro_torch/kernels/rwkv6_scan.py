"""RWKV6 WKV scan CUDA kernel (``csrc/rwkv6_scan.cu``), the counterpart
of the Pallas kernel ``rwkv6_scan_pallas`` (``_wkv_kernel``) in
``src/repro/kernels/rwkv6_scan.py``.

The chunked form is exact at any chunk length, so the kernel tiles by
its own 16-step sub-chunks, as the flash kernel tiles by its own
blocks: ``chunk`` is checked and shapes only the plain version.  One
CTA of four warps per (batch, head) walks the sub-chunks with the
transposed K x V state in tensor-core accumulator fragments.  Per
sub-chunk the readout ``(r o exp(lwp)) · S``, the causal 16 x 16 block
``att · v`` and the state update ``(k o exp(lw_b - lw))ᵀ v`` run on
3xTF32 ``mma.sync`` (``csrc/tc.cuh``); only the diagonal block
exponentiates the decay cube, as ``exp(lwp_t - lw_s)``.  Every exponent
is a sum of log-decays over a span of steps, so it is <= 0: no factor
can overflow, and where one underflows the true product is smaller
still.  The cumulative log-decays are a warp scan, the next sub-chunk
is staged by ``cp.async`` while this one computes, and the tail stops
at T (a 3-token call does one sub-chunk).  What bounds it on an H100 is
its bytes.  The plain version is :func:`repro_torch.kernels.ref.rwkv6_chunked`.

:func:`rwkv6_scan` is the differentiable route (``kernels/ops.py``
takes it on both devices): a ``torch.autograd.Function`` whose forward
is the kernel on a CUDA tensor and the plain chunked form on a CPU
tensor, and whose backward recomputes the plain chunked form under
autograd and differentiates it (:func:`ref.recomputed_vjp`), the
gradient the JAX package takes of ``rwkv6_chunked_jnp`` off the TPU.
The recompute takes the forward's mix of dtypes (a bfloat16 model's r,
k, v and u beside float32 w), and each gradient comes back in its
input's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref, work

launches = _build.LaunchCounter("rwkv6_scan")

MAX_CHUNK = 64      # the chunk lengths accepted (the kernel tiles by 16)
MAX_K = 64          # key dim the register tiles hold
MAX_V = 64          # value dim the register tiles hold
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_build.declare("rwkv6_scan", "rwkv6_scan.cu", {
    "repro_rwkv6_scan": [ctypes.c_int] + [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8 + [ctypes.c_void_p]})


def rwkv6_scan_cuda(
    r: torch.Tensor,    # (B, T, H, K) float32 | bfloat16, on CUDA
    k: torch.Tensor,    # (B, T, H, K), r's dtype
    v: torch.Tensor,    # (B, T, H, V), r's dtype
    w: torch.Tensor,    # (B, T, H, K) decays in (0, 1), float32
    u: torch.Tensor,    # (H, K)
    state: torch.Tensor | None = None,   # (B, H, K, V)
    *,
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the WKV6 kernel on the current CUDA stream.  Returns ``y``
    (B, T, H, V) in r's dtype and the final state (B, H, K, V) in
    float32.  ``w`` and ``u`` are taken in float32 (the model computes
    the decay in float32 whatever its dtype)."""
    if not r.is_cuda:
        raise ValueError("rwkv6_scan_cuda takes CUDA tensors, got r on "
                         f"{r.device}")
    _build.refuse_grad("rwkv6_scan", r, k, v, w, u, state)
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if t is not None and t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    if r.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 r, got {r.dtype}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"k and v must have r's dtype {r.dtype}, got "
                        f"{k.dtype} and {v.dtype}")
    if r.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected r (B,T,H,K) and v (B,T,H,V), got "
                         f"{tuple(r.shape)} and {tuple(v.shape)}")
    batch, T, H, K = r.shape
    V = v.shape[3]
    if (tuple(k.shape) != (batch, T, H, K)
            or tuple(w.shape) != (batch, T, H, K)
            or tuple(v.shape[:3]) != (batch, T, H)
            or tuple(u.shape) != (H, K)
            or (state is not None
                and tuple(state.shape) != (batch, H, K, V))):
        raise ValueError("rwkv6_scan_cuda: inconsistent shapes")
    if K > MAX_K or V > MAX_V:
        raise ValueError(f"the kernel takes K <= {MAX_K} and V <= {MAX_V}, "
                         f"got K={K}, V={V}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {chunk}")
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's 65535")
    f32 = torch.float32
    if state is not None:
        state = state.to(f32).contiguous()
    if T == 0 or batch == 0:
        empty = torch.empty((batch, T, H, V), dtype=r.dtype, device=r.device)
        return empty, (torch.zeros((batch, H, K, V), dtype=f32,
                                   device=r.device)
                       if state is None else state.clone())
    r, k = _build.strided(r, K), _build.strided(k, K)
    v = _build.strided(v, V)
    w = _build.strided(w.to(f32), K)
    u = u.to(f32).contiguous()
    y = torch.empty((batch, T, H, V), dtype=r.dtype, device=r.device)
    s_out = torch.empty((batch, H, K, V), dtype=f32, device=r.device)
    lib = _build.load("rwkv6_scan")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_rwkv6_scan(
            _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), u.data_ptr(),
            None if state is None else state.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), batch, T, H, K, V, chunk,
            r.stride(0), r.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), w.stride(0), w.stride(1), stream)
    _build.check(err, "rwkv6_scan")
    launches.add()
    return y, s_out


def rwkv6_scan_meta(r, k, v, w, u, state=None, *, chunk: int = 64
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's route for ``meta`` tensors: ``y`` and the final
    state of :func:`rwkv6_scan_cuda`'s shapes and dtypes, no values, and
    one launch of the kernel's work (:func:`work.wkv_work`) in the
    active cost counter, where the card would launch it.  An operand on
    another device raises, as the CUDA wrapper's does."""
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if t is not None and not t.is_meta:
            raise ValueError(f"{name} is on {t.device}, r on meta")
    batch, T, H, K = r.shape
    V = v.shape[3]
    if T and batch:
        nbytes, products, _ = work.wkv_work(batch, T, H, K, V,
                                             r.element_size())
        work.record_kernel("rwkv6_scan", nbytes, products)
    return (torch.empty((batch, T, H, V), dtype=r.dtype, device="meta"),
            torch.empty((batch, H, K, V), dtype=torch.float32,
                        device="meta"))


class RwkvWKV(torch.autograd.Function):
    """Autograd's view of the WKV6 scan: the kernel (the plain chunked
    form on the CPU, the kernel's meta route on ``meta``) forward, the
    recomputed plain chunked form's gradient backward.  Saves only the inputs; either output's cotangent may be
    absent (a training step never reads the final state)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk):
        if r.is_cuda:
            y, s = rwkv6_scan_cuda(r, k, v, w, u, state, chunk=chunk)
        elif r.is_meta:
            y, s = rwkv6_scan_meta(r, k, v, w, u, state, chunk=chunk)
        else:
            y, s = ref.rwkv6_chunked(r, k, v, w, u, state, chunk=chunk)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        grads = ref.recomputed_vjp(
            ref.rwkv6_chunked, ctx.saved_tensors, ctx.needs_input_grad[:6],
            (dy, ds), chunk=ctx.chunk)
        return (*grads, None)


def rwkv6_scan(r, k, v, w, u, state=None, *, chunk: int = 64):
    """Differentiable chunked WKV6: ``(y in r's dtype, final state
    (B,H,K,V) float32)``."""
    if r.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel and no plain path for tensors on "
                         f"{r.device}")
    return RwkvWKV.apply(r, k, v, w, u, state, chunk)
