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
tensor, and whose backward is the backward kernel
(``csrc/rwkv6_scan_bwd.cu``, :func:`rwkv6_scan_backward_cuda`) on a
CUDA tensor, a record of its launch on a meta tensor, and its plain
version :func:`ref.rwkv6_chunked_backward` (the closed-form gradient
chunk by chunk in float32) on a CPU tensor: the gradient the JAX
package takes of ``rwkv6_chunked_jnp`` by autodiff off the TPU.  The
backward takes the forward's mix of dtypes (a bfloat16 model's r, k, v
and u beside float32 w), and each gradient comes back in its input's
dtype.

The backward kernel (:func:`rwkv6_scan_backward_cuda`) is chunk-parallel
over blocks of ``BWD_BLOCK`` = 64 steps, each walked as four sub-blocks
of ``BWD_SUB`` = 16, in four launches: each (block, head, batch) CTA
writes its block's own shares of the state and of the adjoint (chained
from its sub-blocks' shares by their decays) in place into the boundary
buffers; a walk over the block boundaries, a thread per state entry and
direction (:func:`backward_walks`), gives the state at every boundary
from the initial state and the adjoint at every boundary from the final
state's cotangent; each (block, head, batch) CTA then walks its four
sub-blocks with those (:func:`backward_blocks`), carrying the adjoint
backward and the state forward, and writes the block's gradients; and
``du``'s block shares are summed in a fixed order: no atomics, so two
runs give equal bits.  Every product runs on the tensor cores in 3xTF32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref, work

launches = _build.LaunchCounter("rwkv6_scan")
backward_launches = _build.LaunchCounter("rwkv6_scan_backward")

MAX_CHUNK = 64      # the chunk lengths accepted (the kernel tiles by 16)
MAX_K = 64          # key dim the register tiles hold
MAX_V = 64          # value dim the register tiles hold
# the backward kernel's BL, SUB and WALK_THREADS, which
# repro_rwkv6_scan_backward_geometry reports
BWD_BLOCK = 64      # steps a block of the backward kernel covers
BWD_SUB = 16        # steps a sub-block of a block covers
BWD_WALK_THREADS = 256  # state entries a CTA of the backward's walk holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_build.declare("rwkv6_scan", "rwkv6_scan.cu", {
    "repro_rwkv6_scan": [ctypes.c_int] + [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8 + [ctypes.c_void_p]})
_build.declare("rwkv6_scan_backward", "rwkv6_scan_bwd.cu", {
    "repro_rwkv6_scan_backward": [ctypes.c_int] + [ctypes.c_void_p] * 17
    + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 10 + [ctypes.c_void_p],
    "repro_rwkv6_scan_backward_geometry": [ctypes.POINTER(ctypes.c_int)]})


def _check_operands(what, r, k, v, w, u, state, **more):
    """The shape, dtype and device checks both kernels' wrappers run:
    ``(batch, T, H, K, V)``.  ``more`` names further operands (None
    where absent) that must lie on r's device."""
    for name, t in dict(k=k, v=v, w=w, u=u, state=state, **more).items():
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
        raise ValueError(f"{what}: inconsistent shapes")
    if K > MAX_K or V > MAX_V:
        raise ValueError(f"the kernel takes K <= {MAX_K} and V <= {MAX_V}, "
                         f"got K={K}, V={V}")
    if batch > 65535 or H > 65535:
        raise ValueError(f"batch {batch} or heads {H} exceed the grid's "
                         "65535")
    return batch, T, H, K, V


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
    batch, T, H, K, V = _check_operands("rwkv6_scan_cuda", r, k, v, w, u,
                                        state)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {chunk}")
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


def backward_blocks(T):
    """The backward kernel's block CTAs for one (batch, head), as
    ``csrc/rwkv6_scan_bwd.cu`` runs them: for each block of
    ``BWD_BLOCK`` steps, the steps it writes gradients for (the tail
    stopping at T); its sub-blocks of ``BWD_SUB`` steps in order (none
    wholly past T), which the gradient pass walks backward carrying the
    adjoint, then forward carrying the state; the boundary whose state
    it reads (its start) and the boundary whose adjoint it reads (its
    end).  The local pass runs the same CTAs and writes the block's share
    of the state at its end boundary and of the adjoint at its start
    ("shares")."""
    nb = -(-T // BWD_BLOCK)
    blocks = []
    for j in range(nb):
        steps = range(j * BWD_BLOCK, min((j + 1) * BWD_BLOCK, T))
        subs = [range(t, min(t + BWD_SUB, steps.stop))
                for t in range(steps.start, steps.stop, BWD_SUB)]
        blocks.append({"block": j, "steps": steps, "subs": subs,
                       "state": j, "adjoint": j + 1,
                       "shares": {"state": j + 1, "adjoint": j}})
    return blocks


def backward_walks(B, H, K, V, T):
    """The backward kernel's walk over the block boundaries: for each CTA
    of ``BWD_WALK_THREADS`` threads and each direction, the (batch, head,
    k, v) state entries its threads hold (a thread past the last entry
    holds none), and the boundaries every thread steps through in order:
    the states forward from boundary 0 (the initial state) to ``nb``, the
    adjoints backward from ``nb`` (the final state's cotangent) to 0 (the
    initial state's gradient)."""
    nb = -(-T // BWD_BLOCK)
    total = B * H * K * V
    walks = []
    for direction, order in (("states", list(range(nb + 1))),
                             ("adjoints", list(range(nb, -1, -1)))):
        for cta in range(-(-total // BWD_WALK_THREADS)):
            entries = []
            for e in range(cta * BWD_WALK_THREADS,
                           min((cta + 1) * BWD_WALK_THREADS, total)):
                bh, kv = divmod(e, K * V)
                entries.append((*divmod(bh, H), *divmod(kv, V)))
            walks.append({"direction": direction, "entries": entries,
                          "boundaries": order})
    return nb, walks


def kernel_geometry(lib) -> tuple[int, int, int]:
    """The backward library's own block length, sub-block length and
    walk width, which the mirrors and the scratch sizes must equal."""
    out = (ctypes.c_int * 3)()
    _build.check(lib.repro_rwkv6_scan_backward_geometry(out),
                 "rwkv6_scan_backward geometry")
    return tuple(out)


def rwkv6_scan_backward_cuda(
    r: torch.Tensor,    # (B, T, H, K) float32 | bfloat16, on CUDA
    k: torch.Tensor,    # (B, T, H, K), r's dtype
    v: torch.Tensor,    # (B, T, H, V), r's dtype
    w: torch.Tensor,    # (B, T, H, K) decays, float32
    u: torch.Tensor,    # (H, K)
    state: torch.Tensor | None,   # (B, H, K, V) the initial state
    dy: torch.Tensor | None,      # (B, T, H, V) y's cotangent
    ds: torch.Tensor | None,      # (B, H, K, V) the final state's
    *,
    chunk: int = 64,
) -> tuple:
    """Launch the WKV6 backward on the current CUDA stream (the blocks'
    shares, the walk over their boundaries, the gradients, the du sum).  Returns ``(dr, dk, dv, dw, du, ds0)``, each
    in its input's dtype (``ds0`` None without an initial state); a
    missing cotangent counts as zeros.  ``w``, ``u``, the states and the
    cotangent ``ds`` are taken in float32, ``dy`` in r's dtype.  ``chunk``
    is checked and not otherwise used: the kernel tiles by its own
    64-step blocks of 16-step sub-blocks."""
    if not r.is_cuda:
        raise ValueError("rwkv6_scan_backward_cuda takes CUDA tensors, got "
                         f"r on {r.device}")
    _build.refuse_grad("rwkv6_scan_backward (no double backward)",
                       r, k, v, w, u, state, dy, ds)
    batch, T, H, K, V = _check_operands("rwkv6_scan_backward_cuda", r, k, v,
                                        w, u, state, dy=dy, ds=ds)
    if ((dy is not None and tuple(dy.shape) != (batch, T, H, V))
            or (ds is not None and tuple(ds.shape) != (batch, H, K, V))):
        raise ValueError("rwkv6_scan_backward_cuda: inconsistent shapes")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {chunk}")
    f32, dev = torch.float32, r.device
    like = (k, v, w, u, state)      # the gradients' dtypes
    dr = torch.empty((batch, T, H, K), dtype=r.dtype, device=dev)
    dk = torch.empty((batch, T, H, K), dtype=r.dtype, device=dev)
    dv = torch.empty((batch, T, H, V), dtype=r.dtype, device=dev)
    dw = torch.empty((batch, T, H, K), dtype=f32, device=dev)
    du = torch.empty((H, K), dtype=f32, device=dev)
    ds0 = (None if state is None else
           torch.empty((batch, H, K, V), dtype=f32, device=dev))
    if T == 0 or batch == 0:
        du.zero_()
        if ds0 is not None:
            ds0.zero_() if ds is None else ds0.copy_(ds)
        return _grads_as_inputs((dr, dk, dv, dw, du, ds0), *like)
    r, k = _build.strided(r, K), _build.strided(k, K)
    v = _build.strided(v, V)
    w = _build.strided(w.to(f32), K)
    dy = (torch.zeros((batch, T, H, V), dtype=r.dtype, device=dev)
          if dy is None else _build.strided(dy.to(r.dtype), V))
    u = u.to(f32).contiguous()
    s0 = None if state is None else state.to(f32).contiguous()
    ds = None if ds is None else ds.to(f32).contiguous()
    nb = -(-T // BWD_BLOCK)
    states = torch.empty((batch, H, nb + 1, K, V), dtype=f32, device=dev)
    adj = torch.empty_like(states)
    du_part = torch.empty((batch, nb, H, K), dtype=f32, device=dev)
    lib = _build.load("rwkv6_scan_backward")
    geometry = kernel_geometry(lib)
    if geometry != (BWD_BLOCK, BWD_SUB, BWD_WALK_THREADS):
        raise RuntimeError(f"rwkv6_scan_bwd.cu's block, sub-block and walk "
                           f"width {geometry} are not the wrapper's "
                           f"{(BWD_BLOCK, BWD_SUB, BWD_WALK_THREADS)}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_rwkv6_scan_backward(
            _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), u.data_ptr(), None if s0 is None else s0.data_ptr(),
            dy.data_ptr(), None if ds is None else ds.data_ptr(),
            states.data_ptr(), adj.data_ptr(), dr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(), du.data_ptr(),
            None if ds0 is None else ds0.data_ptr(), batch, T, H, K, V,
            *_build.outer(r), *_build.outer(k), *_build.outer(v),
            *_build.outer(w), *_build.outer(dy), stream)
    _build.check(err, "rwkv6_scan_backward")
    backward_launches.add()
    return _grads_as_inputs((dr, dk, dv, dw, du, ds0), *like)


def _grads_as_inputs(grads, k, v, w, u, state):
    """``(dr, dk, dv, dw, du, ds0)`` with dk, dv, dw, du and ds0 in k's,
    v's, w's, u's and the state's dtypes (dr is in r's already)."""
    dr, dk, dv, dw, du, ds0 = grads
    return (dr, dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du.to(u.dtype), None if ds0 is None else ds0.to(state.dtype))


def rwkv6_scan_backward_meta(r, k, v, w, u, state, dy, ds, *, chunk: int = 64
                             ) -> tuple:
    """The backward kernel's route for ``meta`` tensors: the gradients
    of :func:`rwkv6_scan_backward_cuda`'s shapes and dtypes, no values,
    its float32 scratch (the states and adjoints at every block
    boundary) live beside them, and one launch of the backward's work
    (:func:`work.wkv_bwd_work`) in the active cost counter.  An operand
    on another device raises."""
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state), ("dy", dy), ("ds", ds)):
        if t is not None and not t.is_meta:
            raise ValueError(f"{name} is on {t.device}, r on meta")
    batch, T, H, K = r.shape
    V = v.shape[3]
    grads = tuple(None if t is None else
                  torch.empty(t.shape, dtype=t.dtype, device="meta")
                  for t in (r, k, v, w, u, state))
    if T and batch:
        nb = -(-T // BWD_BLOCK)
        scratch = torch.empty((2, batch, H, nb + 1, K, V),
                              dtype=torch.float32, device="meta")
        nbytes, products, _ = work.wkv_bwd_work(
            batch, T, H, K, V, r.element_size(), state is not None,
            ds is not None)
        work.record_kernel("rwkv6_scan_backward", nbytes, products)
        del scratch
    return grads


class RwkvWKV(torch.autograd.Function):
    """Autograd's view of the WKV6 scan: the kernel (the plain chunked
    form on the CPU, the kernel's meta route on ``meta``) forward; the
    backward kernel (its plain version
    :func:`ref.rwkv6_chunked_backward` on the CPU, its meta route on
    ``meta``) backward.  Saves only the inputs; either output's
    cotangent may be absent (a training step never reads the final
    state)."""

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
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        if inputs[0].is_cuda:
            grads = rwkv6_scan_backward_cuda(*inputs, dy, ds,
                                             chunk=ctx.chunk)
        elif inputs[0].is_meta:
            grads = rwkv6_scan_backward_meta(*inputs, dy, ds,
                                             chunk=ctx.chunk)
        else:
            grads = ref.rwkv6_chunked_backward(*inputs, dy, ds, needs,
                                               chunk=ctx.chunk)
        return (*[g if n and t is not None else None
                  for g, n, t in zip(grads, needs, inputs)], None)


def rwkv6_scan(r, k, v, w, u, state=None, *, chunk: int = 64):
    """Differentiable chunked WKV6: ``(y in r's dtype, final state
    (B,H,K,V) float32)``."""
    if r.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel and no plain path for tensors on "
                         f"{r.device}")
    return RwkvWKV.apply(r, k, v, w, u, state, chunk)
