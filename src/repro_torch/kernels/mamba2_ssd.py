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
tensor, and whose backward is the backward kernel
(``csrc/mamba2_ssd_bwd.cu``, :func:`mamba2_ssd_backward_cuda`) on a
CUDA tensor, a record of its launch on a meta tensor, and its plain
version :func:`ref.mamba2_ssd_chunked_backward` (the closed-form
gradient chunk by chunk in float32) on a CPU tensor: the gradient the
JAX package takes of ``mamba2_ssd_chunked_jnp`` by autodiff off the
TPU.  Each gradient comes back in its input's dtype.

The backward kernel tiles by its own 64-step blocks and cuts its work
into items: one batch, one block and a slice of up to ``BWD_SLICE``
consecutive heads of one group (:func:`backward_slices`).  A persistent
local pass, one CTA an SM walking its items in a fixed order
(:func:`backward_items`), computes each block's own shares of the state
and of its adjoint; a walk over the block boundaries, a thread a state
entry, turns them into the state entering and the adjoint leaving every
block (:func:`backward_walks` mirrors it); a persistent gradient pass
over the same items computes each block's gradients from them
(:func:`backward_blocks`), summing dB and dC over a slice's heads in
order, and each group's slices' partials (:func:`backward_group_sums`
mirrors the order), and dA's and dD's block shares, are summed in a
fixed order: no atomics, so two runs give equal bits.  The mirrors'
block length, walk width and slice are the kernel's own: the wrapper
sizes its scratch by them and refuses a library whose constants differ.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref, work

launches = _build.LaunchCounter("mamba2_ssd")
backward_launches = _build.LaunchCounter("mamba2_ssd_backward")

MAX_CHUNK = 128     # chunk rows staged per CTA
MAX_P = 64          # head dim the register tiles hold
MAX_N = 64          # state size the register tiles hold
# the backward kernel's BL, WALK_THREADS and SLICE, which
# repro_mamba2_ssd_backward_geometry reports
BWD_BLOCK = 64      # steps a block of the backward kernel covers
BWD_WALK_THREADS = 256  # state entries a CTA of the backward's walk holds
BWD_SLICE = 8       # heads of one group an item of the backward takes at most
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_build.declare("mamba2_ssd", "mamba2_ssd.cu", {
    "repro_mamba2_ssd": [ctypes.c_int] + [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]})
_build.declare("mamba2_ssd_backward", "mamba2_ssd_bwd.cu", {
    "repro_mamba2_ssd_backward": [ctypes.c_int] + [ctypes.c_void_p] * 23
    + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8 + [ctypes.c_void_p],
    "repro_mamba2_ssd_backward_geometry": [ctypes.POINTER(ctypes.c_int)]})


def _check_operands(what, x, dt, A, Bm, Cm, D, state, **more):
    """The device, dtype and shape checks both kernels' wrappers run:
    ``(batch, T, H, P, G, N)``.  ``more`` names further operands (None
    where absent) that must lie on x's device."""
    for name, t in dict(dt=dt, A=A, Bm=Bm, Cm=Cm, D=D, state=state,
                        **more).items():
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
        raise ValueError(f"{what}: inconsistent shapes")
    if H % G:
        raise ValueError(f"groups G={G} must divide heads H={H}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"the kernel takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"got P={P}, N={N}")
    if batch > 65535 or H > 65535:
        raise ValueError(f"batch {batch} or heads {H} exceed the grid's "
                         "65535")
    return batch, T, H, P, G, N


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
    batch, T, H, P, G, N = _check_operands("mamba2_ssd_cuda", x, dt, A, Bm,
                                           Cm, D, state)
    chunk = min(chunk, max(T, 8))
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {chunk}")
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


def backward_blocks(T):
    """The backward kernel's blocks for one (batch, head), as an item of
    ``csrc/mamba2_ssd_bwd.cu``'s gradient pass takes them: for each
    64-step block, the steps it writes gradients for (the tail stopping
    at T), the boundary whose state it reads (its start, h_in) and the
    boundary whose adjoint it reads (its end, G_out).  The local pass
    takes the same items and writes the block's share of the state at
    its end boundary and of the adjoint at its start."""
    nb = -(-T // BWD_BLOCK)
    return [{"block": j, "steps": range(j * BWD_BLOCK,
                                        min((j + 1) * BWD_BLOCK, T)),
             "state": j, "adjoint": j + 1} for j in range(nb)]


def backward_walks(B, H, P, N, T):
    """The backward kernel's walk over the block boundaries: for each
    CTA of ``BWD_WALK_THREADS`` threads and each direction, the
    (batch, head, p, n) state entries its threads hold (a thread past the
    last entry holds none), and the boundaries every thread steps
    through in order: the states forward from boundary 0 (the initial
    state) to ``nb``, the adjoints backward from ``nb`` (the final
    state's cotangent) to 0 (the initial state's gradient)."""
    nb = -(-T // BWD_BLOCK)
    total = B * H * P * N
    walks = []
    for direction, order in (("states", list(range(nb + 1))),
                             ("adjoints", list(range(nb, -1, -1)))):
        for cta in range(-(-total // BWD_WALK_THREADS)):
            entries = []
            for e in range(cta * BWD_WALK_THREADS,
                           min((cta + 1) * BWD_WALK_THREADS, total)):
                bh, pn = divmod(e, P * N)
                entries.append((*divmod(bh, H), *divmod(pn, N)))
            walks.append({"direction": direction, "entries": entries,
                          "boundaries": order})
    return nb, walks


def backward_slices(H, G):
    """The backward kernel's head slices, in order: ``(group, first head,
    end head)``.  A group's ``H // G`` heads go in ``ceil((H // G) /
    BWD_SLICE)`` slices of consecutive heads, slice k from head ``k rep
    // n`` of the group (rep heads, n slices): none crosses a group, none
    holds more than ``BWD_SLICE``."""
    rep = H // G
    nsl = -(-rep // BWD_SLICE)
    return [(g, g * rep + k * rep // nsl, g * rep + (k + 1) * rep // nsl)
            for g in range(G) for k in range(nsl)]


def backward_items(B, T, H, G, grid):
    """The persistent CTAs of the backward kernel's local and gradient
    passes, as ``csrc/mamba2_ssd_bwd.cu`` runs them: for each CTA of the
    ``min(grid, items)`` launched, its items in the order it takes them,
    each the batch, the 64-step block, the slice (its index over the
    groups' slices, :func:`backward_slices`), its group and its heads in
    the order the CTA walks them.  Item i (batch outermost, then block,
    then slice) goes to CTA ``i % grid``."""
    nb = -(-T // BWD_BLOCK)
    slices = backward_slices(H, G)
    items = [{"batch": b, "block": j, "slice": k, "group": slices[k][0],
              "heads": list(range(slices[k][1], slices[k][2]))}
             for b in range(B) for j in range(nb)
             for k in range(len(slices))]
    return [items[c::grid] for c in range(min(grid, len(items)))]


def backward_group_sums(shares, G):
    """dB or dC (B, T, G, N) in float32 from each head's share (B, T, H,
    N), in the backward kernel's order: a slice's heads summed in order
    (in each warp's registers), then a group's slices' partials in order
    (the group-sum pass)."""
    B_, T, H, N = shares.shape
    shares = shares.float()
    out = torch.zeros((B_, T, G, N), dtype=torch.float32,
                      device=shares.device)
    for g, lo, hi in backward_slices(H, G):
        part = torch.zeros((B_, T, N), dtype=torch.float32,
                           device=shares.device)
        for h in range(lo, hi):
            part = part + shares[:, :, h]
        out[:, :, g] += part
    return out


def kernel_geometry(lib) -> tuple[int, int, int]:
    """The backward library's own block length, walk width and slice,
    which the mirrors and the scratch sizes must equal."""
    out = (ctypes.c_int * 3)()
    _build.check(lib.repro_mamba2_ssd_backward_geometry(out),
                 "mamba2_ssd_backward geometry")
    return tuple(out)


def mamba2_ssd_backward_cuda(
    x: torch.Tensor,    # (B, T, H, P) float32 | bfloat16, on CUDA
    dt: torch.Tensor,   # (B, T, H)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, T, G, N), x's dtype
    Cm: torch.Tensor,   # (B, T, G, N), x's dtype
    D: torch.Tensor | None,       # (H,)
    state: torch.Tensor | None,   # (B, H, P, N) the initial state
    dy: torch.Tensor | None,      # (B, T, H, P) y's cotangent
    dh: torch.Tensor | None,      # (B, H, P, N) the final state's
) -> tuple:
    """Launch the SSD backward on the current CUDA stream (the local
    shares, the walk, the gradients, the fixed-order sums).  Returns
    ``(dx, ddt, dA, dB, dC, dD, dstate)``, each in its input's dtype
    (``dD`` None without D, ``dstate`` None without an initial state);
    a missing cotangent counts as zeros.  dt, A, D, the states and the
    cotangent ``dh`` are taken in float32, ``dy`` in x's dtype.  The
    kernel tiles by its own 64-step blocks, whatever the forward's
    chunk: the chunked form is exact at any length."""
    if not x.is_cuda:
        raise ValueError("mamba2_ssd_backward_cuda takes CUDA tensors, got "
                         f"x on {x.device}")
    _build.refuse_grad("mamba2_ssd_backward (no double backward)",
                       x, dt, A, Bm, Cm, D, state, dy, dh)
    batch, T, H, P, G, N = _check_operands(
        "mamba2_ssd_backward_cuda", x, dt, A, Bm, Cm, D, state, dy=dy, dh=dh)
    if ((dy is not None and tuple(dy.shape) != (batch, T, H, P))
            or (dh is not None and tuple(dh.shape) != (batch, H, P, N))):
        raise ValueError("mamba2_ssd_backward_cuda: inconsistent shapes")
    f32, dev = torch.float32, x.device
    like = (x, dt, A, Bm, Cm, D, state)      # the gradients' dtypes
    dx = torch.empty((batch, T, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((batch, T, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dB = torch.empty((batch, T, G, N), dtype=x.dtype, device=dev)
    dC = torch.empty_like(dB)
    dD = None if D is None else torch.empty((H,), dtype=f32, device=dev)
    dstate = (None if state is None else
              torch.empty((batch, H, P, N), dtype=f32, device=dev))
    if T == 0 or batch == 0:
        for g in (dA, dD):
            if g is not None:
                g.zero_()
        if dstate is not None:
            dstate.zero_() if dh is None else dstate.copy_(dh)
        return _grads_as_inputs((dx, ddt, dA, dB, dC, dD, dstate), *like)
    x = _build.strided(x, P)
    Bm, Cm = _build.strided(Bm, N), _build.strided(Cm, N)
    dy = (torch.zeros((batch, T, H, P), dtype=x.dtype, device=dev)
          if dy is None else _build.strided(dy.to(x.dtype), P))
    dt = dt.to(f32).contiguous()
    A = A.to(f32).contiguous()
    Df = None if D is None else D.to(f32).contiguous()
    h0 = None if state is None else state.to(f32).contiguous()
    dh = None if dh is None else dh.to(f32).contiguous()
    nb = -(-T // BWD_BLOCK)
    nsl = -(-(H // G) // BWD_SLICE)
    states = torch.empty((batch, H, nb + 1, P, N), dtype=f32, device=dev)
    adj = torch.empty_like(states)
    decay = torch.empty((batch, H, nb), dtype=f32, device=dev)
    # each slice's share of dB and dC
    dB_part = torch.empty((batch, T, G * nsl, N), dtype=f32, device=dev)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty((batch, H, nb), dtype=f32, device=dev)
    dD_part = torch.empty_like(dA_part)
    lib = _build.load("mamba2_ssd_backward")
    geometry = kernel_geometry(lib)
    if geometry != (BWD_BLOCK, BWD_WALK_THREADS, BWD_SLICE):
        raise RuntimeError(f"mamba2_ssd_bwd.cu's block, walk width and "
                           f"slice {geometry} are not the wrapper's "
                           f"{(BWD_BLOCK, BWD_WALK_THREADS, BWD_SLICE)}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_mamba2_ssd_backward(
            _DTYPES[x.dtype], *map(ptr, (
                x, dt, A, Bm, Cm, Df, h0, dy, dh, states, adj, decay, dx,
                ddt, dB_part, dC_part, dB, dC, dA_part, dD_part, dA, dD,
                dstate)),
            batch, T, H, P, G, N, *_build.outer(x), *_build.outer(Bm),
            *_build.outer(Cm), *_build.outer(dy), stream)
    _build.check(err, "mamba2_ssd_backward")
    backward_launches.add()
    return _grads_as_inputs((dx, ddt, dA, dB, dC, dD, dstate), *like)


def _grads_as_inputs(grads, x, dt, A, Bm, Cm, D, state):
    """The gradients, each in its input's dtype (dx is in x's already)."""
    return tuple(g if g is None else g.to(t.dtype)
                 for g, t in zip(grads, (x, dt, A, Bm, Cm, D, state)))


def mamba2_ssd_backward_meta(x, dt, A, Bm, Cm, D, state, dy, dh) -> tuple:
    """The backward kernel's route for ``meta`` tensors: the gradients
    of :func:`mamba2_ssd_backward_cuda`'s shapes and dtypes, no values,
    its float32 scratch (the states and adjoints at every block boundary,
    the slices' shares of dB and dC) live beside them, and one launch of
    the backward's work (:func:`work.ssd_bwd_work`) in the active cost
    counter.  An operand on another device raises."""
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("D", D),
                    ("state", state), ("dy", dy), ("dh", dh)):
        if t is not None and not t.is_meta:
            raise ValueError(f"{name} is on {t.device}, x on meta")
    batch, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    grads = tuple(None if t is None else
                  torch.empty(t.shape, dtype=t.dtype, device="meta")
                  for t in (x, dt, A, Bm, Cm, D, state))
    if T and batch:
        nb = -(-T // BWD_BLOCK)
        nsl = -(-(H // G) // BWD_SLICE)
        scratch = (torch.empty((2, batch, H, nb + 1, P, N),
                               dtype=torch.float32, device="meta"),
                   torch.empty((2, batch, T, G * nsl, N),
                               dtype=torch.float32, device="meta"))
        nbytes, products, _ = work.ssd_bwd_work(
            batch, T, H, P, G, N, x.element_size(), state is not None,
            dh is not None)
        work.record_kernel("mamba2_ssd_backward", nbytes, products)
        del scratch
    return grads


class MambaSSD(torch.autograd.Function):
    """Autograd's view of the SSD scan: the kernel (the plain chunked
    form on the CPU, the kernel's meta route on ``meta``) forward; the
    backward kernel (its plain version
    :func:`ref.mamba2_ssd_chunked_backward` on the CPU, its meta route on
    ``meta``) backward.  Saves only the inputs; either output's
    cotangent may be absent (a training step never reads the final
    state)."""

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
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[:7]
        if inputs[0].is_cuda:
            grads = mamba2_ssd_backward_cuda(*inputs, dy, dh)
        elif inputs[0].is_meta:
            grads = mamba2_ssd_backward_meta(*inputs, dy, dh)
        else:
            grads = ref.mamba2_ssd_chunked_backward(*inputs, dy, dh, needs,
                                                    chunk=ctx.chunk)
        return (*[g if n and t is not None else None
                  for g, n, t in zip(grads, needs, inputs)], None)


def mamba2_ssd(x, dt, A, Bm, Cm, D=None, state=None, *, chunk: int = 128):
    """Differentiable chunked SSD: ``(y in x's dtype, final state
    (B,H,P,N) float32)``, the chunk ``min(chunk, max(T, 8))`` (the TPU
    wrapper's rule) on both passes."""
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel and no plain path for tensors on "
                         f"{x.device}")
    return MambaSSD.apply(x, dt, A, Bm, Cm, D, state,
                          min(chunk, max(x.shape[1], 8)))
