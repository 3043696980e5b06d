"""The SSD (K4) and WKV6 (K5) scans under autograd: the port's
``torch.autograd.Function`` classes (``kernels/mamba2_ssd.MambaSSD`` and
``kernels/rwkv6_scan.RwkvWKV``, reached through ``kernels/ops.py``)
against ``jax.vjp`` of the JAX package's chunked forms
(``repro.kernels.ref.mamba2_ssd_chunked_jnp``, ``rwkv6_chunked_jnp``),
which is what the reference differentiates off the TPU.  On the CPU the
Function's forward is the plain chunked form and its backward the plain
version of the scan's backward kernel (``ref.mamba2_ssd_chunked_backward``
and ``ref.rwkv6_chunked_backward``, the closed-form gradients chunk by
chunk in float32; ``tests/test_torch_ssd_backward.py`` and
``tests/test_torch_wkv_backward.py`` hold them over every case the
kernels take, and ``tests/test_torch_cuda.py`` the kernels against
them).

Same numpy inputs and cotangents (for ``y`` and the final state) in
both packages; with an initial state and without one; a length that is
no multiple of the chunk; grouped B/C (G > 1) for SSD; float32 and
bfloat16 operands.

Tolerances, each gradient against the reference's, elementwise:

- float32: 1e-5 of the gradient's largest magnitude plus 1e-4 relative
  (the same float32 chunked sums in other orders);
- bfloat16: both packages compute in float32 from the same bfloat16
  operands and round each gradient of a bfloat16 input to bfloat16 once,
  so they may land one bfloat16 step apart: 2^-7 relative plus 1e-3 of
  the gradient's largest magnitude.  A float32 input's gradient (SSD's
  dt, A, D; WKV6's w) keeps the float32 tolerance widened to 1e-3 of its
  largest magnitude: its cotangent passes through the bfloat16-rounded
  output's.

One reference gradient is taken another way.  WKV6's bonus ``u`` is one
tensor that every chunk reads; ``jax.lax.scan``'s transpose accumulates
the cotangent of such a captured constant in the constant's own dtype,
so the reference sums a bfloat16 ``u``'s gradient over the chunks in
bfloat16 (2.3e-2 off float32 accumulation on a gradient of 12.75, three
chunks).  The port converts ``u`` to float32 once and accumulates in
float32, so its bfloat16 ``du`` is held against ``jax.vjp`` of the
reference with ``u`` given as float32 (the same bfloat16 values): the
float32 sum, rounded once.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import rwkv6_scan as wkv

F32_ATOL, F32_RTOL = 1e-5, 1e-4
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -7
WIDE_ATOL = 1e-3    # a float32 input behind a bfloat16 output


def _check(got: torch.Tensor, want, name, low_precision_output):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got is not None, name
    g = got.float().numpy()
    top = float(np.abs(want).max()) or 1.0
    if got.dtype == torch.bfloat16:
        atol, rtol = BF16_ATOL * top, BF16_RTOL
    elif low_precision_output:
        atol, rtol = WIDE_ATOL * top, F32_RTOL
    else:
        atol, rtol = F32_ATOL * top, F32_RTOL
    np.testing.assert_allclose(g, want, atol=atol, rtol=rtol, err_msg=name)


def _to_jax(a, dtype):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if dtype == torch.bfloat16 else x


def _to_torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype == torch.bfloat16 else t


def _bf16_round(a, dtype):
    """The numpy value of ``a`` as both packages hold it in ``dtype``."""
    if dtype == torch.bfloat16:
        return a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


# ------------------------------------------------------------------ SSD
def _ssd_case(seed, B, T, H, P, G, N, with_state):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    dt = np.log1p(np.exp(n(B, T, H))) * 0.5
    return {"x": n(B, T, H, P), "dt": dt.astype(np.float32),
            "A": -np.exp(n(H, scale=0.3)), "Bm": n(B, T, G, N, scale=0.5),
            "Cm": n(B, T, G, N, scale=0.5), "D": np.abs(n(H, scale=0.1)),
            "state": n(B, H, P, N, scale=0.1) if with_state else None,
            "dy": n(B, T, H, P), "dh": n(B, H, P, N)}


SSD_LOW = ("x", "Bm", "Cm")     # the operands that take the model's dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T,G,chunk", [(37, 2, 16), (24, 1, 8)])
def test_ssd_function_gradients_match_the_reference_vjp(dtype, with_state,
                                                        T, G, chunk):
    B, H, P, N = 2, 4, 8, 6
    c = _ssd_case(T + G, B, T, H, P, G, N, with_state)
    names = ["x", "dt", "A", "Bm", "Cm", "D"] + (["state"] if with_state
                                                 else [])
    low = {k: dtype if k in SSD_LOW else torch.float32 for k in names}
    args_j = [_to_jax(c[k], low[k]) for k in names]
    if not with_state:
        args_j.append(None)
    k_chunk = min(chunk, max(T, 8))

    def f(*a):
        return jref.mamba2_ssd_chunked_jnp(*a, chunk=k_chunk)

    (y_j, h_j), vjp = jax.vjp(lambda *a: f(*a), *[a for a in args_j
                                                   if a is not None])
    dy = _bf16_round(c["dy"], dtype)
    want = vjp((_to_jax(dy, dtype), jnp.asarray(c["dh"])))

    args_t = [_to_torch(c[k], low[k]).requires_grad_() for k in names]
    state = args_t[6] if with_state else None
    y, h = ops.mamba2_ssd(*args_t[:6], state=state, chunk=chunk)
    assert y.dtype == dtype and h.dtype == torch.float32
    assert y.grad_fn is not None and type(y.grad_fn).__name__.startswith(
        "MambaSSD")
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(y_j.astype(jnp.float32)),
                               atol=1e-4 if dtype == torch.float32 else 0.05,
                               rtol=0 if dtype == torch.float32 else 2 ** -7)
    torch.autograd.backward([y, h], [_to_torch(dy, dtype),
                                     torch.from_numpy(c["dh"])])
    for name, t, w in zip(names, args_t, want):
        assert t.grad.dtype == t.dtype, name
        _check(t.grad, w, f"d{name}", dtype == torch.bfloat16)


def test_ssd_function_takes_a_missing_cotangent_and_partial_inputs():
    """Only y's cotangent (a training step never reads the final state),
    and gradients for x and D alone: the others come back ``None``; the
    result equals autograd through the plain chunked form."""
    from repro_torch.kernels import ref
    c = _ssd_case(3, 1, 20, 4, 8, 1, 6, with_state=True)
    names = ["x", "dt", "A", "Bm", "Cm", "D", "state"]
    want_grad = {"x", "D"}

    def leaves():
        return [torch.from_numpy(c[k]).requires_grad_(k in want_grad)
                for k in names]

    a = leaves()
    y, _ = ssd.mamba2_ssd(*a[:6], a[6], chunk=8)
    (y * torch.from_numpy(c["dy"])).sum().backward()
    b = leaves()
    y_p, _ = ref.mamba2_ssd_chunked(*b[:6], b[6], chunk=8)
    (y_p * torch.from_numpy(c["dy"])).sum().backward()
    for name, t, u in zip(names, a, b):
        if name in want_grad:
            torch.testing.assert_close(t.grad, u.grad, atol=1e-6, rtol=1e-6)
        else:
            assert t.grad is None, name
    with torch.no_grad():
        assert ssd.mamba2_ssd(*a[:6], a[6])[0].grad_fn is None


# ----------------------------------------------------------------- WKV6
def _wkv_case(seed, B, T, H, K, with_state):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    w = np.exp(-np.exp(-1.0 + n(B, T, H, K, scale=0.5)))
    return {"r": n(B, T, H, K, scale=0.5), "k": n(B, T, H, K, scale=0.5),
            "v": n(B, T, H, K), "w": w.astype(np.float32),
            "u": n(H, K, scale=0.1),
            "state": n(B, H, K, K, scale=0.1) if with_state else None,
            "dy": n(B, T, H, K), "ds": n(B, H, K, K)}


WKV_LOW = ("r", "k", "v", "u")  # bfloat16 in a bfloat16 model; w float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T,chunk", [(45, 16), (32, 8)])
def test_wkv_function_gradients_match_the_reference_vjp(dtype, with_state,
                                                        T, chunk):
    B, H, K = 2, 3, 8
    c = _wkv_case(T, B, T, H, K, with_state)
    names = ["r", "k", "v", "w", "u"] + (["state"] if with_state else [])
    low = {k: dtype if k in WKV_LOW else torch.float32 for k in names}
    args_j = [_to_jax(c[k], low[k]) for k in names]

    def f(*a):
        return jref.rwkv6_chunked_jnp(*a, chunk=chunk)

    (y_j, s_j), vjp = jax.vjp(f, *args_j)
    dy = _bf16_round(c["dy"], dtype)
    cts = (_to_jax(dy, dtype), jnp.asarray(c["ds"]))
    want = list(vjp(cts))
    if dtype == torch.bfloat16:   # du summed over the chunks in float32
        u32 = args_j[4].astype(jnp.float32)
        want[4] = jax.vjp(lambda u: f(*args_j[:4], u, *args_j[5:]), u32)[1](
            cts)[0]

    args_t = [_to_torch(c[k], low[k]).requires_grad_() for k in names]
    state = args_t[5] if with_state else None
    y, s = ops.rwkv6_scan(*args_t[:5], state, chunk=chunk)
    assert y.dtype == dtype and s.dtype == torch.float32
    assert type(y.grad_fn).__name__.startswith("RwkvWKV")
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(y_j.astype(jnp.float32)),
                               atol=1e-4 if dtype == torch.float32 else 0.05,
                               rtol=0 if dtype == torch.float32 else 2 ** -7)
    torch.autograd.backward([y, s], [_to_torch(dy, dtype),
                                     torch.from_numpy(c["ds"])])
    for name, t, w in zip(names, args_t, want):
        assert t.grad.dtype == t.dtype, name
        _check(t.grad, w, f"d{name}", dtype == torch.bfloat16)


def test_wkv_function_without_the_state_cotangent_matches_autograd():
    """Only y's cotangent, a bfloat16 model's mix of dtypes: the
    Function's CPU backward is the plain backward
    (``ref.rwkv6_chunked_backward``) on the same tensors, bit for bit, and
    within the bfloat16 tolerances above of autograd through the plain
    chunked form (the closed form sums in another order than autograd,
    then both round to bfloat16 once)."""
    from repro_torch.kernels import ref
    c = _wkv_case(5, 1, 40, 2, 8, with_state=False)
    names = ["r", "k", "v", "w", "u"]

    def leaves():
        return [torch.from_numpy(c[k]).to(
            torch.bfloat16 if k in WKV_LOW else torch.float32)
            .requires_grad_() for k in names]

    a, b = leaves(), leaves()
    dy = torch.from_numpy(c["dy"]).to(torch.bfloat16)
    (wkv.rwkv6_scan(*a, chunk=16)[0].float() * dy.float()).sum().backward()
    (ref.rwkv6_chunked(*b, chunk=16)[0].float() * dy.float()).sum().backward()
    plain = ref.rwkv6_chunked_backward(*[t.detach() for t in a], None, dy,
                                       None, chunk=16)
    for name, t, u, p in zip(names, a, b, plain):
        assert t.grad.dtype == t.dtype
        torch.testing.assert_close(t.grad, p, atol=0, rtol=0, msg=name)
        _check(t.grad, u.grad.float().numpy(), f"d{name}", True)
