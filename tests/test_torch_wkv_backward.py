"""WKV6's backward (K5's backward kernel, ``csrc/rwkv6_scan_bwd.cu``) on
the CPU: its plain version ``ref.rwkv6_chunked_backward`` against
``jax.vjp`` of the JAX package's ``rwkv6_chunked_jnp`` (what the
reference differentiates off the TPU) and against the port's earlier
backward, ``ref.recomputed_vjp`` of the plain chunked forward; the
Function's CPU route; and a mirror of the kernel's launch geometry (its
64-step blocks and their 16-step sub-blocks cover every step once, its
walk every state entry and boundary once, every boundary written is
read), held to the constants the kernel's source defines.

Same numpy inputs and cotangents in both packages: with an initial state
and without; with a cotangent for y, for the final state, or both; T in
{1, 3, 17, 45, 130} (across the kernel's 16-step sub-blocks and 64-step
blocks and the plain version's 64-step chunks); decays of the model's spread, near
0, near 1 (some exactly 1) and cut by the clamp at 1e-30; float32 and
bfloat16 operands; subsets of the inputs needing a gradient.

Tolerances, those of ``tests/test_torch_scan_grads.py``, each gradient
against the reference's, elementwise: float32 1e-5 of the gradient's
largest magnitude plus 1e-4 relative (the same float32 gradient, summed
in another order); a bfloat16 gradient one bfloat16 step (2^-7 relative
plus 1e-3 of its largest magnitude: both compute in float32 from the
same operands and round once); a float32 input's gradient behind a
bfloat16 output (w's, the state's) 1e-3 of its largest magnitude.
Near-0 decays hold dw as w·dw = dlogw: dw = dlogw / w multiplies
dlogw's float32 rounding, a difference of sums of terms up to 1/w
larger than it, by 1/w in every implementation, the reference's autodiff
among them (at w in (0.02, 0.1) the reference's dw and the float64
gradient differ by 3e-4 on values up to 31).  A bfloat16 ``u``'s
gradient is taken from the reference with ``u`` given as float32, as in
``tests/test_torch_scan_grads.py`` (its scan sums the cotangent of a
captured bfloat16 constant in bfloat16).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as wkv

F32_ATOL, F32_RTOL = 1e-5, 1e-4
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -7
WIDE_ATOL = 1e-3    # a float32 input behind a bfloat16 output
NAMES = ("r", "k", "v", "w", "u", "state")
LOW = ("r", "k", "v", "u", "dy")    # bfloat16 in a bfloat16 model


def _case(seed, B, T, H, K, V, decay="model"):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    shape = (B, T, H, K)
    if decay == "near0":
        w = rng.uniform(0.02, 0.1, shape)
    elif decay == "near1":
        w = np.where(rng.uniform(size=shape) < 0.1, 1.0,
                     rng.uniform(0.999, 1.0, shape))
    else:
        w = np.exp(-np.exp(-1.0 + n(*shape, scale=0.5)))
        if decay == "clamp":
            cut = rng.uniform(size=shape)
            w = np.where(cut < 0.1, 0.0, np.where(cut < 0.2, 1e-31, w))
    return {"r": n(*shape, scale=0.5), "k": n(*shape, scale=0.5),
            "v": n(B, T, H, V), "w": w.astype(np.float32),
            "u": n(H, K, scale=0.1), "state": n(B, H, K, V, scale=0.1),
            "dy": n(B, T, H, V), "ds": n(B, H, K, V)}


def _dtype_of(name, dtype):
    return dtype if name in LOW else torch.float32


def _torch(c, name, dtype):
    t = torch.from_numpy(np.ascontiguousarray(c[name]))
    return t.to(_dtype_of(name, dtype))


def _jax(c, name, dtype):
    x = jnp.asarray(c[name])
    return x.astype(jnp.bfloat16) if _dtype_of(name, dtype) == \
        torch.bfloat16 else x


def _reference(c, dtype, with_state, with_dy, with_ds, chunk=16):
    """The reference's gradients (None for the state when absent) by
    ``jax.vjp`` of ``rwkv6_chunked_jnp``; a missing cotangent is zeros."""
    args = [_jax(c, n, dtype) for n in NAMES[:5]] + (
        [jnp.asarray(c["state"])] if with_state else [])

    def f(*a):
        return jref.rwkv6_chunked_jnp(*a, chunk=chunk)

    (y, s), vjp = jax.vjp(f, *args)
    dy = _jax(c, "dy", dtype) if with_dy else jnp.zeros_like(y)
    ds = jnp.asarray(c["ds"]) if with_ds else jnp.zeros_like(s)
    want = list(vjp((dy, ds)))
    if dtype == torch.bfloat16:     # du summed over the chunks in float32
        want[4] = jax.vjp(lambda u: f(*args[:4], u, *args[5:]),
                          args[4].astype(jnp.float32))[1]((dy, ds))[0]
    return want + ([] if with_state else [None])


def _plain(c, dtype, with_state, with_dy, with_ds, needs=(True,) * 6,
           chunk=64):
    inputs = [_torch(c, n, dtype) for n in NAMES[:5]] + [
        torch.from_numpy(c["state"]) if with_state else None]
    dy = _torch(c, "dy", dtype) if with_dy else None
    ds = torch.from_numpy(c["ds"]) if with_ds else None
    return inputs, ref.rwkv6_chunked_backward(*inputs, dy, ds, needs,
                                              chunk=chunk)


def _check(got, want, name, low_output, decays=None):
    want = np.asarray(jnp.asarray(want, jnp.float32)) if not isinstance(
        want, torch.Tensor) else want.float().numpy()
    assert got is not None, name
    g = got.float().numpy()
    if decays is not None:          # dw held as dlogw
        g, want = g * decays, want * decays
    top = float(np.abs(want).max()) or 1.0
    if got.dtype == torch.bfloat16:
        atol, rtol = BF16_ATOL * top, BF16_RTOL
    elif low_output:
        atol, rtol = WIDE_ATOL * top, F32_RTOL
    else:
        atol, rtol = F32_ATOL * top, F32_RTOL
    np.testing.assert_allclose(g, want, atol=atol, rtol=rtol, err_msg=name)


def _check_all(inputs, got, want, dtype, decays=None):
    for name, t, g, w in zip(NAMES, inputs, got, want):
        if t is None:
            assert g is None and w is None, name
            continue
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _check(g, w, f"d{name}", dtype == torch.bfloat16,
               decays if name == "w" else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 3, 17, 45, 130])
def test_plain_backward_matches_the_reference_vjp(dtype, with_state, T):
    c = _case(T, 2, T, 3, 8, 6)
    want = _reference(c, dtype, with_state, True, True)
    inputs, got = _plain(c, dtype, with_state, True, True)
    _check_all(inputs, got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("cotangent", ["dy", "ds"])
def test_plain_backward_with_one_cotangent(dtype, with_state, cotangent):
    """Only y's cotangent (a training step) or only the final state's:
    the missing one counts as zeros, as autograd's absent gradient."""
    c = _case(7, 2, 45, 2, 8, 8)
    with_dy, with_ds = cotangent == "dy", cotangent == "ds"
    want = _reference(c, dtype, with_state, with_dy, with_ds)
    inputs, got = _plain(c, dtype, with_state, with_dy, with_ds)
    _check_all(inputs, got, want, dtype)
    if with_ds:     # y's cotangent absent: no bonus, no readout terms
        assert not bool(got[4].float().any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", ["near0", "near1", "clamp"])
def test_plain_backward_at_extreme_decays(dtype, decay):
    """Decays near 0 (dw held as dlogw, see above), near 1 with some
    exactly 1 (the padded tail's value inside the sequence), and cut by
    the clamp (0 and 1e-31, where the gradient is 0 in both packages).
    The clamp's log-decays of -69 a step make a chunk's cumulative sums
    large, and the decay between two steps, a difference of two of
    them, keeps float32's bits only relative to them (in the reference
    too): that case runs both at the reference's chunk of 16 steps, the
    kernel's block."""
    c = _case(11, 2, 45, 3, 8, 8, decay)
    want = _reference(c, dtype, True, True, True)
    inputs, got = _plain(c, dtype, True, True, True,
                         chunk=16 if decay == "clamp" else 64)
    _check_all(inputs, got, want, dtype,
               c["w"] if decay == "near0" else None)
    if decay == "clamp":
        cut = c["w"] < 1e-30
        assert cut.any() and not got[3].numpy()[cut].any()
        assert not np.asarray(want[3])[cut].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,chunk", [(1, 64), (17, 16), (45, 64), (130, 64),
                                     (130, 8)])
def test_plain_backward_matches_the_recomputed_vjp(dtype, T, chunk):
    """Against the port's earlier backward on the same tensors:
    ``ref.recomputed_vjp`` (autograd through the plain chunked forward),
    at the Function's chunk lengths."""
    c = _case(T + chunk, 1, T, 2, 8, 8)
    inputs, got = _plain(c, dtype, True, True, True, chunk=chunk)
    want = ref.recomputed_vjp(
        ref.rwkv6_chunked, inputs, [True] * 6,
        (_torch(c, "dy", dtype), torch.from_numpy(c["ds"])), chunk=chunk)
    _check_all(inputs, got, want, dtype)


@pytest.mark.parametrize("T,chunk", [(17, 16), (130, 64)])
def test_plain_forward_in_float64_is_the_recurrence(T, chunk):
    """``ref.rwkv6_chunked(..., compute_dtype=torch.float64)``, the
    yardstick of the backward kernel's gradients on the card, is the
    WKV6 recurrence in float64: within 1e-10 of it step by step (numpy,
    float64), where the float32 route lies ~1e-6 away."""
    c = _case(T, 2, T, 2, 8, 8)
    r, k, v, w = (c[n].astype(np.float64) for n in ("r", "k", "v", "w"))
    u, s = c["u"].astype(np.float64), c["state"].astype(np.float64)
    want = np.empty_like(v)
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        want[:, t] = np.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[..., None] * kv)
        s = w[:, t, :, :, None] * s + kv
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, c["state"]
                                          .astype(np.float64))]
    y, s64 = ref.rwkv6_chunked(*args, chunk=chunk,
                               compute_dtype=torch.float64)
    assert y.dtype == s64.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), want, atol=1e-10, rtol=0)
    np.testing.assert_allclose(s64.numpy(), s, atol=1e-10, rtol=0)
    y32, _ = ref.rwkv6_chunked(*(a.float() for a in args), chunk=chunk)
    assert float(np.abs(y32.double().numpy() - want).max()) > 1e-9


@pytest.mark.parametrize("needs", [
    (True, False, False, False, False, False),
    (False, False, True, True, False, False),
    (False, False, False, False, True, True),
    (True, True, True, True, True, False)])
def test_plain_backward_and_function_take_subsets_of_needs(needs):
    """Gradients only where ``needs`` is set (None elsewhere), equal to
    the full call's; through the Function, a leaf that needs no gradient
    gets none and the others equal the plain backward's bits."""
    c = _case(5, 2, 40, 2, 8, 8)
    inputs, full = _plain(c, torch.bfloat16, True, True, False)
    _, part = _plain(c, torch.bfloat16, True, True, False, needs=needs)
    for name, n, f, p in zip(NAMES, needs, full, part):
        assert (p is None) if not n else torch.equal(p, f), name
    leaves = [t.clone().requires_grad_(n) for t, n in zip(inputs, needs)]
    y, _ = wkv.rwkv6_scan(*leaves, chunk=64)
    y.backward(_torch(c, "dy", torch.bfloat16))
    for name, n, t, f in zip(NAMES, needs, leaves, full):
        assert (t.grad is None) if not n else torch.equal(t.grad, f), name


def test_function_without_any_cotangent_gives_zero_gradients():
    """A loss that reads neither output through the scan (the final
    state summed with weight 0 elsewhere): zeros, as autograd gives."""
    c = _case(3, 1, 20, 2, 8, 8)
    leaves = [_torch(c, n, torch.float32).requires_grad_()
              for n in NAMES[:5]]
    y, s = wkv.rwkv6_scan(*leaves)
    grads = wkv.RwkvWKV.backward(type("Ctx", (), {
        "saved_tensors": (*[t.detach() for t in leaves], None),
        "needs_input_grad": (True,) * 5 + (False, False),
        "chunk": 64})(), None, None)
    assert all(not bool(g.any()) for g in grads[:5])
    assert grads[5] is None and grads[6] is None


# ------------------------------------------------------ launch geometry
@pytest.mark.parametrize("T", [1, 2, 3, 15, 16, 17, 31, 32, 45, 48, 63, 64,
                               65, 79, 100, 127, 128, 129, 130, 200, 260,
                               1000, 1536, 4095, 4096])
def test_kernel_blocks_and_sub_blocks_cover_every_step_once(T):
    """``backward_blocks`` mirrors the block CTAs for one (batch, head):
    their steps partition [0, T) in 64-step blocks (the tail stopping at
    T); each block's 16-step sub-blocks partition its steps in order,
    every one but the last whole and none past T; each block reads the
    state at its start boundary and the adjoint at its end, and its local
    pass writes its state share at the end boundary and its adjoint share
    at the start, so each boundary 1..nb gets one state share and
    0..nb-1 one adjoint share, and the gradient pass reads every
    boundary but the state at nb (S_T) and the adjoint at 0 (ds0)."""
    blocks = wkv.backward_blocks(T)
    nb = -(-T // 64)
    assert len(blocks) == nb
    assert [t for b in blocks for t in b["steps"]] == list(range(T))
    for b in blocks:
        j, steps, subs = b["block"], b["steps"], b["subs"]
        assert all(j * 64 <= t < (j + 1) * 64 for t in steps)
        assert [t for sub in subs for t in sub] == list(steps)
        assert 1 <= len(subs) <= 4
        assert all(len(sub) == 16 and sub.start % 16 == 0
                   for sub in subs[:-1])
        assert 1 <= len(subs[-1]) <= 16 and subs[-1].start % 16 == 0
        assert b["state"] == j and b["adjoint"] == j + 1
        assert b["shares"] == {"state": j + 1, "adjoint": j}
    assert sorted(b["shares"]["state"] for b in blocks) == \
        list(range(1, nb + 1))
    assert sorted(b["shares"]["adjoint"] for b in blocks) == list(range(nb))
    assert {b["state"] for b in blocks} == set(range(nb))
    assert {b["adjoint"] for b in blocks} == set(range(1, nb + 1))


@pytest.mark.parametrize("T", [1, 17, 64, 65, 130, 4096])
@pytest.mark.parametrize("B,H,K,V", [(1, 2, 64, 64), (2, 3, 16, 40),
                                     (1, 5, 40, 24), (3, 1, 7, 5)])
def test_kernel_walks_cover_every_state_entry_once(B, H, K, V, T):
    """``backward_walks`` mirrors the walk: in each direction the threads
    of its CTAs hold every (batch, head, k, v) state entry exactly once,
    in the kernel's (B, H, K, V) order, at most 256 a CTA, and each steps
    through every boundary once: the states from 0 up, the adjoints from
    nb down."""
    nb, walks = wkv.backward_walks(B, H, K, V, T)
    assert nb == -(-T // 64)
    order = [(b, h, k, v) for b in range(B) for h in range(H)
             for k in range(K) for v in range(V)]
    for direction, bounds in (("states", list(range(nb + 1))),
                              ("adjoints", list(range(nb, -1, -1)))):
        mine = [w for w in walks if w["direction"] == direction]
        assert [e for w in mine for e in w["entries"]] == order
        assert all(len(w["entries"]) <= 256 for w in mine)
        assert all(w["boundaries"] == bounds for w in mine)


@pytest.mark.parametrize("constant,mirror", [
    ("BL", "BWD_BLOCK"), ("SUB", "BWD_SUB"),
    ("WALK_THREADS", "BWD_WALK_THREADS")])
def test_mirrors_take_the_kernels_constants(constant, mirror):
    """The block, sub-block and walk widths the mirrors (and the
    wrapper's scratch) use are the ones ``csrc/rwkv6_scan_bwd.cu``
    defines and reports through ``repro_rwkv6_scan_backward_geometry``
    (which the wrapper checks on the card)."""
    source = (Path(wkv.__file__).parent / "csrc" /
              "rwkv6_scan_bwd.cu").read_text()
    found = re.findall(rf"constexpr int {constant} = (\d+);", source)
    assert found == [str(getattr(wkv, mirror))]
    assert re.search(rf"out\[\d\] = {constant};", source)
