"""Mamba2 SSD's backward (K4's backward kernel, ``csrc/mamba2_ssd_bwd.cu``)
on the CPU: its plain version ``ref.mamba2_ssd_chunked_backward`` against
``jax.vjp`` of the JAX package's ``mamba2_ssd_chunked_jnp`` (what the
reference differentiates off the TPU) and against autograd through the
port's plain chunked forward, ``ref.recomputed_vjp``; the Function's CPU
route; the plain version at the kernel's own 64-step blocks against
autograd at the Function's 128-step chunks; and a mirror of the
kernel's launch geometry (its items cover every (batch, block, head)
exactly once in slices that never cross a group, each persistent CTA
taking its items in the kernel's order; its blocks and walks cover
every step and state entry exactly once, at the block length, walk
width and slice that ``csrc/mamba2_ssd_bwd.cu`` defines); and a float32
emulation of its slice-partial sums of dB and dC against the reference.

Same numpy inputs and cotangents in both packages: with an initial state
and without, with D and without; with a cotangent for y, for the final
state, or both; T in {1, 3, 17, 130, 260} (across the kernel's 64-step
blocks and the plain version's chunks); G in {1, 2}; decays of the
model's spread, near 0 (A dt about 1e-4) and strong (la reaching -200
within a 128-step chunk); float32 and bfloat16 x, B, C and dy; subsets
of the inputs needing a gradient.

Tolerances, those of ``tests/test_torch_scan_grads.py``, each gradient
against the reference's, elementwise: float32 1e-5 of the gradient's
largest magnitude plus 1e-4 relative (the same float32 gradient, summed
in another order); a bfloat16 gradient one bfloat16 step (2^-7 relative
plus 1e-3 of its largest magnitude: both compute in float32 from the
same operands and round once); a float32 input's gradient behind a
bfloat16 output (dt's, A's, D's, the state's) 1e-3 of its largest
magnitude.  Autograd through the port's plain forward runs on float32
copies and rounds each gradient to its input's dtype once: that
forward casts a bfloat16 x once a use, so autograd through it would
round dx twice (the JAX reference's forward does the same).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import ref

F32_ATOL, F32_RTOL = 1e-5, 1e-4
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -7
WIDE_ATOL = 1e-3    # a float32 input behind a bfloat16 output
NAMES = ("x", "dt", "A", "Bm", "Cm", "D", "state")
LOW = ("x", "Bm", "Cm", "dy")   # bfloat16 in a bfloat16 model


def _case(seed, B, T, H, P, G, N, decay="model"):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    A = -np.exp(n(H, scale=0.3))
    if decay == "near0":        # A dt about -1e-4 a step
        dt = rng.uniform(0.5, 1.5, (B, T, H)) * 1e-4 / -A
    elif decay == "strong":     # about -1.6 a step: -200 over 128 steps
        dt = rng.uniform(1.2, 2.0, (B, T, H)) / -A
    else:
        dt = np.log1p(np.exp(n(B, T, H))) * 0.5
    return {"x": n(B, T, H, P), "dt": dt.astype(np.float32),
            "A": A.astype(np.float32), "Bm": n(B, T, G, N, scale=0.5),
            "Cm": n(B, T, G, N, scale=0.5), "D": np.abs(n(H, scale=0.1)),
            "state": n(B, H, P, N, scale=0.1), "dy": n(B, T, H, P),
            "dh": n(B, H, P, N)}


def _dtype_of(name, dtype):
    return dtype if name in LOW else torch.float32


def _torch(c, name, dtype):
    t = torch.from_numpy(np.ascontiguousarray(c[name]))
    return t.to(_dtype_of(name, dtype))


def _jax(c, name, dtype):
    x = jnp.asarray(c[name])
    return x.astype(jnp.bfloat16) if _dtype_of(name, dtype) == \
        torch.bfloat16 else x


def _present(with_state, with_d):
    return [n for n in NAMES if (n != "state" or with_state)
            and (n != "D" or with_d)]


def _reference(c, dtype, with_state, with_d, with_dy, with_dh, chunk):
    """The reference's gradients (None for an absent D or state) by
    ``jax.vjp`` of ``mamba2_ssd_chunked_jnp``; a missing cotangent is
    zeros."""
    names = _present(with_state, with_d)

    def f(*a):
        kw = dict(zip(names, a))
        return jref.mamba2_ssd_chunked_jnp(
            kw["x"], kw["dt"], kw["A"], kw["Bm"], kw["Cm"], kw.get("D"),
            kw.get("state"), chunk=chunk)

    (y, h), vjp = jax.vjp(f, *[_jax(c, n, dtype) for n in names])
    dy = _jax(c, "dy", dtype) if with_dy else jnp.zeros_like(y)
    dh = jnp.asarray(c["dh"]) if with_dh else jnp.zeros_like(h)
    got = dict(zip(names, vjp((dy, dh))))
    return [got.get(n) for n in NAMES]


def _inputs(c, dtype, with_state, with_d):
    names = _present(with_state, with_d)
    return [_torch(c, n, dtype) if n in names else None for n in NAMES]


def _plain(c, dtype, with_state, with_d, with_dy, with_dh, chunk,
           needs=(True,) * 7):
    inputs = _inputs(c, dtype, with_state, with_d)
    dy = _torch(c, "dy", dtype) if with_dy else None
    dh = torch.from_numpy(c["dh"]) if with_dh else None
    return inputs, ref.mamba2_ssd_chunked_backward(*inputs, dy, dh, needs,
                                                   chunk=chunk)


def _check(got, want, name, low_output):
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(jnp.asarray(want, jnp.float32)))
    assert got is not None, name
    g = got.float().numpy()
    top = float(np.abs(want).max()) or 1.0
    if got.dtype == torch.bfloat16:
        atol, rtol = BF16_ATOL * top, BF16_RTOL
    elif low_output:
        atol, rtol = WIDE_ATOL * top, F32_RTOL
    else:
        atol, rtol = F32_ATOL * top, F32_RTOL
    np.testing.assert_allclose(g, want, atol=atol, rtol=rtol, err_msg=name)


def _check_all(inputs, got, want, dtype):
    for name, t, g, w in zip(NAMES, inputs, got, want):
        if t is None:
            assert g is None and w is None, name
            continue
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _check(g, w, f"d{name}", dtype == torch.bfloat16)


def _chunk(T):
    return min(128, max(T, 8))     # the Function's chunk, the TPU rule


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,G,with_state", [
    (1, 2, True), (3, 1, False), (3, 1, True), (17, 2, False), (17, 2, True),
    (130, 1, False), (130, 1, True), (260, 2, False), (260, 2, True)])
def test_plain_backward_matches_the_reference_vjp(dtype, T, G, with_state):
    c = _case(T + G, 2, T, 4, 8, G, 6)
    want = _reference(c, dtype, with_state, True, True, True, _chunk(T))
    inputs, got = _plain(c, dtype, with_state, True, True, True, _chunk(T))
    _check_all(inputs, got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_lone_step_without_a_state_has_no_decay_gradient(dtype):
    """T = 1 with no initial state: the step's decay multiplies nothing,
    so dA is 0 in exact arithmetic, and the plain backward gives exactly
    0 (M's row and column sums cancel term for term; u's share and its
    sum at the chunk's last step cancel).  The reference's autodiff gives
    float32 noise there (3.7e-9 against ddt's terms of order 1), so its
    dA is held to 1e-6 of the largest |dt ddt| instead of compared with
    noise; every other gradient against the reference as above."""
    c = _case(3, 2, 1, 4, 8, 2, 6)
    want = _reference(c, dtype, False, True, True, True, 8)
    inputs, got = _plain(c, dtype, False, True, True, True, 8)
    assert not bool(got[2].any())
    scale = float((got[1] * inputs[1]).abs().max())
    assert float(np.abs(np.asarray(want[2])).max()) <= 1e-6 * scale
    got[2], want[2] = None, None
    inputs[2] = None
    _check_all(inputs, got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cotangent", ["dy", "dh"])
@pytest.mark.parametrize("with_state,with_d", [(False, False), (True, True),
                                               (True, False)])
def test_plain_backward_with_one_cotangent(dtype, cotangent, with_state,
                                           with_d):
    """Only y's cotangent (a training step) or only the final state's:
    the missing one counts as zeros, as autograd's absent gradient; with
    and without the initial state and D."""
    c = _case(7, 2, 45, 4, 8, 2, 8)
    with_dy, with_dh = cotangent == "dy", cotangent == "dh"
    want = _reference(c, dtype, with_state, with_d, with_dy, with_dh, 16)
    inputs, got = _plain(c, dtype, with_state, with_d, with_dy, with_dh, 16)
    _check_all(inputs, got, want, dtype)
    if with_dh and with_d:      # y's cotangent absent: no skip gradient
        assert not bool(got[5].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", ["near0", "strong"])
def test_plain_backward_at_extreme_decays(dtype, decay):
    """Decays near 0 (A dt about -1e-4: the state keeps every step) and
    strong (about -1.6 a step, la reaching -200 within a 128-step chunk:
    no factor may overflow, and exp(la) underflows to 0 across the
    chunk)."""
    c = _case(11, 2, 150, 3, 8, 1, 8, decay)
    if decay == "strong":
        la = np.cumsum(c["A"][None, None] * c["dt"][:, :128], axis=1)
        assert la.min() < -200
    want = _reference(c, dtype, True, True, True, True, 128)
    inputs, got = _plain(c, dtype, True, True, True, True, 128)
    _check_all(inputs, got, want, dtype)
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,chunk", [(1, 8), (17, 16), (45, 64), (130, 128),
                                     (130, 8)])
def test_plain_backward_matches_the_recomputed_vjp(dtype, T, chunk):
    """Against autograd through the plain chunked forward on the same
    tensors (``ref.recomputed_vjp``, the port's earlier backward), at the
    Function's chunk lengths."""
    c = _case(T + chunk, 1, T, 2, 8, 1, 8)
    inputs, got = _plain(c, dtype, True, True, True, True, chunk)
    _check_all(inputs, got, _autograd(c, inputs, dtype, chunk), dtype)


def _autograd(c, inputs, dtype, chunk):
    """``ref.recomputed_vjp`` on float32 copies of ``inputs`` with both
    cotangents, each gradient rounded to its input's dtype once."""
    want = ref.recomputed_vjp(
        ref.mamba2_ssd_chunked, [t.float() for t in inputs], [True] * 7,
        (_torch(c, "dy", dtype).float(), torch.from_numpy(c["dh"])),
        chunk=chunk)
    return [w.to(t.dtype) for w, t in zip(want, inputs)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decay", ["model", "strong"])
def test_plain_backward_at_the_kernels_block_holds_autograd(dtype, decay):
    """The backward kernel tiles by its own 64-step blocks whatever the
    forward's chunk: its plain version at chunk 64 against autograd
    through the plain forward at the Function's chunk 128, with grouped
    B/C, a ragged tail and decays of the model's spread or strong (la
    reaching -200 within a 128-step chunk)."""
    c = _case(23, 2, 300, 4, 8, 2, 8, decay)
    inputs, got = _plain(c, dtype, True, True, True, True, ssd.BWD_BLOCK)
    _check_all(inputs, got, _autograd(c, inputs, dtype, 128), dtype)


@pytest.mark.parametrize("needs", [
    (True, False, False, False, False, False, False),
    (False, True, True, False, False, True, False),
    (False, False, False, True, True, False, True),
    (True, True, True, True, True, True, False)])
def test_plain_backward_and_function_take_subsets_of_needs(needs):
    """Gradients only where ``needs`` is set (None elsewhere), equal to
    the full call's; through the Function, a leaf that needs no gradient
    gets none and the others equal the plain backward's bits."""
    c = _case(5, 2, 40, 4, 8, 2, 8)
    inputs, full = _plain(c, torch.bfloat16, True, True, True, False, 16)
    _, part = _plain(c, torch.bfloat16, True, True, True, False, 16,
                     needs=needs)
    for name, n, f, p in zip(NAMES, needs, full, part):
        assert (p is None) if not n else torch.equal(p, f), name
    leaves = [t.clone().requires_grad_(n) for t, n in zip(inputs, needs)]
    y, _ = ssd.mamba2_ssd(*leaves, chunk=16)
    y.backward(_torch(c, "dy", torch.bfloat16))
    for name, n, t, f in zip(NAMES, needs, leaves, full):
        assert (t.grad is None) if not n else torch.equal(t.grad, f), name


def test_function_without_any_cotangent_gives_zero_gradients():
    """A loss that reads neither output through the scan: zeros (None for
    the absent state), as autograd gives."""
    c = _case(3, 1, 20, 2, 8, 1, 8)
    leaves = [_torch(c, n, torch.float32).requires_grad_()
              for n in NAMES[:6]]
    ssd.mamba2_ssd(*leaves)
    grads = ssd.MambaSSD.backward(type("Ctx", (), {
        "saved_tensors": (*[t.detach() for t in leaves], None),
        "needs_input_grad": (True,) * 6 + (False, False),
        "chunk": 20})(), None, None)
    assert all(not bool(g.any()) for g in grads[:6])
    assert grads[6] is None and grads[7] is None


def test_function_backward_is_the_plain_backward_on_the_cpu():
    """The Function's CPU backward is the plain backward on the same
    tensors, bit for bit, with both cotangents and grouped B/C."""
    c = _case(9, 2, 70, 4, 8, 2, 8)
    inputs = _inputs(c, torch.float32, True, True)
    leaves = [t.clone().requires_grad_() for t in inputs]
    y, h = ssd.mamba2_ssd(*leaves, chunk=32)
    dy, dh = torch.from_numpy(c["dy"]), torch.from_numpy(c["dh"])
    torch.autograd.backward([y, h], [dy, dh])
    want = ref.mamba2_ssd_chunked_backward(*inputs, dy, dh, chunk=32)
    for name, t, w in zip(NAMES, leaves, want):
        assert torch.equal(t.grad, w), name


# ------------------------------------------------------ launch geometry
@pytest.mark.parametrize("T", [1, 3, 17, 63, 64, 65, 130, 260, 4096])
def test_kernel_blocks_cover_every_step_once(T):
    """``backward_blocks`` mirrors the blocks an item takes for one
    (batch, head): their steps partition [0, T) in 64-step blocks (the
    tail stopping at T), each reads the state at its start boundary and
    the adjoint at its end, and together they read every boundary the
    walks write; the items of ``backward_items`` take these blocks."""
    blocks = ssd.backward_blocks(T)
    assert sorted({it["block"] for c in ssd.backward_items(1, T, 8, 1, 5)
                   for it in c}) == [b["block"] for b in blocks]
    assert [t for b in blocks for t in b["steps"]] == list(range(T))
    nb = -(-T // 64)
    assert len(blocks) == nb
    for b in blocks:
        assert b["state"] == b["block"] and b["adjoint"] == b["block"] + 1
        assert all(b["state"] * 64 <= t < b["adjoint"] * 64
                   for t in b["steps"])
    assert {b["state"] for b in blocks} | {b["adjoint"] for b in blocks} == \
        set(range(nb + 1))


@pytest.mark.parametrize("B,H,P,N,T", [(1, 2, 64, 64, 130), (2, 3, 40, 24, 3),
                                       (1, 5, 8, 6, 260), (3, 1, 7, 5, 1)])
def test_kernel_walks_cover_every_state_entry_once(B, H, P, N, T):
    """``backward_walks`` mirrors the walk: in each direction the threads
    of its CTAs hold every (batch, head, p, n) state entry exactly once,
    in the kernel's (B, H, P, N) order, and each steps through every
    boundary once: the states from 0 up, the adjoints from nb down."""
    nb, walks = ssd.backward_walks(B, H, P, N, T)
    assert nb == -(-T // 64)
    order = [(b, h, p, n) for b in range(B) for h in range(H)
             for p in range(P) for n in range(N)]
    for direction, bounds in (("states", list(range(nb + 1))),
                              ("adjoints", list(range(nb, -1, -1)))):
        mine = [w for w in walks if w["direction"] == direction]
        assert [e for w in mine for e in w["entries"]] == order
        assert all(len(w["entries"]) <= 256 for w in mine)
        assert all(w["boundaries"] == bounds for w in mine)


@pytest.mark.parametrize("B,T,H,G,grid", [
    (1, 4096, 80, 1, 132), (1, 130, 6, 2, 132), (2, 77, 5, 5, 3),
    (2, 300, 24, 2, 7), (1, 1, 12, 1, 132), (3, 17, 16, 4, 2),
    (2, 1300, 32, 1, 132)])
def test_kernel_items_cover_every_head_once(B, T, H, G, grid):
    """``backward_items`` mirrors the persistent CTAs of the local and
    gradient passes: their items hold every (batch, block, head) exactly
    once; a slice's heads are consecutive, of one group and at most
    ``BWD_SLICE``; a group's slices differ in size by at most one; and
    CTA c takes items c, c + grid, .. of the order batch, block, slice
    (the kernel's ``item_at``), walking each slice's heads in order."""
    ctas = ssd.backward_items(B, T, H, G, grid)
    nb, rep = -(-T // 64), H // G
    nsl = -(-rep // ssd.BWD_SLICE)
    total = B * nb * G * nsl
    assert len(ctas) == min(grid, total)
    seen = [(it["batch"], it["block"], h) for c in ctas for it in c
            for h in it["heads"]]
    assert sorted(seen) == [(b, j, h) for b in range(B) for j in range(nb)
                            for h in range(H)]
    for c, items in enumerate(ctas):
        for n, it in enumerate(items):
            i = c + n * grid
            assert (it["batch"], it["block"], it["slice"]) == (
                i // (nb * G * nsl), i // (G * nsl) % nb, i % (G * nsl))
            heads = it["heads"]
            assert heads == list(range(heads[0], heads[0] + len(heads)))
            assert 1 <= len(heads) <= ssd.BWD_SLICE
            assert {h // rep for h in heads} == {it["group"]}
    sizes = [hi - lo for _, lo, hi in ssd.backward_slices(H, G)]
    assert max(sizes) - min(sizes) <= 1 and len(sizes) == G * nsl


@pytest.mark.parametrize("H,G", [(6, 2), (24, 1), (5, 5), (16, 1), (12, 2)])
def test_slice_partial_sums_hold_the_reference(H, G):
    """The kernel's order of dB's and dC's sums over a group's heads (a
    slice's heads in order, then the slices' partials in order:
    ``backward_group_sums``) on each head's float32 share (the plain
    backward with B and C repeated to every head) against the grouped
    gradients of ``ref.mamba2_ssd_chunked_backward`` at the kernel's
    block and of ``jax.vjp`` of ``mamba2_ssd_chunked_jnp``, float32."""
    c = _case(H + G, 2, 70, H, 8, G, 6)
    rep = H // G
    per_head = dict(c, Bm=np.repeat(c["Bm"], rep, axis=2),
                    Cm=np.repeat(c["Cm"], rep, axis=2))
    _, shares = _plain(per_head, torch.float32, True, True, True, True,
                       ssd.BWD_BLOCK)
    _, grouped = _plain(c, torch.float32, True, True, True, True,
                        ssd.BWD_BLOCK)
    want = _reference(c, torch.float32, True, True, True, True, 64)
    for k, name in ((3, "dB"), (4, "dC")):
        got = ssd.backward_group_sums(shares[k], G)
        assert got.shape == grouped[k].shape
        _check(got, grouped[k], f"{name} against the plain backward", False)
        _check(got, want[k], f"{name} against jax.vjp", False)


@pytest.mark.parametrize("constant,mirror", [
    ("BL", "BWD_BLOCK"), ("WALK_THREADS", "BWD_WALK_THREADS"),
    ("SLICE", "BWD_SLICE")])
def test_mirrors_take_the_kernels_constants(constant, mirror):
    """The block length, walk width and slice the mirrors (and the
    wrapper's scratch) use are the ones ``csrc/mamba2_ssd_bwd.cu``
    defines and reports through ``repro_mamba2_ssd_backward_geometry``
    (which the wrapper checks on the card)."""
    source = (Path(ssd.__file__).parent / "csrc" /
              "mamba2_ssd_bwd.cu").read_text()
    found = re.findall(rf"constexpr int {constant} = (\d+);", source)
    assert found == [str(getattr(ssd, mirror))]
    assert re.search(rf"out\[\d\] = {constant};", source)
