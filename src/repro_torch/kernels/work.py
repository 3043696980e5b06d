"""The hand-written kernels' work and the card's rates: one copy, for
the kernels' ``meta`` routes (the dry run's records), the dry run's
roofline terms (``launch.costs``, ``launch.dryrun``) and
``chip_smoke.py``'s bounds.

A kernel's work is counted for the function it computes, not for the
plain chunked form that stands for it on the CPU: the bytes each input
and output must move once, and the operations it must do.  A ``meta``
route reports one launch of that work through :func:`record_kernel` to
every :class:`KernelRecorder` dispatch mode that is active (the dry
run's ``launch.costs.CostCounter``).
"""
from __future__ import annotations

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

# NVIDIA H100 SXM5 80GB, NVIDIA's data sheet (dense rates): HBM3
# bandwidth; float32 operations outside the tensor cores; and matrix
# products on the tensor cores for each operand type: bfloat16 at 989
# TF/s, float32 kept at float32 accuracy as three TF32 passes (3xTF32)
# at 495/3 TF/s
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
PRODUCT_FLOP_S = {"torch.float32": 495e12 / 3, "torch.bfloat16": 989e12}
PEAK_FLOPS = PRODUCT_FLOP_S["torch.bfloat16"]
# NVLink 4 (18 links), per direction.  A model axis of 16 spans two
# 8-card nodes, whose traffic between nodes crosses the slower network:
# the collective term at this rate is a lower bound
NVLINK_BYTES_S = 450e9


class KernelRecorder:
    """A dispatch mode that takes the kernels' launches: :meth:`kernel`
    is called once a launch."""

    def kernel(self, name: str, nbytes: int, products: int) -> None:
        raise NotImplementedError


def record_kernel(name: str, nbytes: int, products: int) -> None:
    """One launch of kernel ``name`` and its work, in every
    :class:`KernelRecorder` that is active (none: nothing is recorded)."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, KernelRecorder):
            mode.kernel(name, nbytes, products)


def ssd_work(B, T, H, P, G, N, itemsize):
    """Bytes, matrix-product operations and other operations of one SSD
    call, counted for the function: the chunked form is exact at any
    chunk length and its products grow with the length (the causal half
    of C Bᵀ and its product with x), so they are counted at length 1,
    the recurrence.  Bytes: x and y in their type, B and C by group
    (never repeated to heads), dt, A, D and both states in float32, each
    once.  Products, per (batch, head) step: C_t · B_t and its product
    with x_t (2N + 2P), the readout C_t · h (2NP) and the state update
    dt x_t B_tᵀ (2NP).  Other: the step's decay and dt factors (3), the
    exp(la) scale and D skip (4P), the update's weights (3P) and the
    state's decay (NP)."""
    nbytes = (2 * B * T * H * P + 2 * B * T * G * N) * itemsize \
        + (B * T * H + 2 * H + 2 * B * H * P * N) * 4
    steps = B * T * H
    return (nbytes, (2 * N + 2 * P + 4 * N * P) * steps,
            (3 + 7 * P + N * P) * steps)


def wkv_work(B, T, H, K, V, itemsize):
    """Bytes, matrix-product operations and other operations of one
    WKV6 call, counted for the function and not for the chunked
    algorithm: with w given, the sequential recurrence needs no
    exponential.  Bytes: r, k, v and y in their type, w in float32, u
    and both states in float32, each once.  Products, per (batch, head)
    step, as SSD's: the readout r · S (2KV) and the state update k vᵀ
    (2KV).  Other: the state's decay w S (KV) and the bonus
    (r u · k) v (3K + 2V)."""
    nbytes = (3 * B * T * H * K + B * T * H * V) * itemsize \
        + (B * T * H * K + H * K + 2 * B * H * K * V) * 4
    steps = B * T * H
    return nbytes, 4 * K * V * steps, (K * V + 3 * K + 2 * V) * steps


def wkv_bwd_work(B, T, H, K, V, itemsize, state=False, ds=False):
    """Bytes, matrix-product operations and other operations of WKV6's
    backward alone (the backward kernel), counted per step as
    :func:`wkv_work` counts the forward.  Bytes: r, k, v and dy read and
    dr, dk, dv written once in their type; w read and dw written once in
    float32; u read and du written in float32; with an initial state, it
    read and ds0 written, and with a final state's cotangent, it read, in
    float32.  Products per (batch, head) step: the adjoint's update
    r dyᵀ, the readouts dr = S dy, dk = G v and dv = Gᵀ k, and the
    decay's sum of G ∘ S_prev, 2KV each (10KV).  Other: the adjoint's
    decay w G (KV) and the bonus terms' gradients (6K + 4V)."""
    nbytes = (2 * B * T * H * K + 2 * B * T * H * V) * itemsize \
        + (2 * B * T * H * K + B * T * H * V) * itemsize \
        + 2 * B * T * H * K * 4 + 2 * H * K * 4 \
        + (2 * bool(state) + bool(ds)) * B * H * K * V * 4
    steps = B * T * H
    return nbytes, 10 * K * V * steps, (K * V + 6 * K + 4 * V) * steps


def ssd_bwd_work(B, T, H, P, G, N, itemsize, state=False, dh=False):
    """Bytes, matrix-product operations and other operations of SSD's
    backward alone (the backward kernel), counted per step as
    :func:`ssd_work` counts the forward.  Bytes: x and dy read and dx
    written once in their type; B and C read and dB, dC written once by
    group in their type; dt read and ddt written once, A and D read and
    dA, dD written, in float32; with an initial state, it read and its
    gradient written, and with a final state's cotangent, it read, in
    float32.  Products per (batch, head) step, :func:`ssd_grad_work`'s
    backward: C_t · B_s and dy_t · x_s again and their products (2N +
    2P), and the readout's two (dh += dy Cᵀ and dC = hᵀ dy) and the
    update's three (dx = dt dh B, dB = dt dhᵀ x, and the decay's sum of
    dh ∘ h_prev), 2NP each.  Other: the forward's (the adjoint's decay,
    the weights and the skip's gradient)."""
    nbytes = (3 * B * T * H * P + 4 * B * T * G * N) * itemsize \
        + (2 * B * T * H + 4 * H) * 4 \
        + (2 * bool(state) + bool(dh)) * B * H * P * N * 4
    steps = B * T * H
    return (nbytes, (2 * N + 2 * P + 10 * N * P) * steps,
            (3 + 7 * P + N * P) * steps)


def visible_pairs(Sq, Sk, q_offset, causal) -> int:
    """The (query, key) pairs attention must visit: every key when not
    causal, keys up to ``q_offset + row`` when causal."""
    if not causal:
        return Sq * Sk
    # rows whose window is cut at q_offset + i + 1 keys, then full rows
    cut = max(0, min(Sq, Sk - q_offset))
    return cut * q_offset + cut * (cut + 1) // 2 + (Sq - cut) * Sk


def attn_work(B, Sq, Sk, H, Hkv, D, q_offset, causal, itemsize):
    """Bytes and operations of one flash-attention call over the
    (query, key) pairs it must visit: every key when not causal, keys
    up to ``q_offset + row`` when causal.  Bytes: q and out in their
    type, the keys and values that some row sees, by kv head, and the
    float32 log-sum-exp, each once.  Products: 2D for the logit and 2D
    for its share of P V per visible pair and head.  Other: the scale,
    running max, exponential and sum of each visible pair and head
    (4)."""
    pairs = visible_pairs(Sq, Sk, q_offset, causal)
    keys = min(Sk, q_offset + Sq) if causal else Sk
    nbytes = (2 * B * Sq * H * D + 2 * B * keys * Hkv * D) * itemsize \
        + B * Sq * H * 4
    return nbytes, 4 * pairs * D * H * B, 4 * pairs * H * B


def attn_bwd_work(B, Sq, Sk, H, Hkv, D, q_offset, causal, itemsize):
    """Bytes and operations of flash attention's recomputing backward
    alone (the backward kernel), over the visible (query, key) pairs.
    Bytes: q, out and dO read and dq written once, the keys and values
    that some row sees read once and dk, dv written over every key (0
    where no row sees it), by kv head, in their type; the float32
    log-sum-exp and delta = rowsum(dO·O), once each.  Products, as
    FlashAttention-2 counts the function: 10D a visible pair and head
    (S = Q Kᵀ again, dP = dO Vᵀ, dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K).
    Other: the exponential, difference and two scalings (4)."""
    pairs = visible_pairs(Sq, Sk, q_offset, causal)
    keys = min(Sk, q_offset + Sq) if causal else Sk
    nbytes = (4 * B * Sq * H * D + 2 * B * (keys + Sk) * Hkv * D) \
        * itemsize + 2 * B * Sq * H * 4
    return nbytes, 10 * pairs * D * H * B, 4 * pairs * H * B


def attn_grad_work(B, Sq, Sk, H, Hkv, D, q_offset, causal, itemsize):
    """Bytes and operations of flash attention's forward and recomputing
    backward together, over the visible (query, key) pairs: q, k, v and
    the output's cotangent read once, the output and dq, dk, dv written
    once.  Products, as FlashAttention-2 counts them: 4D a visible pair
    and head forward (Q Kᵀ, P V) and 10D backward (Q Kᵀ again, Pᵀ dO,
    dO Vᵀ, dS K, dSᵀ Q: 2.5 times the forward's), 14D in all.  Other:
    the forward's 4 and the backward's exponential, difference and two
    scalings (4) a visible pair and head."""
    pairs = visible_pairs(Sq, Sk, q_offset, causal)
    nbytes = (4 * B * Sq * H * D + 4 * B * Sk * Hkv * D) * itemsize
    return nbytes, 14 * pairs * D * H * B, 8 * pairs * H * B


def ssd_grad_work(B, T, H, P, G, N, itemsize):
    """Bytes and operations of one SSD call forward and backward as a
    training step runs it (no initial state, a cotangent for y only),
    counted per step as :func:`ssd_work` counts the forward.  Bytes: x,
    B, C, dt, A and D read once and y written once; dy read once and
    dx, dB, dC, ddt, dA and dD written once.  Products per (batch, head)
    step: the forward's 2N + 2P + 4NP, and the backward's 2N + 2P +
    10NP: the readout's two (dh += dy Cᵀ and dC = hᵀ dy) and the
    update's three (dx = dt dh B, dB = dt dhᵀ x, and the decay's sum of
    dh ∘ h_prev), 2NP each.  Other: twice the forward's."""
    nbytes = (4 * B * T * H * P + 4 * B * T * G * N) * itemsize \
        + (2 * B * T * H + 4 * H) * 4
    steps = B * T * H
    return (nbytes, (4 * N + 4 * P + 14 * N * P) * steps,
            (6 + 14 * P + 2 * N * P) * steps)


def wkv_grad_work(B, T, H, K, V, itemsize):
    """Bytes and operations of one WKV6 call forward and backward as a
    training step runs it (no initial state, a cotangent for y only),
    counted per step as :func:`wkv_work` counts the forward.  Bytes: r,
    k, v and y in their type and w in float32, each once; dy read once,
    dr, dk and dv written once in their type and dw in float32; u and du
    in float32.  Products per (batch, head) step: the forward's readout
    and update (4KV) and the backward's five (dS += r dyᵀ, dr = S dy,
    dk = dS v, dv = dSᵀ k and the decay's sum of dS ∘ S_prev: 10KV).
    Other: twice the forward's."""
    nbytes = (4 * B * T * H * K + 4 * B * T * H * V) * itemsize \
        + 8 * B * T * H * K + 8 * H * K
    steps = B * T * H
    return (nbytes, 14 * K * V * steps,
            2 * (K * V + 3 * K + 2 * V) * steps)
