"""Plain PyTorch versions of the kernels: the CPU execution path and the
oracle each CUDA kernel is held against on the card.

Ported so far: attention (naive and grouped single-token decode, both
plain code on every device, as in the JAX package's serving path), the
Gaussian blur and the Mamba2 SSD scan (sequential and chunked).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# ===================================================================
# attention
# ===================================================================
def naive_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    kv_len=None,       # int or (B,) valid cache length for decode
    q_offset: int = 0,  # absolute position of q[0] (causal w/ cache)
) -> torch.Tensor:
    """Exact softmax attention with GQA head repetition.  O(Sq*Sk) memory."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32))
    logits = logits * sm_scale
    Sk = k.shape[1]
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    mask = mask[None, None]                                   # (1,1,Sq,Sk)
    if kv_len is not None:
        if isinstance(kv_len, torch.Tensor):
            mask = mask & (kpos[None, None, None, :]
                           < kv_len.to(q.device)[:, None, None, None])
        else:
            mask = mask & (kpos < kv_len)
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.to(torch.float32))
    return out.to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,        # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,
    cache_len,              # int or (B,) number of valid positions
    *,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """GQA-aware single-token attention: q heads grouped per kv head so
    the cache is never materialised repeated."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                     k_cache.to(torch.float32)) * scale
    kpos = torch.arange(Sk, device=q.device)
    if isinstance(cache_len, torch.Tensor):
        cache_len = cache_len.to(q.device)
        if cache_len.ndim == 0:
            cache_len = cache_len.expand(B)
        mask = kpos[None, :] < cache_len[:, None]           # (B, Sk)
    else:
        mask = (kpos < cache_len)[None, :].expand(B, Sk)
    s = torch.where(mask[:, None, None, None, :], s, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v_cache.to(torch.float32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


# ===================================================================
# gaussian blur (separable, reflect-101 borders a la OpenCV)
# ===================================================================
def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0:  # OpenCV convention
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    w = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (w / w.sum()).astype(np.float32)


def reflect101_index(n: int, pad: int) -> np.ndarray:
    """Source index of every position of a length-``n`` axis padded by
    ``pad`` on both sides with reflect-101 borders (``dcb|abcd|cba``),
    repeating the reflection when ``pad`` exceeds ``n - 1`` exactly as
    ``numpy.pad(mode="reflect")`` does."""
    j = np.abs(np.arange(-pad, n + pad))
    if n == 1:
        return np.zeros_like(j)
    period = 2 * (n - 1)
    j = j % period
    return np.where(j < n, j, period - j)


def _reflect101_pad(x: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    idx = torch.from_numpy(reflect101_index(x.shape[axis], pad))
    return x.index_select(axis, idx.to(x.device))


def gaussian_blur_ref(img: torch.Tensor, ksize: int, sigma_x: float,
                      sigma_y: float | None = None) -> torch.Tensor:
    """img: (..., H, W, C) float; separable blur along H then W, each
    pass summed tap by tap in float32 in the order of the taps."""
    if sigma_y is None:
        sigma_y = sigma_x
    kx = [float(v) for v in gaussian_kernel_1d(ksize, sigma_x)]
    ky = [float(v) for v in gaussian_kernel_1d(ksize, sigma_y)]
    pad = ksize // 2
    dtype = img.dtype
    x = img.to(torch.float32)
    h, w = x.shape[-3], x.shape[-2]
    # vertical (H axis = -3)
    xp = _reflect101_pad(x, pad, axis=-3)
    out = sum(ky[i] * xp.narrow(-3, i, h) for i in range(ksize))
    # horizontal (W axis = -2)
    xp = _reflect101_pad(out, pad, axis=-2)
    out = sum(kx[i] * xp.narrow(-2, i, w) for i in range(ksize))
    return out.to(dtype)


# ===================================================================
# Mamba2 SSD
# ===================================================================
def mamba2_ssd_ref(
    x: torch.Tensor,    # (B, T, H, P)
    dt: torch.Tensor,   # (B, T, H)      softplus-ed already, > 0
    A: torch.Tensor,    # (H,)           negative
    Bm: torch.Tensor,   # (B, T, G, N)
    Cm: torch.Tensor,   # (B, T, G, N)
    D: torch.Tensor | None = None,      # (H,)
    state: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence:
    h_t = exp(A dt_t) h_{t-1} + dt_t * x_t B_t^T ; y_t = h_t C_t + D x_t."""
    B_, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f32 = torch.float32
    h = (torch.zeros((B_, H, P, N), dtype=f32, device=x.device)
         if state is None else state.to(f32))
    xf, dtf, Af = x.to(f32), dt.to(f32), A.to(f32)
    Bf = Bm.to(f32).repeat_interleave(rep, dim=2)  # (B,T,H,N)
    Cf = Cm.to(f32).repeat_interleave(rep, dim=2)
    ys = []
    for t in range(T):
        dtt = dtf[:, t]                                            # (B,H)
        decay = torch.exp(Af[None] * dtt)[..., None, None]         # (B,H,1,1)
        h = decay * h + (dtt[..., None, None] * xf[:, t, :, :, None]
                         * Bf[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B_, 0, H, P), dtype=f32, device=x.device))
    if D is not None:
        y = y + D[None, None, :, None].to(f32) * xf
    return y.to(x.dtype), h


def mamba2_ssd_chunked(
    x, dt, A, Bm, Cm, D=None, state=None, chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (the Mamba2 paper's blocked algorithm), the JAX
    package's ``mamba2_ssd_chunked_jnp`` step for step: the tail is
    padded with dt = 0 and x = B = C = 0, which adds nothing to y and
    does not decay the state.  The plain version of the SSD kernel."""
    B_, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f32 = torch.float32
    pad = (-T) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Tp = T + pad
    n = Tp // chunk
    h = (torch.zeros((B_, H, P, N), dtype=f32, device=x.device)
         if state is None else state.to(f32))
    Af = A.to(f32)

    # (n, B, H, c, *)
    xf = x.to(f32).reshape(B_, n, chunk, H, P).permute(1, 0, 3, 2, 4)
    dtf = dt.to(f32).reshape(B_, n, chunk, H).permute(1, 0, 3, 2)
    Bf = Bm.to(f32).repeat_interleave(rep, dim=2).reshape(
        B_, n, chunk, H, N).permute(1, 0, 3, 2, 4)
    Cf = Cm.to(f32).repeat_interleave(rep, dim=2).reshape(
        B_, n, chunk, H, N).permute(1, 0, 3, 2, 4)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, None]
    ys = []
    for i in range(n):
        xc, dtc, bc, cc = xf[i], dtf[i], Bf[i], Cf[i]
        la = torch.cumsum(Af[None, :, None] * dtc, dim=2)        # (B,H,c)
        # intra-chunk: y_t += sum_{s<=t} exp(la_t - la_s) dt_s (C_t.B_s) x_s
        diff = la[:, :, :, None] - la[:, :, None, :]             # (B,H,c,c)
        L = torch.exp(torch.where(tri, diff, -1e30))
        cb = torch.einsum("bhtn,bhsn->bhts", cc, bc)
        att = cb * L * dtc[:, :, None, :]
        y = torch.einsum("bhts,bhsp->bhtp", att, xc)
        # inter-chunk: y_t += exp(la_t) C_t . h_in
        y = y + torch.einsum("bhtn,bhpn->bhtp",
                             cc * torch.exp(la)[..., None], h)
        # state: h_out = exp(la_last) h_in + sum_s exp(la_last - la_s) dt_s x_s B_s^T
        la_last = la[:, :, -1]
        w = torch.exp(la_last[:, :, None] - la) * dtc            # (B,H,c)
        h = torch.exp(la_last)[..., None, None] * h + torch.einsum(
            "bhcp,bhcn->bhpn", xc * w[..., None], bc)
        ys.append(y)
    y = (torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B_, Tp, H, P)[:, :T]
         if ys else torch.zeros((B_, 0, H, P), dtype=f32, device=x.device))
    if D is not None:
        y = y + D[None, None, :, None].to(f32) * x.to(f32)[:, :T]
    return y.to(x.dtype), h
