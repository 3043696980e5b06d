"""Plain PyTorch versions of the kernels: the CPU execution path and the
oracle each CUDA kernel is held against on the card.

Every plain version of the JAX package's ``ref.py``: attention (naive,
chunked online softmax and grouped single-token decode), the Gaussian
blur, the RWKV6 WKV scan and the Mamba2 SSD scan (each sequential and
chunked); :func:`rwkv6_chunked_backward` and
:func:`mamba2_ssd_chunked_backward`, the plain versions of the scans'
backward kernels; and :func:`recomputed_vjp`, autograd through a plain
forward, which the tests hold those against.
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


def flash_attention_chunked(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    q_block: int = 512,
    kv_block: int = 1024,
    q_offset: int = 0,  # absolute position of q[0] (prefill into a cache)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax attention, O(q_block * kv_block) logits memory:
    ``(out (B,Sq,H,D) in q's dtype, lse (B,Sq,H) float32)``.  The JAX
    package's ``flash_vjp._fwd_impl`` step for step (q heads grouped per
    kv head, sequences padded to whole blocks, the finite ``-1e30`` mask
    bias on padded keys, padded rows and keys past ``q_offset + row``);
    its output is ``flash_attention_jnp``'s.  The one plain flash
    forward: the CPU route of ``ops.flash_attention`` and of
    ``flash_vjp.flash_attention``, and the plain version of K3."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    q_block = min(q_block, max(Sq, 1))
    kv_block = min(kv_block, max(Sk, 1))
    f32 = torch.float32
    pq, pk = (-Sq) % q_block, (-Sk) % kv_block
    qp = F.pad(q, (0, 0, 0, 0, 0, pq)).to(f32)
    kp = F.pad(k, (0, 0, 0, 0, 0, pk)).to(f32)
    vp = F.pad(v, (0, 0, 0, 0, 0, pk)).to(f32)
    nq, nk = qp.shape[1] // q_block, kp.shape[1] // kv_block
    dev = q.device
    outs, lses = [], []
    for qi in range(nq):
        qb = qp[:, qi * q_block:(qi + 1) * q_block].reshape(
            B, q_block, Hkv, G, D)
        qpos = qi * q_block + torch.arange(q_block, device=dev) + q_offset
        m_run = torch.full((B, Hkv, G, q_block), -1e30, dtype=f32,
                           device=dev)
        l_run = torch.zeros((B, Hkv, G, q_block), dtype=f32, device=dev)
        acc = torch.zeros((B, Hkv, G, q_block, D), dtype=f32, device=dev)
        for ki in range(nk):
            kb = kp[:, ki * kv_block:(ki + 1) * kv_block]
            vb = vp[:, ki * kv_block:(ki + 1) * kv_block]
            kpos = ki * kv_block + torch.arange(kv_block, device=dev)
            valid = (kpos[None, :] < Sk) & (qpos[:, None] < Sq + q_offset)
            if causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            s = s + torch.where(valid, 0.0, -1e30).to(f32)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                        p, vb)
            m_run = m_new
        o = acc / torch.clamp(l_run[..., None], min=1e-30)
        lse = m_run + torch.log(torch.clamp(l_run, min=1e-30))
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_block, H, D)
                    .to(q.dtype))
        lses.append(lse.permute(0, 3, 1, 2).reshape(B, q_block, H))
    return torch.cat(outs, dim=1)[:, :Sq], torch.cat(lses, dim=1)[:, :Sq]


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
# RWKV6 WKV scan
# ===================================================================
def rwkv6_scan_ref(
    r: torch.Tensor,  # (B, T, H, K)
    k: torch.Tensor,  # (B, T, H, K)
    v: torch.Tensor,  # (B, T, H, V)
    w: torch.Tensor,  # (B, T, H, K)  decay in (0,1), data-dependent
    u: torch.Tensor,  # (H, K)        bonus for the current token
    state: torch.Tensor | None = None,  # (B, H, K, V)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV6: S_t = diag(w_t) S_{t-1} + k_t v_t^T;
    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    s = (torch.zeros((B, H, K, V), dtype=f32, device=r.device)
         if state is None else state.to(f32))
    rf, kf, vf, wf = (a.to(f32) for a in (r, k, v, w))
    uf = u.to(f32)
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]         # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 s + uf[..., :, None] * kv))
        s = wf[:, t, :, :, None] * s + kv
    out = (torch.stack(outs, dim=1) if outs
           else torch.zeros((B, 0, H, V), dtype=f32, device=r.device))
    return out.to(r.dtype), s


def rwkv6_chunked(
    r, k, v, w, u, state=None, chunk: int = 64,
    compute_dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked closed form with log-space cumulative decays, the JAX
    package's ``rwkv6_chunked_jnp`` step for step: the tail is padded
    with w = 1 (and r = k = v = 0), which leaves the state as it was;
    ``log(max(w, 1e-30))`` keeps a zero decay finite.  The plain version
    of the WKV6 kernel.  It computes in float32; ``compute_dtype``
    float64 makes it a yardstick finer than the kernel (autograd through
    it holds the backward kernel's gradients on the card)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    cdt = compute_dtype
    pad = (-T) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    Tp = T + pad
    n = Tp // chunk
    s = (torch.zeros((B, H, K, V), dtype=cdt, device=r.device)
         if state is None else state.to(cdt))
    uf = u.to(cdt)
    # (n, B, H, c, K|V)
    rb, kb, vb, wb = (a.to(cdt).reshape(B, n, chunk, H, -1)
                      .permute(1, 0, 3, 2, 4) for a in (r, k, v, w))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)[None, None, :, :, None]
    ys = []
    for i in range(n):
        rc, kc, vc, wc = rb[i], kb[i], vb[i], wb[i]
        logw = torch.log(torch.clamp(wc, min=1e-30))
        lw = torch.cumsum(logw, dim=2)                           # (B,H,c,K)
        lw_prev = lw - logw                       # sum over strictly earlier
        # inter-chunk: r_t decayed against the incoming state
        y = torch.einsum("bhck,bhkv->bhcv", rc * torch.exp(lw_prev), s)
        # intra-chunk pairwise (per-channel decay: a (c,c,K) cube over K)
        diff = lw_prev[:, :, :, None, :] - lw[:, :, None, :, :]
        dec = torch.exp(torch.where(tri, diff, -1e30))
        att = torch.einsum("bhck,bhcsk,bhsk->bhcs", rc, dec, kc)
        y = y + torch.einsum("bhcs,bhsv->bhcv", att, vc)
        # current-token bonus
        y = y + torch.einsum("bhck,bhck->bhc", rc * uf[None, :, None, :],
                             kc)[..., None] * vc
        # state update
        lw_last = lw[:, :, -1:, :]                               # (B,H,1,K)
        s = torch.exp(lw_last[:, :, 0, :, None]) * s + torch.einsum(
            "bhck,bhcv->bhkv", kc * torch.exp(lw_last - lw), vc)
        ys.append(y)
    out = (torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, Tp, H, V)[:, :T]
           if ys else torch.zeros((B, 0, H, V), dtype=cdt, device=r.device))
    return out.to(r.dtype), s


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


# ===================================================================
# the scans' backward
# ===================================================================
def recomputed_vjp(plain, inputs, needs, cotangents, **kw) -> list:
    """The gradients of ``plain(*inputs, **kw)`` for the inputs whose
    ``needs`` flag is set (``None`` for the others, and for inputs that
    are ``None``), against ``cotangents``, one per output (``None``: no
    cotangent, read as zeros).  The plain version is recomputed under
    ``torch.enable_grad()`` on detached copies of the inputs and
    differentiated by ``torch.autograd.grad``: each gradient comes back
    in its input's dtype.  The independent reference of the scans'
    closed-form backwards (:func:`rwkv6_chunked_backward`,
    :func:`mamba2_ssd_chunked_backward`), as the JAX package
    differentiates the same chunked forms by autodiff off the TPU."""
    leaves = [None if t is None else t.detach().requires_grad_(bool(n))
              for t, n in zip(inputs, needs)]
    wrt = [t for t in leaves if t is not None and t.requires_grad]
    if not wrt:
        return [None] * len(leaves)
    with torch.enable_grad():
        outs = plain(*leaves, **kw)
    pairs = [(o, g) for o, g in zip(outs, cotangents)
             if g is not None and o.requires_grad]
    grads = (torch.autograd.grad([o for o, _ in pairs], wrt,
                                 [g for _, g in pairs], allow_unused=True)
             if pairs else [None] * len(wrt))
    found = dict(zip(map(id, wrt), grads))
    return [None if t is None or not t.requires_grad
            else (torch.zeros_like(t) if found[id(t)] is None
                  else found[id(t)]) for t in leaves]


def rwkv6_chunked_backward(r, k, v, w, u, state, dy, ds,
                           needs=(True,) * 6, chunk: int = 64) -> list:
    """The gradients of :func:`rwkv6_chunked` (``r, k, v, w, u, state``,
    ``None`` where ``needs`` is unset or the input is ``None``) against
    the cotangents ``dy`` of y and ``ds`` of the final state (``None``:
    zeros), in closed form chunk by chunk in float32, each returned in
    its input's dtype.  The plain version of the WKV6 backward kernel.

    With S_t the state after step t and G_t its adjoint (G_T = ds,
    G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ): dr_t = S_{t-1} dy_t +
    (u∘k_t)(v_t·dy_t), dk_t = G_t v_t + (u∘r_t)(v_t·dy_t), dv_t =
    G_tᵀ k_t + (r_t·(u∘k_t)) dy_t, du = Σ (r_t∘k_t)(v_t·dy_t), ds0 = G_0
    and dw_j = dlogw_j / w_j (0 where the clamp at 1e-30 cuts it), with
    dr′ and dk′ the parts of dr and dk without the bonus and e the last
    step of j's chunk: dlogw_j = rowsum(G_e∘S_e) + Σ_{j<t≤e} r_t∘dr′_t −
    Σ_{j≤s≤e} k_s∘dk′_s, from quantities each chunk already has.  The
    states at the chunk boundaries come from a walk forward over the
    chunks, the adjoints from a walk backward; within a chunk the decay
    from step s to step t is exp(lwp_t - lw_s) over a (c, c, K) cube,
    as the forward's."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    dev = r.device
    out_like = (r, k, v, w, u, state)
    if not any(n and t is not None for n, t in zip(needs, out_like)):
        return [None] * 6
    dyf = (torch.zeros((B, T, H, V), dtype=f32, device=dev) if dy is None
           else dy.to(f32))
    pad = (-T) % chunk
    rp, kp, vp, dyp = (F.pad(a.to(f32), (0, 0, 0, 0, 0, pad))
                       for a in (r, k, v, dyf))
    wp = F.pad(w.to(f32), (0, 0, 0, 0, 0, pad), value=1.0)
    n = (T + pad) // chunk
    # (n, B, H, c, K|V)
    rb, kb, vb, wb, dyb = (a.reshape(B, n, chunk, H, -1)
                           .permute(1, 0, 3, 2, 4)
                           for a in (rp, kp, vp, wp, dyp))
    uf = u.to(f32)
    logw = torch.log(torch.clamp(wb, min=1e-30))
    lw = torch.cumsum(logw, dim=3)
    lwp = lw - logw                       # sum over strictly earlier steps
    to_end = torch.exp(lw[:, :, :, -1:, :] - lw)   # exp(lw_e - lw_s)
    chunk_decay = torch.exp(lw[:, :, :, -1, :])[..., None]   # (n,B,H,K,1)
    s = (torch.zeros((B, H, K, V), dtype=f32, device=dev) if state is None
         else state.to(f32))
    starts = []                           # S before each chunk, then S_T
    for i in range(n):
        starts.append(s)
        s = chunk_decay[i] * s + torch.einsum(
            "bhck,bhcv->bhkv", kb[i] * to_end[i], vb[i])
    starts.append(s)
    g = (torch.zeros((B, H, K, V), dtype=f32, device=dev) if ds is None
         else ds.to(f32))
    ends = [g]                            # G after each chunk, then G_0
    for i in reversed(range(n)):
        g = chunk_decay[i] * g + torch.einsum(
            "bhck,bhcv->bhkv", rb[i] * torch.exp(lwp[i]), dyb[i])
        ends.append(g)
    ends.reverse()                        # G_0, then G after each chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev), -1)[None, None, :, :, None]
    dr, dk, dv, dw = [], [], [], []
    du = torch.zeros((H, K), dtype=f32, device=dev)
    for i in range(n):
        rc, kc, vc, dyc = rb[i], kb[i], vb[i], dyb[i]
        sa, ge = starts[i], ends[i + 1]
        # E[t, s] = exp(lwp_t - lw_s) for s < t, 0 elsewhere
        e = torch.exp(torch.where(
            tri, lwp[i][:, :, :, None, :] - lw[i][:, :, None, :, :], -1e30))
        d = torch.einsum("bhtv,bhsv->bhts", dyc, vc)          # dy_t · v_s
        att = torch.einsum("bhtk,bhtsk,bhsk->bhts", rc, e, kc)
        drp = torch.exp(lwp[i]) * torch.einsum("bhkv,bhtv->bhtk", sa, dyc) \
            + torch.einsum("bhts,bhtsk,bhsk->bhtk", d, e, kc)
        dkp = to_end[i] * torch.einsum("bhkv,bhsv->bhsk", ge, vc) \
            + torch.einsum("bhts,bhtsk,bhtk->bhsk", d, e, rc)
        dvp = torch.einsum("bhkv,bhsk->bhsv", ge, kc * to_end[i]) \
            + torch.einsum("bhts,bhtv->bhsv", att, dyc)
        cur = torch.diagonal(d, dim1=2, dim2=3)[..., None]    # v_t · dy_t
        dr.append(drp + uf[None, :, None, :] * kc * cur)
        dk.append(dkp + uf[None, :, None, :] * rc * cur)
        dv.append(dvp + (rc * uf[None, :, None, :] * kc).sum(-1, keepdim=True)
                  * dyc)
        du += (rc * kc * cur).sum(dim=(0, 2))
        x, z = rc * drp, kc * dkp
        x_after = torch.flip(torch.cumsum(torch.flip(x, [2]), 2), [2]) - x
        z_from = torch.flip(torch.cumsum(torch.flip(z, [2]), 2), [2])
        q = (ge * starts[i + 1]).sum(-1)[:, :, None, :]     # rowsum(G_e∘S_e)
        wc = wb[i]
        dw.append(torch.where(wc >= 1e-30, (q + x_after - z_from) / wc, 0.0))

    def seq(parts, like):
        full = torch.stack(parts).permute(1, 0, 3, 2, 4).reshape(
            B, n * chunk, H, -1)[:, :T]
        return full.to(like.dtype)

    grads = [seq(dr, r), seq(dk, k), seq(dv, v), seq(dw, w), du.to(u.dtype),
             None if state is None else ends[0].to(state.dtype)]
    return [gr if nd and t is not None else None
            for gr, nd, t in zip(grads, needs, out_like)]


def mamba2_ssd_chunked_backward(x, dt, A, Bm, Cm, D, state, dy, dh,
                                needs=(True,) * 7, chunk: int = 128) -> list:
    """The gradients of :func:`mamba2_ssd_chunked` (``x, dt, A, Bm, Cm,
    D, state``, ``None`` where ``needs`` is unset or the input is
    ``None``) against the cotangents ``dy`` of y and ``dh`` of the final
    state (``None``: zeros), in closed form chunk by chunk in float32,
    each returned in its input's dtype.  The plain version of the SSD
    backward kernel.

    Per chunk, with la = cumsum(A dt), L_ts = exp(la_t - la_s) for s <=
    t, w_s = exp(la_last - la_s) dt_s, h_in the state entering the chunk
    and G_out the adjoint of the state leaving it:
    dx_s = sum_t (C_t.B_s) L_ts dt_s dy_t + w_s G_out B_s + D dy_s,
    dB_s = dt_s sum_t L_ts (dy_t.x_s) C_t + w_s G_outᵀ x_s,
    dC_t = sum_s L_ts dt_s (dy_t.x_s) B_s + exp(la_t) h_inᵀ dy_t (both
    summed over the heads of B's and C's group), and the adjoint passed
    back, G_in = exp(la_last) G_out + sum_t exp(la_t) dy_t C_tᵀ (after
    the first chunk, the initial state's gradient).  With M_ts = (C_t.B_s)
    L_ts dt_s (dy_t.x_s) and u_s = w_s x_sᵀ G_out B_s, the gradient of
    la is dla_t = rowsum_t(M) - colsum_t(M) + exp(la_t) dy_t.(h_in C_t)
    - u_t, and at the chunk's last step also + exp(la_last)<G_out, h_in>
    + sum_s u_s; da_r = sum_{t>=r} dla_t (within the chunk), ddt_r =
    colsum_r(M) / dt_r + u_r / dt_r + A da_r (formed without the
    division), and dD = sum x.dy per head.  dA = sum dt da, regrouped with
    c_t the sum of dt from the chunk's start (la = A c): sum_{s<=t} M_ts
    (c_t - c_s) + sum_t q_t c_t + sum_s u_s (c_last - c_s) + c_last
    exp(la_last)<G_out, h_in>, q_t = exp(la_t) dy_t.(h_in C_t).  Each
    weight is a span of steps, small where its term is large; sum dt da
    weights dla by la itself, up to -100 over a 64-step chunk at strong
    decays, where dla's terms cancel, and came out 4-15 times further
    from a float64 reference.  Every exponent
    is a sum of A dt over a span of steps, so <= 0.  The states at the
    chunk boundaries come from a walk forward over the chunks, the
    adjoints from a walk backward; the padded tail (dt = 0, x = B = C =
    dy = 0) adds nothing."""
    B_, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f32 = torch.float32
    dev = x.device
    out_like = (x, dt, A, Bm, Cm, D, state)
    if not any(n and t is not None for n, t in zip(needs, out_like)):
        return [None] * 7
    dyf = (torch.zeros((B_, T, H, P), dtype=f32, device=dev) if dy is None
           else dy.to(f32))
    pad = (-T) % chunk
    n = (T + pad) // chunk

    def blocks(a):
        """(B, T, heads, width) -> (B, H, n, c, width), heads repeated to
        H and the tail padded with zeros."""
        a = F.pad(a.to(f32), (0, 0, 0, 0, 0, pad))
        if a.shape[2] != H:
            a = a.repeat_interleave(rep, dim=2)
        return a.reshape(B_, n, chunk, H, -1).permute(0, 3, 1, 2, 4)

    xf, dyb, bf, cf = blocks(x), blocks(dyf), blocks(Bm), blocks(Cm)
    dtf = blocks(dt[..., None])[..., 0]                    # (B,H,n,c)
    Af = A.to(f32)[None, :, None, None]
    la = torch.cumsum(Af * dtf, dim=3)
    la_last = la[..., -1:]
    to_end = torch.exp(la_last - la)                       # exp(la_last - la_s)
    from_start = torch.exp(la)                             # exp(la_t)
    w = to_end * dtf
    chunk_decay = torch.exp(la_last[..., 0])[..., None, None]   # (B,H,n,1,1)
    # the boundary states forward and the adjoints backward
    hloc = torch.einsum("bhjsp,bhjsn->bhjpn", xf * w[..., None], bf)
    gloc = torch.einsum("bhjtp,bhjtn->bhjpn", dyb * from_start[..., None], cf)
    h = (torch.zeros((B_, H, P, N), dtype=f32, device=dev) if state is None
         else state.to(f32))
    h_in = []
    for j in range(n):
        h_in.append(h)
        h = chunk_decay[:, :, j] * h + hloc[:, :, j]
    g = (torch.zeros((B_, H, P, N), dtype=f32, device=dev) if dh is None
         else dh.to(f32))
    g_out = [g] * n
    for j in reversed(range(n)):
        g_out[j] = g
        g = chunk_decay[:, :, j] * g + gloc[:, :, j]
    h_in, g_out = torch.stack(h_in, 2), torch.stack(g_out, 2)
    # within each chunk: L_ts dt_s on s <= t
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))
    L = torch.exp(torch.where(tri, la[..., :, None] - la[..., None, :],
                              -1e30))
    ld = L * dtf[..., None, :]
    cb = torch.einsum("bhjtn,bhjsn->bhjts", cf, bf)        # C_t . B_s
    dyx = torch.einsum("bhjtp,bhjsp->bhjts", dyb, xf)      # dy_t . x_s
    p1, p2 = cb * ld, dyx * ld
    gb = torch.einsum("bhjpn,bhjsn->bhjsp", g_out, bf)     # G_out B_s
    dx = torch.einsum("bhjts,bhjtp->bhjsp", p1, dyb) + w[..., None] * gb
    if D is not None:
        dx = dx + D.to(f32)[None, :, None, None, None] * dyb
    db = torch.einsum("bhjts,bhjtn->bhjsn", p2, cf) + w[..., None] * \
        torch.einsum("bhjsp,bhjpn->bhjsn", xf, g_out)
    hdy = torch.einsum("bhjtp,bhjpn->bhjtn", dyb, h_in)    # h_inᵀ dy_t
    dc = torch.einsum("bhjts,bhjsn->bhjtn", p2, bf) + \
        from_start[..., None] * hdy
    # the decays' gradient, local to each chunk
    s_mat = cb * L * dyx                                   # M_ts / dt_s
    m = s_mat * dtf[..., None, :]
    col = s_mat.sum(-2)
    v = to_end * (xf * gb).sum(-1)                         # u_s / dt_s
    u = dtf * v
    q = from_start * (hdy * cf).sum(-1)
    gh = torch.exp(la_last[..., 0]) * (g_out * h_in).sum((-2, -1))
    dla = m.sum(-1) - m.sum(-2) + q - u
    last = gh + u.sum(-1)
    dla = torch.cat([dla[..., :-1], dla[..., -1:] + last[..., None]], -1)
    da = torch.flip(torch.cumsum(torch.flip(dla, [-1]), -1), [-1])
    ddt = col + v + Af * da
    c = torch.cumsum(dtf, dim=3)                           # la = A c
    span = torch.where(tri, c[..., :, None] - c[..., None, :], 0.0)
    dA = ((m * span).sum((-2, -1)) + (q * c).sum(-1)
          + (u * (c[..., -1:] - c)).sum(-1) + c[..., -1] * gh).sum((0, 2))

    def seq(a):
        """(B, H, n, c, width) -> (B, T, H, width)."""
        return a.permute(0, 2, 3, 1, 4).reshape(B_, n * chunk, H, -1)[:, :T]

    def grouped(a):
        return seq(a).reshape(B_, T, G, rep, -1).sum(3)

    grads = [seq(dx).to(x.dtype), seq(ddt[..., None])[..., 0].to(dt.dtype),
             dA.to(A.dtype),
             grouped(db).to(Bm.dtype), grouped(dc).to(Cm.dtype),
             None if D is None else (xf * dyb).sum((0, 2, 3, 4)).to(D.dtype),
             None if state is None else g.to(state.dtype)]
    return [gr if nd and t is not None else None
            for gr, nd, t in zip(grads, needs, out_like)]
