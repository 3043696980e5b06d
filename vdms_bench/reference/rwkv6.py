"""Plain float32 forward of RWKV6 ("Finch"): embedding, LayerNorm, then
per layer a time mix and a channel mix, then LayerNorm and the head.

Time mix: ``xn = LN(x)``, ``dx = shift(xn) - xn`` (the previous
position, zero before the first); the data-dependent interpolation
``xn + dx * (mu_m + lora_m)`` with ``lora = tanh((xn + dx mu_base)
W1) W2_m`` for the five slots r, k, v, w, g; ``r, k, v = x_m W_m``,
``g = silu(x_g W_g)``; the decay ``w = exp(-exp(base + tanh(x_w D1)
D2))``; per head the WKV recurrence ``out_t = r_t (S + diag(u) k_tᵀ
v_t)``, ``S <- diag(w_t) S + k_tᵀ v_t``; the per-head GroupNorm (eps
64e-5), times ``g``, projected out.  Channel mix: ``relu(x_k C_k)²
C_v`` gated by ``sigmoid(x_r C_r)``, with its own shift mixing.

:func:`layout` gives the parameter tree as the program takes it."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.common import layer_norm, matmul

SLOTS = 5  # r, k, v, w, g
HEAD_NORM_EPS = 64e-5


def layout(cfg: dict) -> list:
    """``(path, shape, init)`` of every leaf: ``init`` is ``("normal",
    std)`` (a standard normal cut at 3, times ``std``), ``("ones",)``,
    ``("zeros",)`` or ``("values", v)`` (the last axis set to ``v``)."""
    d, L, f = cfg["d_model"], cfg["num_layers"], cfg["d_ff"]
    Lm, Dl, K = cfg["rwkv_mix_lora"], cfg["rwkv_decay_lora"], cfg["rwkv_head_dim"]
    H = d // K
    vp = int(math.ceil(cfg["vocab_size"] / cfg["vocab_pad_multiple"])
             * cfg["vocab_pad_multiple"])
    b = (L,)
    deep = L ** -0.5
    return [
        (("embed",), (vp, d), ("normal", 0.02)),
        (("final_norm",), (d,), ("ones",)),
        (("lm_head",), (d, vp), ("normal", 0.02)),
        (("ln0_s",), (d,), ("ones",)),
        (("ln0_b",), (d,), ("zeros",)),
        (("final_norm_b",), (d,), ("zeros",)),
        (("blocks", "ln1_s"), b + (d,), ("ones",)),
        (("blocks", "ln1_b"), b + (d,), ("zeros",)),
        (("blocks", "ln2_s"), b + (d,), ("ones",)),
        (("blocks", "ln2_b"), b + (d,), ("zeros",)),
        (("blocks", "mu_base"), b + (d,), ("normal", 0.1)),
        (("blocks", "mu"), b + (SLOTS, d), ("normal", 0.1)),
        (("blocks", "mix_w1"), b + (d, SLOTS * Lm), ("normal", d ** -0.5)),
        (("blocks", "mix_w2"), b + (SLOTS, Lm, d), ("normal", Lm ** -0.5)),
        (("blocks", "w_r"), b + (d, d), ("normal", d ** -0.5)),
        (("blocks", "w_k"), b + (d, d), ("normal", d ** -0.5)),
        (("blocks", "w_v"), b + (d, d), ("normal", d ** -0.5)),
        (("blocks", "w_g"), b + (d, d), ("normal", d ** -0.5)),
        (("blocks", "w_o"), b + (d, d), ("normal", d ** -0.5 * deep)),
        (("blocks", "decay_base"), b + (d,), ("values", [-4.0])),
        (("blocks", "decay_w1"), b + (d, Dl), ("normal", d ** -0.5)),
        (("blocks", "decay_w2"), b + (Dl, d), ("normal", Dl ** -0.5)),
        (("blocks", "u"), b + (H, K), ("normal", 0.1)),
        (("blocks", "gn_s"), b + (d,), ("ones",)),
        (("blocks", "gn_b"), b + (d,), ("zeros",)),
        (("blocks", "cmu_k"), b + (d,), ("normal", 0.1)),
        (("blocks", "cmu_r"), b + (d,), ("normal", 0.1)),
        (("blocks", "c_k"), b + (d, f), ("normal", d ** -0.5)),
        (("blocks", "c_v"), b + (f, d), ("normal", f ** -0.5 * deep)),
        (("blocks", "c_r"), b + (d, d), ("normal", d ** -0.5)),
    ]


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _layer(p, x, cfg, precision):
    B, S, d = x.shape
    K = cfg["rwkv_head_dim"]
    H = d // K
    Lm = cfg["rwkv_mix_lora"]
    eps = cfg["norm_eps"]

    def mm(a, w):
        return matmul(a, w, precision)

    xn = layer_norm(x, p["ln1_s"], p["ln1_b"], eps)
    dx = _shift(xn) - xn
    lora = torch.tanh(mm(xn + dx * p["mu_base"], p["mix_w1"]))
    lora = lora.reshape(B, S, SLOTS, Lm)
    xr, xk, xv, xw, xg = (xn + dx * (p["mu"][m] + mm(lora[:, :, m],
                                                     p["mix_w2"][m]))
                          for m in range(SLOTS))
    r = mm(xr, p["w_r"]).reshape(B, S, H, K)
    k = mm(xk, p["w_k"]).reshape(B, S, H, K)
    v = mm(xv, p["w_v"]).reshape(B, S, H, K)
    g = F.silu(mm(xg, p["w_g"]))
    w = torch.exp(-torch.exp(p["decay_base"]
                             + mm(torch.tanh(mm(xw, p["decay_w1"])),
                                  p["decay_w2"]))).reshape(B, S, H, K)
    u = p["u"]
    state = torch.zeros(B, H, K, K, device=x.device)
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append((r[:, t, :, :, None] * (state + u[:, :, None] * kv)
                     ).sum(2))
        state = w[:, t, :, :, None] * state + kv
    y = torch.stack(outs, dim=1)                          # (B, S, H, K)
    mu = y.mean(-1, keepdim=True)
    yc = y - mu
    y = yc * torch.rsqrt((yc * yc).mean(-1, keepdim=True) + HEAD_NORM_EPS)
    y = y.reshape(B, S, d) * p["gn_s"] + p["gn_b"]
    x = x + mm(y * g, p["w_o"])

    xn = layer_norm(x, p["ln2_s"], p["ln2_b"], eps)
    dx = _shift(xn) - xn
    kk = torch.square(F.relu(mm(xn + dx * p["cmu_k"], p["c_k"])))
    gate = torch.sigmoid(mm(xn + dx * p["cmu_r"], p["c_r"]))
    return x + gate * mm(kk, p["c_v"])


def forward(params: dict, tokens: torch.Tensor, cfg: dict,
            precision: str = "fp32") -> torch.Tensor:
    """Logits (B, S, vocab_size) of every position of ``tokens`` (B, S)."""
    V, eps = cfg["vocab_size"], cfg["norm_eps"]
    x = params["embed"][tokens.long()].to(torch.float32)
    x = layer_norm(x, params["ln0_s"], params["ln0_b"], eps)
    blocks = params["blocks"]
    for i in range(cfg["num_layers"]):
        x = _layer({k: v[i] for k, v in blocks.items()}, x, cfg, precision)
    x = layer_norm(x, params["final_norm"], params["final_norm_b"], eps)
    return matmul(x, params["lm_head"][:, :V], precision)


def products(cfg: dict, B: int, S: int, offset: int, head_rows: int) -> int:
    """Matrix-product operations of one pass of ``S`` new tokens in each
    of ``B`` rows after ``offset`` cached positions, logits taken at
    ``head_rows`` positions a row: 2 per weight a token multiplies and
    the WKV scans' products (:func:`harness.work.wkv_work`'s count;
    ``offset`` plays no part: the state is one size at any length)."""
    from harness.work import wkv_work
    d, L, f = cfg["d_model"], cfg["num_layers"], cfg["d_ff"]
    Lm, Dl, K = cfg["rwkv_mix_lora"], cfg["rwkv_decay_lora"], cfg["rwkv_head_dim"]
    layer = 6 * d * d + 2 * d * f + 2 * SLOTS * Lm * d + 2 * Dl * d
    dense = 2 * B * S * L * layer
    head = 2 * B * head_rows * d * cfg["vocab_size"]
    scans = L * wkv_work(B, S, d // K, K, K, 4)[1]
    return dense + head + scans
