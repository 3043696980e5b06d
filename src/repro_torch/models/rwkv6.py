"""RWKV6 ("Finch") block: token-shift ddlerp mixing, data-dependent decay
(LoRA), WKV6 linear-attention scan, and squared-ReLU channel mix.

Under tensor parallelism ``w_r``, ``w_k``, ``w_v`` and ``w_g`` are split
by heads (column-parallel), so K5 runs on each rank's H/tp heads; the
token-shift mixing and its LoRAs run replicated, and the decay, ``u``
and the per-head group norm's weights, all replicated leaves, give the
rank's heads.  ``w_o`` is row-parallel, and so is the channel mix
(``c_k`` column-, ``c_v`` row-parallel).  ``c_r`` is split by its output
columns like the heads, but it gates the replicated output of ``c_v``:
the rank computes its columns and they are gathered over the model
axis (an activation of (B, S, d), against gathering the d x d weight).
The cache's ``wkv`` state is replicated by its spec (``ssm_heads`` is
not split): each rank scans from its heads of it, and the new state is
gathered.  Where ``d_model`` splits over the model axis but the heads
do not, the rank gathers the split leaves and computes every head, as
the reference's rules replicate the heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import REPLICATED, ShardingCtx
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import common

_MIX_SLOTS = 5  # r, k, v, w, g


def init_rwkv6(kg: common.KeyGen, cfg: ArchConfig, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    L = cfg.rwkv_mix_lora
    Dl = cfg.rwkv_decay_lora
    H, K = cfg.rwkv_nheads, cfg.rwkv_head_dim
    dev = kg.device
    f32 = torch.float32
    return {
        "ln1_s": common.ones((d,), dtype, dev),
        "ln1_b": common.zeros((d,), dtype, dev),
        "ln2_s": common.ones((d,), dtype, dev),
        "ln2_b": common.zeros((d,), dtype, dev),
        # time mix
        "mu_base": common.normal(kg(), (d,), dtype, std=0.1),
        "mu": common.normal(kg(), (_MIX_SLOTS, d), dtype, std=0.1),
        "mix_w1": common.normal(kg(), (d, _MIX_SLOTS * L), dtype),
        "mix_w2": common.normal(kg(), (_MIX_SLOTS, L, d), dtype,
                                std=L ** -0.5),
        "w_r": common.normal(kg(), (d, d), dtype),
        "w_k": common.normal(kg(), (d, d), dtype),
        "w_v": common.normal(kg(), (d, d), dtype),
        "w_g": common.normal(kg(), (d, d), dtype),
        "w_o": common.normal(kg(), (d, d), dtype,
                             std=(d ** -0.5) / max(cfg.num_layers, 1) ** 0.5),
        "decay_base": torch.full((d,), -4.0, dtype=f32, device=dev),
        "decay_w1": common.normal(kg(), (d, Dl), dtype),
        "decay_w2": common.normal(kg(), (Dl, d), dtype, std=Dl ** -0.5),
        "u": common.normal(kg(), (H, K), f32, std=0.1),
        "gn_s": common.ones((d,), dtype, dev),
        "gn_b": common.zeros((d,), dtype, dev),
        # channel mix
        "cmu_k": common.normal(kg(), (d,), dtype, std=0.1),
        "cmu_r": common.normal(kg(), (d,), dtype, std=0.1),
        "c_k": common.normal(kg(), (d, f), dtype),
        "c_v": common.normal(kg(), (f, d), dtype,
                             std=(f ** -0.5) / max(cfg.num_layers, 1) ** 0.5),
        "c_r": common.normal(kg(), (d, d), dtype),
    }


def axes_rwkv6(cfg: ArchConfig) -> dict:
    return {
        "ln1_s": (None,), "ln1_b": (None,), "ln2_s": (None,), "ln2_b": (None,),
        "mu_base": (None,), "mu": (None, None),
        "mix_w1": ("embed", None), "mix_w2": (None, None, "embed"),
        "w_r": ("embed", "heads_fused"), "w_k": ("embed", "heads_fused"),
        "w_v": ("embed", "heads_fused"), "w_g": ("embed", "heads_fused"),
        "w_o": ("heads_fused", "embed"),
        "decay_base": (None,), "decay_w1": ("embed", None),
        "decay_w2": (None, "embed"),
        "u": ("ssm_heads", None),
        "gn_s": (None,), "gn_b": (None,),
        "cmu_k": (None,), "cmu_r": (None,),
        "c_k": ("embed", "ff"), "c_v": ("ff", "embed"),
        "c_r": ("embed", "heads_fused"),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: x_{t-1}, with ``prev`` (B, d) as the t=-1 context."""
    B, S, d = x.shape
    lead = (torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
            if prev is None else prev[:, None].to(x.dtype))
    return torch.cat([lead, x[:, :-1]], dim=1) if S > 1 else lead


def apply_rwkv6(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    *,
    cfg: ArchConfig,
    sh: ShardingCtx,
    cache: dict | None = None,  # {"tm_x": (B,d), "cm_x": (B,d), "wkv": (B,H,K,V)}
) -> tuple[torch.Tensor, dict | None]:
    """Returns (x, the layer's new state or None).  A cached single-token
    step takes the plain sequential scan (as in the JAX package); every
    other call the chunked scan, which is the WKV6 kernel on the card."""
    B, S, d = x.shape
    H, K = cfg.rwkv_nheads, cfg.rwkv_head_dim
    caching = cache is not None
    tp = sh.tp
    split = sh.split("heads_fused", d)
    if split and H % tp:
        # the heads do not split: every rank computes all of them, from
        # the leaves its specs split gathered whole
        f = cfg.d_ff
        full = {"w_r": (d, d), "w_k": (d, d), "w_v": (d, d), "w_g": (d, d),
                "w_o": (d, d), "c_r": (d, d), "c_k": (d, f), "c_v": (f, d)}
        p = common.gather_whole(p, full, axes_rwkv6(cfg), sh)
        return apply_rwkv6(p, x, cfg=cfg, sh=REPLICATED, cache=cache)
    nh = H // tp if split else H
    h0 = sh.model_index * nh if split else 0
    mine = slice(h0 * K, (h0 + nh) * K)

    def local(t):
        """This rank's heads' channels of a replicated (..., d) value."""
        return sh.copy(t)[..., mine] if split else t

    # ---- time mix ------------------------------------------------------
    xn = common.layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
    prev = cache["tm_x"] if caching else None
    xx = _shift(xn, prev) - xn
    xxx = xn + xx * p["mu_base"]
    L = cfg.rwkv_mix_lora
    lora = torch.tanh(xxx @ p["mix_w1"]).reshape(B, S, _MIX_SLOTS, L)
    lora = torch.einsum("bsml,mld->mbsd", lora, p["mix_w2"])  # (5,B,S,d)
    mixed = xn[None] + xx[None] * (p["mu"][:, None, None] + lora)
    xr, xk, xv, xw, xg = mixed

    r = common.col_parallel(xr, p["w_r"], sh, split).reshape(B, S, nh, K)
    k = common.col_parallel(xk, p["w_k"], sh, split).reshape(B, S, nh, K)
    v = common.col_parallel(xv, p["w_v"], sh, split).reshape(B, S, nh, K)
    g = F.silu(common.col_parallel(xg, p["w_g"], sh, split))
    ww = p["decay_base"] + (torch.tanh(xw @ p["decay_w1"])
                            @ p["decay_w2"]).to(torch.float32)
    w = torch.exp(-torch.exp(local(ww))).reshape(B, S, nh, K)  # in (0,1)
    u = sh.copy(p["u"])[h0:h0 + nh] if split else p["u"]

    state0 = cache["wkv"][:, h0:h0 + nh] if caching else None
    if caching and S == 1:
        y, wkv_new = kref.rwkv6_scan_ref(r, k, v, w, u, state0)
    else:
        y, wkv_new = kops.rwkv6_scan(r, k, v, w, u, state0)
    y = y.reshape(B, S, nh * K)
    y = common.group_norm(y, local(p["gn_s"]), local(p["gn_b"]), nh,
                          eps=64e-5)
    y = sh(y * g, "batch", "seq", "act_heads")
    x = x + common.row_parallel(y, p["w_o"], sh, split)

    # ---- channel mix ----------------------------------------------------
    xn2 = common.layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
    prev2 = cache["cm_x"] if caching else None
    xx2 = _shift(xn2, prev2) - xn2
    ck_in = xn2 + xx2 * p["cmu_k"]
    cr_in = xn2 + xx2 * p["cmu_r"]
    ff = sh.split("ff", cfg.d_ff)
    kk = torch.square(F.relu(common.col_parallel(ck_in, p["c_k"], sh, ff)))
    kk = sh(kk, "batch", "seq", "act_ff")
    gate = common.col_parallel(cr_in, p["c_r"], sh, split)
    gate = sh.gather(gate, -1) if split else gate
    x = x + torch.sigmoid(gate) * common.row_parallel(kk, p["c_v"], sh, ff)

    new_cache = None
    if caching:
        new_cache = {"tm_x": xn[:, -1], "cm_x": xn2[:, -1],
                     "wkv": sh.gather(wkv_new, 1) if split else wkv_new}
    return x, new_cache
