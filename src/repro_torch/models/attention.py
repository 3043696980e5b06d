"""Multi-head attention with GQA, qk-norm, QKV bias and rope (qwen3
qk_norm, qwen1.5/internvl2 bias, GQA, whisper cross-attention, zamba2
shared blocks).

Caches are preallocated ``(B, S_max, Hkv, D)`` tensors written in place
at ``cache_index`` (the JAX package's ``dynamic_update_slice`` into a
donated cache computes the same thing).  Attention longer than 1024
positions (queries or keys: whisper's cross-attention over 1,500
encoder frames takes it for a few decoder rows) takes the JAX package's
chunked route, ``flash_vjp``: the flash-attention kernel (K3) for CUDA
tensors, its plain translation on the CPU.

Under tensor parallelism (a ``model`` axis above one rank) the fused
``heads_fused`` / ``kv_fused`` projections are split contiguously, so a
rank holds whole heads wherever H and H_kv divide the axis: it projects
its heads (column-parallel), runs the attention (K3 on the card) on
them with the GQA ratio kept, and ``wo`` is row-parallel.  A split that
cuts a head is gathered first (no kernel ever sees part of a head): kv
heads are gathered and the ones the rank's query heads read are taken,
and query heads that do not divide make the attention run whole on
every rank, ``wo`` taking each rank's rows of its output.  The KV cache
follows its spec: split by heads (``cache_heads`` on ``model``), each
rank keeps its heads; split by slots (``cache_seq``, the default), each
rank keeps a block of slots for every head, prefill writes each rank's
slots and a decode step combines the ranks' partial softmaxes through
their maxima and sums (flash-decode); a slot count that does not divide
is replicated, every rank writing every slot.  On one rank (or with
no model axis) the plan holds every head and every collective is the
identity, so the same code is the single-device attention.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_vjp import flash_attention as flash_vjp
from repro_torch.models import common
from repro_torch.models.rope import apply_rope


def init_attention(kg: common.KeyGen, cfg: ArchConfig, dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qdim, kvdim = cfg.num_heads * hd, cfg.num_kv_heads * hd
    p = {
        "wq": common.normal(kg(), (d, qdim), dtype),
        "wk": common.normal(kg(), (d, kvdim), dtype),
        "wv": common.normal(kg(), (d, kvdim), dtype),
        "wo": common.normal(kg(), (qdim, d), dtype,
                            std=(qdim ** -0.5) / max(cfg.num_layers, 1) ** 0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = common.zeros((qdim,), dtype, kg.device)
        p["bk"] = common.zeros((kvdim,), dtype, kg.device)
        p["bv"] = common.zeros((kvdim,), dtype, kg.device)
    if cfg.qk_norm:
        p["q_norm"] = common.ones((hd,), dtype, kg.device)
        p["k_norm"] = common.ones((hd,), dtype, kg.device)
    return p


def axes_attention(cfg: ArchConfig) -> dict:
    ax = {
        "wq": ("embed", "heads_fused"),
        "wk": ("embed", "kv_fused"),
        "wv": ("embed", "kv_fused"),
        "wo": ("heads_fused", "embed"),
    }
    if cfg.qkv_bias:
        ax["bq"] = ("heads_fused",)
        ax["bk"] = ("kv_fused",)
        ax["bv"] = ("kv_fused",)
    if cfg.qk_norm:
        ax["q_norm"] = (None,)
        ax["k_norm"] = (None,)
    return ax


def _pick_impl(seq: int) -> str:
    # naive materializes (Sq,Sk) logits — fine for short seq, flash beyond
    return "naive" if seq <= 1024 else "chunked"


class _Plan:
    """Where this rank's heads come from under a model axis of ``tp``
    ranks (every head at ``tp`` 1).  ``q0, nq``: the query heads it
    attends (its own block when the split is head-aligned, else every
    head); ``kv_local``: its kv projection holds exactly the kv heads of
    its query block."""

    def __init__(self, cfg: ArchConfig, sh: ShardingCtx):
        self.hd = hd = cfg.resolved_head_dim
        self.H, self.Hkv = H, Hkv = cfg.num_heads, cfg.num_kv_heads
        tp, r = sh.tp, sh.model_index
        self.q_split = sh.split("heads_fused", H * hd)
        self.kv_split = sh.split("kv_fused", Hkv * hd)
        self.aligned = self.q_split and H % tp == 0
        self.q0, self.nq = (r * H // tp, H // tp) if self.aligned else (0, H)
        self.kv_local = self.aligned and self.kv_split and Hkv % tp == 0
        self.eps = cfg.norm_eps
        self.qk_norm, self.bias = cfg.qk_norm, cfg.qkv_bias

    def q(self, p, x, xc, sh):
        """(B, S, nq, hd) queries of this rank's heads."""
        B, S = x.shape[:2]
        q = common.dot(xc if self.q_split else x, p["wq"])
        if self.bias:
            q = q + p["bq"]
        if self.q_split and not self.aligned:
            q = sh.gather(q, -1)
        q = q.reshape(B, S, self.nq, self.hd)
        if self.qk_norm:
            w = sh.copy(p["q_norm"]) if self.aligned else p["q_norm"]
            q = common.rms_norm(q, w, self.eps)
        return q

    def kv(self, p, xk, xkc, sh):
        """Keys and values: this rank's kv heads when ``kv_local``, else
        every kv head (gathered when the split cuts heads)."""
        B, Sk = xk.shape[:2]
        src = xkc if self.kv_split else xk
        k, v = common.dot(src, p["wk"]), common.dot(src, p["wv"])
        if self.bias:
            k, v = k + p["bk"], v + p["bv"]
        if self.kv_split and not self.kv_local:
            k, v = sh.gather(k, -1), sh.gather(v, -1)
        n = self.Hkv // sh.tp if self.kv_local else self.Hkv
        k, v = k.reshape(B, Sk, n, self.hd), v.reshape(B, Sk, n, self.hd)
        if self.qk_norm:
            w = sh.copy(p["k_norm"]) if self.kv_local else p["k_norm"]
            k = common.rms_norm(k, w, self.eps)
        return k, v

    def for_queries(self, k, sh):
        """The kv heads (of all ``Hkv``) this rank's query heads read, in
        a GQA ratio the attention takes: a block of whole groups, the
        one group a block lies in, or one kv head per query head."""
        if self.nq == self.H:
            return k
        rep = self.H // self.Hkv
        k = sh.copy(k)
        if self.nq % rep == 0:
            return k[:, :, self.q0 // rep:(self.q0 + self.nq) // rep]
        if rep % self.nq == 0:
            return k[:, :, self.q0 // rep:self.q0 // rep + 1]
        idx = torch.arange(self.q0, self.q0 + self.nq, device=k.device) // rep
        return k.index_select(2, idx)

    def cache_heads(self, k, split: bool, sh):
        """``k`` as a cache split by heads (``split``) or holding every
        head keeps it."""
        if split:
            return k if self.kv_local else sh.axis("model").block(k, 2)
        return sh.gather(k, 2) if self.kv_local else k

    def out(self, p, o, sh):
        """The output projection of (B, S, nq * hd): row-parallel over
        this rank's heads, or over its rows of every head's output."""
        if self.aligned:
            return common.row_parallel(o, p["wo"], sh, True)
        if self.q_split:
            o = sh.axis("model").block(sh.copy(o), -1)
            return common.row_parallel(o, p["wo"], sh, True)
        return common.dot(o, p["wo"])


def _attend(q, k, v, causal, kv_len, q_offset, slots):
    """The single-device routes: the naive form up to 1024 ``slots`` (or
    positions), flash (K3 on the card) beyond."""
    if _pick_impl(slots) == "naive":
        return kref.naive_attention(q, k, v, causal=causal, kv_len=kv_len,
                                    q_offset=q_offset)
    return flash_vjp(q, k, v, q_offset, causal, None, 512, 1024)


def _decode_partial(q, kc, vc, valid):
    """One rank's share of a decode step over its slots: per query head
    the unnormalised output, the max logit and the sum of exponentials
    (float32), masked slots out."""
    B, Sq, H, D = q.shape
    Hkv = kc.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.to(torch.float32)) * D ** -0.5
    s = torch.where(valid, s, -1e30)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    o = torch.einsum("bhgqk,bkhd->bhgqd", e, vc.to(torch.float32))
    return o, m, e.sum(-1, keepdim=True)


def _flash_decode(q, kc, vc, cache_len, off, sh):
    """Decode attention over a cache split by slots: each rank's partial
    softmax over its block (global slots ``off`` on), combined through
    the maxima and the sums of exponentials."""
    B, Sq, H, D = q.shape
    valid = (off + torch.arange(kc.shape[1], device=q.device)) < cache_len
    o, m, l = _decode_partial(q, kc, vc, valid)
    mx = sh.gather(m, -1).amax(-1, keepdim=True)
    w = torch.exp(m - mx)
    o = sh.reduce(o * w) / sh.reduce(l * w)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def apply_attention(
    p: dict,
    x: torch.Tensor,                     # (B, S, d)
    *,
    cfg: ArchConfig,
    sh: ShardingCtx,
    positions: torch.Tensor | None = None,  # (S,) or (B,S)
    causal: bool = True,
    use_rope: bool = True,
    xk: torch.Tensor | None = None,      # cross-attention source
    kv_cache: dict | None = None,        # {"k": (B,Smax,Hkv,D), "v": ...}
    cache_index: int | None = None,      # write offset / valid length
) -> tuple[torch.Tensor, dict | None]:
    """Returns (output, kv_cache written in place, or None).

    Modes:
    - no cache: full (causal) attention over x, or over ``xk`` when it is
      given (cross-attention: no rope, no cache);
    - cache + S>=1: prefill-into-cache or single-token decode; new keys
      are written at ``cache_index`` and attention spans the first
      ``cache_index + S`` cache slots.
    """
    B, S, _ = x.shape
    plan = _Plan(cfg, sh)
    xc = sh.copy(x) if (plan.q_split or plan.kv_split) else x
    xk_src, xkc = (x, xc) if xk is None else (
        xk, sh.copy(xk) if plan.kv_split else xk)
    q = plan.q(p, x, xc, sh)
    k, v = plan.kv(p, xk_src, xkc, sh)
    if use_rope and cfg.pos_scheme == "rope" and xk is None:
        if positions is None:
            base = 0 if cache_index is None else cache_index
            positions = base + torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None or xk is not None:
        kq, vq = ((k, v) if plan.kv_local else
                  (plan.for_queries(k, sh), plan.for_queries(v, sh)))
        impl = _pick_impl(max(S, xk_src.shape[1]))
        if impl == "chunked":
            o = flash_vjp(q, kq, vq, 0, causal, None, 512, 1024)
        else:
            o = kops.flash_attention(q, kq, vq, causal=causal, impl=impl)
        return plan.out(p, o.reshape(B, S, -1), sh), None

    idx = 0 if cache_index is None else int(cache_index)
    kc, vc = kv_cache["k"], kv_cache["v"]
    slots = kv_cache.get("slots", kc.shape[1])
    if idx + S > slots:
        raise ValueError(f"cache of {slots} slots cannot take "
                         f"{S} positions at {idx}")
    if kc.shape[2] < plan.Hkv:
        # split by heads: this rank's kv heads, as on one device
        kc[:, idx:idx + S] = plan.cache_heads(k, True, sh).to(kc.dtype)
        vc[:, idx:idx + S] = plan.cache_heads(v, True, sh).to(vc.dtype)
        if S == 1:
            o = kops.decode_attention(q, kc, vc, idx + 1)
        else:
            o = _attend(q, kc, vc, causal, idx + S, idx, slots)
        return plan.out(p, o.reshape(B, S, -1), sh), kv_cache

    k_all = plan.cache_heads(k, False, sh)
    v_all = plan.cache_heads(v, False, sh)
    n = kc.shape[1]
    off = sh.model_index * n if n < slots else 0
    lo, hi = max(idx, off), min(idx + S, off + n)
    if lo < hi:
        kc[:, lo - off:hi - off] = k_all[:, lo - idx:hi - idx].to(kc.dtype)
        vc[:, lo - off:hi - off] = v_all[:, lo - idx:hi - idx].to(vc.dtype)
    if S == 1:
        qa = sh.gather(q, 2) if plan.nq < plan.H else q
        if n < slots:
            o = _flash_decode(qa, kc, vc, idx + 1, off, sh)
        else:
            o = kops.decode_attention(qa, kc, vc, idx + 1)
        o = o[:, :, plan.q0:plan.q0 + plan.nq]
    elif n < slots and idx == 0:
        # prefill into a cache split by slots: the new keys are the
        # whole prefix, attended on this rank's heads
        kq, vq = ((k, v) if plan.kv_local else
                  (plan.for_queries(k_all, sh), plan.for_queries(v_all, sh)))
        o = _attend(q, kq, vq, causal, None, 0, slots)
    else:
        kf = sh.gather(kc, 1) if n < slots else kc
        vf = sh.gather(vc, 1) if n < slots else vc
        if n < slots:
            kf[:, idx:idx + S] = k_all.to(kf.dtype)
            vf[:, idx:idx + S] = v_all.to(vf.dtype)
        o = _attend(q, plan.for_queries(kf, sh), plan.for_queries(vf, sh),
                    causal, idx + S, idx, slots)
    return plan.out(p, o.reshape(B, S, -1), sh), kv_cache


def apply_cross_attention_cached(
    p: dict,
    x: torch.Tensor,          # (B, S, d) decoder hidden
    cross_cache: dict,        # {"k": (B,Se,Hkv,D), "v": ...} from the encoder
    *,
    cfg: ArchConfig,
    sh: ShardingCtx,
) -> torch.Tensor:
    """Decode-time cross-attention: q from x, K/V from the prefill cache
    (every encoder slot valid), on the plain decode attention."""
    B, S, _ = x.shape
    plan = _Plan(cfg, sh)
    q = plan.q(p, x, sh.copy(x) if plan.q_split else x, sh)
    kc, vc = cross_cache["k"], cross_cache["v"]
    if kc.shape[2] == plan.Hkv:
        kc, vc = plan.for_queries(kc, sh), plan.for_queries(vc, sh)
    elif not plan.kv_local:
        raise ValueError("a cross cache split by heads needs the kv "
                         "projection split by whole heads")
    o = kops.decode_attention(q, kc, vc, kc.shape[1])
    return plan.out(p, o.reshape(B, S, -1), sh)


def make_cross_cache(p: dict, enc: torch.Tensor, cfg: ArchConfig,
                     sh: ShardingCtx) -> dict:
    """K/V of the encoder output for the decoder's cross-attention (the
    heads the cross cache's spec keeps on this rank)."""
    plan = _Plan(cfg, sh)
    k, v = plan.kv(p, enc, sh.copy(enc) if plan.kv_split else enc, sh)
    split = sh.split("cache_heads", cfg.num_kv_heads)
    return {"k": plan.cache_heads(k, split, sh),
            "v": plan.cache_heads(v, split, sh)}
