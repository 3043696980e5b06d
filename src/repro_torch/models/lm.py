"""Unified decoder-only LM for the dense, vlm and moe (``tblock``),
``rwkv`` and hybrid (zamba2) families.  Parameters are nested dicts of
tensors laid out as the JAX package lays them out: per-layer leaves
stacked on a leading axis (``blocks`` (L, ...), dense and rwkv, a MoE's
experts (L, E, ...); ``mamba`` (n_app, group, ...); ``shared``
(num_shared_blocks, ...)), so ``repro_torch.interop.params_from_jax``
carries a JAX tree over leaf for leaf.  The JAX package's ``lax.scan``
over the stack becomes a Python loop over views of the stacked tensors,
and caches are preallocated stacked tensors written in place (the JAX
package threads them through the scan and donates them, which computes
the same thing).  ``max_seq`` sizes no rwkv cache: its state is O(1)
in the sequence length, as in the reference.

Under tensor parallelism each rank holds the local shards of the
parameters and of the cache that their specs name (a :class:`Cache`
remembers its global slot count, which a block of slots does not
show).  The embedding is a vocab-parallel lookup (each rank looks up
the ids in its rows, zero elsewhere, then one sum over the model
axis), the head gives this rank's block of the vocabulary, and the
residual stream stays replicated over the model axis between blocks.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models import blocks, common, rwkv6
from repro_torch.models.mamba2 import conv_dim


def family_kind(cfg: ArchConfig) -> str:
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.family == "ssm":
        return "rwkv"
    return "tblock"  # dense, vlm, moe


def hybrid_shape(cfg: ArchConfig) -> tuple[int, int]:
    group = cfg.shared_attn_every
    if group <= 0 or cfg.num_layers % group:
        raise ValueError(f"{cfg.name}: shared_attn_every={group} must divide "
                         f"num_layers={cfg.num_layers}")
    return cfg.num_layers // group, group


# ---------------------------------------------------------- tree helpers
def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_like(tree, leaves) -> dict:
    """``tree``'s structure with ``leaves`` in :func:`tree_leaves`'s
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def layer(tree, *index):
    """The per-layer view ``leaf[index]`` of every stacked leaf."""
    return tree_map(lambda a: a[index], tree)


def unstack(tree) -> list:
    """Every per-layer view of a stacked tree, taken at once with
    ``unbind(0)``: under autograd the backward of one ``unbind`` stacks
    the layers' gradients into one tensor, where indexing ``leaf[i]``
    per layer would build and add a full-size zero gradient per layer."""
    views = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    return [tree_like(tree, [v[i] for v in views])
            for i in range(len(views[0]))]


def run_body(body: Callable, remat: bool, *args):
    """``body(*args)``, under remat through
    ``torch.utils.checkpoint``: the body's activations are dropped after
    the forward and recomputed in the backward (the JAX package's
    ``jax.checkpoint`` around its scanned body)."""
    if not remat:
        return body(*args)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(body, *args, use_reentrant=False)


def stack_init(init_one: Callable, kg: common.KeyGen, n: int) -> dict:
    """``n`` layers of ``init_one(kg)`` stacked on a leading axis, drawn
    one layer after another and written into one preallocated tensor per
    leaf (no second copy of the stack is ever held)."""
    first = init_one(kg)
    out = tree_map(lambda a: a.new_empty((n, *a.shape)), first)
    for i in range(n):
        one = first if i == 0 else init_one(kg)
        for dst, src in zip(tree_leaves(out), tree_leaves(one)):
            dst[i].copy_(src)
    return out


# ======================================================================
# init
# ======================================================================
def init_lm(generator: torch.Generator, cfg: ArchConfig,
            dtype=torch.float32) -> dict:
    """Random parameters drawn from ``generator`` on its device."""
    kg = common.KeyGen(generator)
    kind = family_kind(cfg)
    dev = kg.device
    p: dict[str, Any] = {
        "embed": common.normal(kg(), (cfg.padded_vocab, cfg.d_model), dtype,
                               std=0.02),
        "final_norm": common.ones((cfg.d_model,), dtype, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = common.normal(kg(), (cfg.d_model, cfg.padded_vocab),
                                     dtype, std=0.02)
    if kind == "tblock":
        p["blocks"] = stack_init(
            lambda k: blocks.init_tblock(k, cfg, dtype, use_moe=cfg.is_moe),
            kg, cfg.num_layers)
    elif kind == "rwkv":
        p["ln0_s"] = common.ones((cfg.d_model,), dtype, dev)
        p["ln0_b"] = common.zeros((cfg.d_model,), dtype, dev)
        p["final_norm_b"] = common.zeros((cfg.d_model,), dtype, dev)
        p["blocks"] = stack_init(lambda k: rwkv6.init_rwkv6(k, cfg, dtype),
                                  kg, cfg.num_layers)
    else:  # hybrid (zamba2)
        n_app, group = hybrid_shape(cfg)
        mb = stack_init(lambda k: blocks.init_mblock(k, cfg, dtype),
                         kg, n_app * group)
        p["mamba"] = tree_map(
            lambda a: a.reshape(n_app, group, *a.shape[1:]), mb)
        p["shared"] = stack_init(lambda k: blocks.init_tblock(k, cfg, dtype),
                                  kg, cfg.num_shared_blocks)
    return p


def prepend_axis(tree, name="layers") -> dict:
    """``tree`` of logical-axis tuples with ``name`` ahead of each (a
    stacked leaf's leading axis)."""
    return tree_map(lambda axes: (name, *axes), tree)


def lm_axes(cfg: ArchConfig) -> dict:
    """The logical axes of every parameter, in the tree's layout (the
    sharding rules map them onto a mesh)."""
    kind = family_kind(cfg)
    ax: dict[str, Any] = {"embed": ("vocab", "embed"), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("embed", "vocab")
    if kind == "tblock":
        ax["blocks"] = prepend_axis(blocks.axes_tblock(cfg,
                                                       use_moe=cfg.is_moe))
    elif kind == "rwkv":
        ax["ln0_s"] = (None,)
        ax["ln0_b"] = (None,)
        ax["final_norm_b"] = (None,)
        ax["blocks"] = prepend_axis(rwkv6.axes_rwkv6(cfg))
    else:
        ax["mamba"] = prepend_axis(prepend_axis(blocks.axes_mblock(cfg)))
        ax["shared"] = prepend_axis(blocks.axes_tblock(cfg))
    return ax


# ======================================================================
# caches
# ======================================================================
class Cache(dict):
    """A cache tree and ``slots``, its global slot count (a rank's block
    of a cache split by slots holds ``slots / tp`` of them)."""

    def __init__(self, leaves: dict, slots: int):
        super().__init__(leaves)
        self.slots = slots


def local_cache(full: dict, axes: dict, sh: ShardingCtx, slots: int,
                device=None) -> "Cache":
    """The zero cache on ``device`` that this rank holds of the ``full``
    tree (a meta tree whose batch dim is already this rank's rows):
    each dim its spec splits over the model axis cut to its block."""
    from repro_torch.distributed.sharding import safe_spec

    def one(leaf, ax):
        spec = tuple(safe_spec(leaf.shape, ax, sh.rules, sh.mesh))
        shape = [n // sh.tp if e == "model" else n
                 for n, e in zip(leaf.shape, spec + (None,) * leaf.ndim)]
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    return Cache({k: one(v, axes[k]) for k, v in full.items()}, slots)


def cache_slots(cache) -> int | None:
    """A cache's global slot count; ``None`` for a plain dict (nothing is
    split: every leaf holds every slot)."""
    return getattr(cache, "slots", None)


def kv_layer(cache, i, slots):
    """Layer ``i``'s self-attention cache, with the global slot count
    when the cache knows it."""
    kv = {"k": cache["k"][i], "v": cache["v"][i]}
    if slots is not None:
        kv["slots"] = slots
    return kv


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, device=None,
               sh: ShardingCtx | None = None) -> dict:
    """The zero cache of ``batch`` rows and ``max_seq`` slots; under a
    model axis above one rank, this rank's shards of it."""
    if sh is not None and sh.tp > 1:
        full = init_cache(cfg, batch, max_seq, dtype, device="meta")
        return local_cache(full, cache_axes(cfg), sh, max_seq, device)
    kind = family_kind(cfg)
    hd = cfg.resolved_head_dim
    if kind == "tblock":
        kv = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, hd)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device)}
    if kind == "rwkv":
        L, H, K = cfg.num_layers, cfg.rwkv_nheads, cfg.rwkv_head_dim
        return {
            "tm_x": torch.zeros((L, batch, cfg.d_model), dtype=dtype,
                                device=device),
            "cm_x": torch.zeros((L, batch, cfg.d_model), dtype=dtype,
                                device=device),
            "wkv": torch.zeros((L, batch, H, K, K), dtype=torch.float32,
                               device=device),
        }
    n_app, group = hybrid_shape(cfg)
    H, P, N = cfg.mamba_nheads, cfg.mamba_head_dim, cfg.ssm_state
    kv = (n_app, batch, max_seq, cfg.num_kv_heads, hd)
    return {
        "conv": torch.zeros((n_app, group, batch, cfg.mamba_conv_width - 1,
                             conv_dim(cfg)), dtype=dtype, device=device),
        "ssm": torch.zeros((n_app, group, batch, H, P, N),
                           dtype=torch.float32, device=device),
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
    }


def cache_axes(cfg: ArchConfig) -> dict:
    """The logical axes of every leaf of :func:`init_cache`'s tree."""
    kind = family_kind(cfg)
    kv_ax = ("layers", "batch", "cache_seq", "cache_heads", None)
    if kind == "tblock":
        return {"k": kv_ax, "v": kv_ax}
    if kind == "rwkv":
        return {"tm_x": ("layers", "batch", "embed"),
                "cm_x": ("layers", "batch", "embed"),
                "wkv": ("layers", "batch", "ssm_heads", None, None)}
    return {
        "conv": ("layers", "layers", "batch", None, "ssm_inner"),
        "ssm": ("layers", "layers", "batch", "ssm_heads", None, None),
        "k": kv_ax, "v": kv_ax,
    }


# ======================================================================
# embedding / head
# ======================================================================
def vocab_lookup(table, tokens, cfg: ArchConfig, sh: ShardingCtx):
    """``table[tokens]``; a table split by vocabulary rows looks up the
    ids in this rank's rows, zero for the rest, and sums over the model
    axis."""
    ids = tokens.to(table.device)
    if not sh.split("vocab", cfg.padded_vocab):
        return table[ids]
    n = table.shape[0]
    local = ids.long() - sh.model_index * n
    mine = ((local >= 0) & (local < n))[..., None]
    return sh.reduce(torch.where(mine, table[local.clamp(0, n - 1)], 0.0))


def vocab_head(h, w, cfg: ArchConfig, sh: ShardingCtx):
    """``h @ w`` for a (d, V) head ``w``: this rank's block of the
    vocabulary when ``w``'s columns are split."""
    return common.col_parallel(h, w, sh, sh.split("vocab", cfg.padded_vocab))


def embed_tokens(p, tokens, cfg: ArchConfig, sh: ShardingCtx,
                 extra_embeds=None) -> torch.Tensor:
    """Token embeddings, with ``extra_embeds`` (B, P, d) — a vlm's patch
    embeddings — prepended before the positions are added."""
    h = vocab_lookup(p["embed"], tokens, cfg, sh)
    if cfg.scale_emb != 1.0:
        h = h * cfg.scale_emb
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    if cfg.pos_scheme == "sinusoidal":
        pos = common.sinusoidal_positions(
            torch.arange(h.shape[1], device=h.device), cfg.d_model, h.dtype)
        h = h + pos[None]
    return sh(h, "batch", "seq", "embed")


def _final_norm(p, h, cfg):
    if family_kind(cfg) == "rwkv":
        return common.layer_norm(h, p["final_norm"], p["final_norm_b"],
                                 cfg.norm_eps)
    return common.rms_norm(h, p["final_norm"], cfg.norm_eps)


def _ln0(p, h, cfg):
    """The rwkv family's LayerNorm right after the embedding."""
    return common.layer_norm(h, p["ln0_s"], p["ln0_b"], cfg.norm_eps)


def _rwkv_layers(params, h, cfg, sh, cache):
    """The rwkv stack over ``h``; with a ``cache`` each layer starts from
    its state there and writes its new state back in place."""
    for li in range(cfg.num_layers):
        st = None if cache is None else layer(cache, li)
        h, new = rwkv6.apply_rwkv6(layer(params["blocks"], li), h, cfg=cfg,
                                   sh=sh, cache=st)
        if cache is not None:
            for key, val in new.items():
                st[key].copy_(val)
    return h


def lm_head(p, h, cfg: ArchConfig, sh: ShardingCtx) -> torch.Tensor:
    """h (B,S,d) -> logits (B,S,Vp), or this rank's block of the
    vocabulary when the head is split; expects h already final-normed."""
    logits = vocab_head(h, p["embed"].T if cfg.tie_embeddings
                        else p["lm_head"], cfg, sh)
    if cfg.dim_model_base:
        logits = logits / (cfg.d_model / cfg.dim_model_base)
    return sh(logits, "batch", "seq", "vocab")


# ======================================================================
# forward (no cache)
# ======================================================================
def forward(params, tokens, cfg: ArchConfig, sh: ShardingCtx,
            *, extra_embeds=None,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,Vp), moe_aux summed over the layers).  With
    ``remat`` each scanned body of the reference (one layer; for the
    hybrid one group: the shared block and its Mamba2 blocks) is
    recomputed in the backward."""
    kind = family_kind(cfg)
    h = embed_tokens(params, tokens, cfg, sh, extra_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind == "tblock":
        def body(x, a, bp):
            x, _, la = blocks.apply_tblock(bp, x, cfg=cfg, sh=sh, causal=True,
                                           positions=positions,
                                           use_moe=cfg.is_moe)
            return x, a + la
        for bp in unstack(params["blocks"]):
            h, aux = run_body(body, remat, h, aux, bp)
    elif kind == "rwkv":
        def body(x, bp):
            return rwkv6.apply_rwkv6(bp, x, cfg=cfg, sh=sh)[0]
        h = _ln0(params, h, cfg)
        for bp in unstack(params["blocks"]):
            h = run_body(body, remat, h, bp)
    else:
        def body(x, sp, group):
            x, _, _ = blocks.apply_tblock(sp, x, cfg=cfg, sh=sh, causal=True,
                                          positions=positions)
            for mp in group:
                x, _, _ = blocks.apply_mblock(mp, x, cfg=cfg, sh=sh)
            return x
        shared = unstack(params["shared"])
        for g, group in enumerate(unstack(params["mamba"])):
            h = run_body(body, remat, h, shared[g % cfg.num_shared_blocks],
                         unstack(group))
    h = _final_norm(params, h, cfg)
    return lm_head(params, h, cfg, sh), aux


# ======================================================================
# prefill: forward + cache construction
# ======================================================================
def prefill(params, tokens, cfg: ArchConfig, sh: ShardingCtx, max_cache: int,
            *, extra_embeds=None, cache_dtype=None) -> tuple[torch.Tensor, dict]:
    """Returns (last-position logits (B,Vp), cache); ``extra_embeds``
    fill the first cache slots."""
    kind = family_kind(cfg)
    h = embed_tokens(params, tokens, cfg, sh, extra_embeds)
    B, S = h.shape[0], h.shape[1]
    cache_dtype = cache_dtype or h.dtype
    positions = torch.arange(S, device=h.device)
    if kind == "rwkv":
        # token-shift states in the activations' dtype, as in the reference
        cache = init_cache(cfg, B, max_cache, h.dtype, device=h.device, sh=sh)
        h = _rwkv_layers(params, _ln0(params, h, cfg), cfg, sh, cache)
        h_last = _final_norm(params, h[:, -1:], cfg)
        return lm_head(params, h_last, cfg, sh)[:, 0], cache
    cache = init_cache(cfg, B, max_cache, cache_dtype, device=h.device,
                       sh=sh)

    if kind == "tblock":
        for li in range(cfg.num_layers):
            kv = kv_layer(cache, li, max_cache)
            h, _, _ = blocks.apply_tblock(
                layer(params["blocks"], li), h, cfg=cfg, sh=sh, causal=True,
                positions=positions, use_moe=cfg.is_moe, kv_cache=kv,
                cache_index=0)
    else:
        # conv states stay in the activations' dtype, as in the JAX package
        cache["conv"] = cache["conv"].to(h.dtype)
        n_app, group = hybrid_shape(cfg)
        for g in range(n_app):
            sp = layer(params["shared"], g % cfg.num_shared_blocks)
            kv = kv_layer(cache, g, max_cache)
            h, _, _ = blocks.apply_tblock(sp, h, cfg=cfg, sh=sh, causal=True,
                                          positions=positions, kv_cache=kv,
                                          cache_index=0)
            for i in range(group):
                h, nc, ns = blocks.apply_mblock(
                    layer(params["mamba"], g, i), h, cfg=cfg, sh=sh,
                    conv_state=cache["conv"][g, i],
                    ssm_state=cache["ssm"][g, i])
                cache["conv"][g, i] = nc
                cache["ssm"][g, i] = ns

    h_last = _final_norm(params, h[:, -1:], cfg)
    logits = lm_head(params, h_last, cfg, sh)
    return logits[:, 0], cache


# ======================================================================
# decode: one token against the cache
# ======================================================================
def decode_step(params, tokens, cache, cache_index: int, cfg: ArchConfig,
                sh: ShardingCtx) -> tuple[torch.Tensor, dict]:
    """tokens (B,1) integer; cache_index the valid length so far.
    Returns (logits (B,Vp), the cache, updated in place)."""
    kind = family_kind(cfg)
    cache_index = int(cache_index)
    slots = cache_slots(cache)
    h = embed_tokens(params, tokens, cfg, sh)
    if cfg.pos_scheme == "sinusoidal":
        # embed_tokens added position 0; replace with cache_index position
        dev = h.device
        pos = common.sinusoidal_positions(
            torch.arange(1, device=dev) + cache_index, cfg.d_model, h.dtype)
        pos0 = common.sinusoidal_positions(torch.arange(1, device=dev),
                                           cfg.d_model, h.dtype)
        h = h + (pos - pos0)[None]
    positions = cache_index + torch.arange(1, device=h.device)

    if kind == "rwkv":
        h = _rwkv_layers(params, _ln0(params, h, cfg), cfg, sh, cache)
    elif kind == "tblock":
        for li in range(cfg.num_layers):
            kv = kv_layer(cache, li, slots)
            h, _, _ = blocks.apply_tblock(
                layer(params["blocks"], li), h, cfg=cfg, sh=sh, causal=True,
                positions=positions, use_moe=cfg.is_moe, kv_cache=kv,
                cache_index=cache_index)
    else:
        n_app, group = hybrid_shape(cfg)
        for g in range(n_app):
            sp = layer(params["shared"], g % cfg.num_shared_blocks)
            kv = kv_layer(cache, g, slots)
            h, _, _ = blocks.apply_tblock(sp, h, cfg=cfg, sh=sh, causal=True,
                                          positions=positions, kv_cache=kv,
                                          cache_index=cache_index)
            for i in range(group):
                h, nc, ns = blocks.apply_mblock(
                    layer(params["mamba"], g, i), h, cfg=cfg, sh=sh,
                    conv_state=cache["conv"][g, i],
                    ssm_state=cache["ssm"][g, i])
                cache["conv"][g, i] = nc
                cache["ssm"][g, i] = ns

    h = _final_norm(params, h, cfg)
    logits = lm_head(params, h, cfg, sh)
    return logits[:, 0], cache
