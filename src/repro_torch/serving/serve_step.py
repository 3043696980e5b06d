"""Serving steps: prefill + single-token decode, plus a small generate
loop used by the query engine's model-UDF executor.  Caches are updated
in place (the JAX package donates them to its jitted step)."""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models.registry import ModelAPI, token_start, vocab_split


def make_serve_fns(model: ModelAPI, sh: ShardingCtx, cache_dtype=torch.float32):
    """Returns (prefill_fn, serve_step).

    prefill_fn(params, batch, max_cache) -> (last_logits (B,V), cache)
    serve_step(params, tokens (B,1), cache, cache_index) -> (logits, cache)
    """

    def prefill_fn(params, batch, max_cache: int):
        return model.prefill(params, batch, sh, max_cache, cache_dtype=cache_dtype)

    def serve_step(params, tokens, cache, cache_index):
        return model.decode_step(params, tokens, cache, cache_index, sh)

    return prefill_fn, serve_step


def sample_token(logits: torch.Tensor, generator: torch.Generator | None = None,
                 temperature: float = 0.0,
                 vocab_size: int | None = None,
                 sh: ShardingCtx | None = None) -> torch.Tensor:
    """logits (B, Vp) -> (B, 1) int32; temperature 0 = greedy (the first
    maximum, as ``jnp.argmax``).  Sampling draws from ``generator``,
    which must lie on the logits' device.  ``sh``, when given, is the
    context whose model axis splits the vocabulary: the logits are this
    rank's block, each rank's first maximum and its global index are
    gathered, and the first rank holding the largest wins (the global
    first maximum); a temperature draw gathers the logits first."""
    split = sh is not None and sh.tp > 1
    if split and temperature > 0.0:
        logits, split = sh.gather(logits, -1), False
    v0 = sh.model_index * logits.shape[-1] if split else 0
    if vocab_size is not None and v0 + logits.shape[-1] > vocab_size:
        ids = v0 + torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(ids < vocab_size, logits, -1e30)
    if temperature <= 0.0:
        idx = torch.argmax(logits, dim=-1, keepdim=True)
        if split:
            best = sh.gather(torch.gather(logits, -1, idx), -1)
            idx = torch.gather(sh.gather(idx + v0, -1), -1,
                               torch.argmax(best, dim=-1, keepdim=True))
        return idx.to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def greedy_generate(model: ModelAPI, params, batch: dict, *, steps: int,
                    sh: ShardingCtx, max_cache: int | None = None,
                    temperature: float = 0.0,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Prefill then decode ``steps`` tokens; returns (B, steps) int32."""
    cfg = model.cfg
    P = token_start(cfg)
    prompt_len = batch["tokens"].shape[1] + P
    max_cache = max_cache or (prompt_len + steps + 1)

    prefill_fn, serve_step = make_serve_fns(model, sh)
    logits, cache = prefill_fn(params, batch, max_cache)
    out = []
    split = vocab_split(cfg, sh)
    tok = sample_token(logits, generator, temperature, cfg.vocab_size, split)
    idx = prompt_len
    for _ in range(steps):
        out.append(tok)
        logits, cache = serve_step(params, tok, cache, idx)
        tok = sample_token(logits, generator, temperature, cfg.vocab_size,
                           split)
        idx += 1
    return torch.cat(out, dim=1)
