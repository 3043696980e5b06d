"""Serving steps: prefill + single-token decode, plus a small generate
loop used by the query engine's model-UDF executor.  Caches are updated
in place (the JAX package donates them to its jitted step)."""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models.registry import ModelAPI, token_start


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
                 vocab_size: int | None = None) -> torch.Tensor:
    """logits (B, Vp) -> (B, 1) int32; temperature 0 = greedy (the first
    maximum, as ``jnp.argmax``).  Sampling draws from ``generator``,
    which must lie on the logits' device."""
    if vocab_size is not None and logits.shape[-1] > vocab_size:
        mask = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
        logits = torch.where(mask, logits, -1e30)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
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
    tok = sample_token(logits, generator, temperature, cfg.vocab_size)
    idx = prompt_len
    for _ in range(steps):
        out.append(tok)
        logits, cache = serve_step(params, tok, cache, idx)
        tok = sample_token(logits, generator, temperature, cfg.vocab_size)
        idx += 1
    return torch.cat(out, dim=1)
