"""Model-serve launcher: batched prefill + decode over an assigned arch.

  PYTHONPATH=src python -m repro_torch.launch.model_serve \\
      --arch zamba2-2.7b --full --requests 16 --prompt-len 512 --gen 16

This is the device-side half of the query engine's model-UDF path: the
engine's Thread_3 coalesces entities into request batches and this layer
runs prefill once + a decode loop with a cache updated in place.  It
runs on the CUDA card unless asked for the CPU (``--device cpu``).  The
mesh is the JAX package's host mesh over the ranks of the default
process group, (ranks / model_par, model_par) as (data, model), with
``model_par`` clamped to the ranks: on one rank ``model_par=2`` runs
unsharded.  Each rank holds the local shards of the parameters that
the default rules name (tensor parallelism over ``model``; the seeded
parameters are drawn on the card a leaf at a time and held whole in
host memory, so a rank's card holds its shards and one full leaf at
most), prefills and decodes the rows of the requests of its data
index, and the generated tokens are gathered in request order.  Started by
``torchrun``, the launcher initialises the process group from its
environment; a caller's group is left as it is.  Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.boundary import resolve_device
from repro_torch.distributed.sharding import Layout, ShardingCtx, local_rows
from repro_torch.launch.mesh import (make_host_mesh, process_group_from_env,
                                     rank)
from repro_torch.models import get_model
from repro_torch.models.lm import tree_leaves
from repro_torch.models.registry import (HostGenerator, token_start,
                                         vocab_split)
from repro_torch.serving.serve_step import make_serve_fns, sample_token


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch: str, *, reduced=True, requests=16, prompt_len=32, gen=16,
        model_par=1, temperature=0.0, device="cuda", params=None,
        layers=None) -> dict:
    """Prefill ``requests`` seeded prompts of ``prompt_len`` tokens (behind
    ``num_patches`` patch embeddings of 0.01 for a ``vit_stub`` model; with
    ``encoder_seq_len`` frames of 0.01 for an encoder-decoder) and decode
    ``gen`` tokens each.  ``params`` (full leaves on ``device``) replaces
    the port's seeded init; each rank keeps its shards of them.
    ``layers`` cuts the model to that many layers at its widths.  Times
    are host wall clock around work that ends in a device synchronise;
    the first call of a process includes its one-time set-up (kernel
    library load, cuBLAS handles).  ``logits`` are the prefill's
    last-position logits of every request over the whole vocabulary;
    ``cache_shapes`` and ``param_bytes`` are this rank's."""
    with process_group_from_env(device):
        dev = resolve_device(device)
        cfg = get_arch(arch, reduced=reduced)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        mesh = make_host_mesh(model=model_par)
        sh = ShardingCtx(mesh=mesh if mesh.size > 1 else None)
        model = get_model(cfg)
        if params is None:   # on more ranks, held on the host (HostGenerator)
            params = model.init((torch.Generator if mesh.size == 1
                                 else HostGenerator)(device=dev).manual_seed(0))
        params = Layout(sh, params, model.param_axes()).local(params, dev)

        rng = np.random.default_rng(0)
        tokens = rng.integers(1, cfg.vocab_size, (requests, prompt_len))
        batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(dev)}
        P = token_start(cfg)
        if P:
            batch["patch_embeds"] = torch.full((requests, P, cfg.d_model),
                                               0.01, device=dev)
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.full(
                (requests, cfg.encoder_seq_len, cfg.d_model), 0.01,
                device=dev)
        n = mesh.batch_extent
        split = n > 1 and requests % n == 0
        if split:   # this data index's block of the requests
            batch = local_rows(batch, n, sh.data_index)

        prefill_fn, serve_step = make_serve_fns(model, sh)
        vsplit = vocab_split(cfg, sh)
        max_cache = P + prompt_len + gen + 1
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, batch, max_cache)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        first = logits if vsplit is None else sh.gather(logits, -1)

        gen_rng = None
        if temperature > 0.0:
            gen_rng = torch.Generator(device=dev).manual_seed(0)
        tok = sample_token(logits, gen_rng, temperature, cfg.vocab_size,
                           vsplit)
        toks = []
        t1 = time.perf_counter()
        for i in range(gen):
            toks.append(tok)
            logits, cache = serve_step(params, tok, cache, P + prompt_len + i)
            tok = sample_token(logits, gen_rng, temperature, cfg.vocab_size,
                               vsplit)
        _sync(dev)
        t_decode = time.perf_counter() - t1
        out = torch.cat(toks, dim=1)
        if split:   # every data index's rows, in request order
            out = sh.gather(out, 0, axis="data")
            first = sh.gather(first, 0, axis="data")
        return {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tokens_per_s": requests * gen / max(t_decode, 1e-9),
            "generated": out.cpu().numpy(),
            "logits": first.float().cpu().numpy(),
            "cache_shapes": {k: tuple(v.shape) for k, v in cache.items()},
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)),
            "rank": rank(),
        }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced config)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    out = run(a.arch, reduced=not a.full, requests=a.requests,
              prompt_len=a.prompt_len, gen=a.gen, model_par=a.model_par,
              device=a.device)
    if out["rank"]:
        return
    print(f"[serve] {a.arch}: prefill {out['prefill_s']*1e3:.1f} ms, "
          f"decode {out['decode_s']*1e3:.1f} ms "
          f"({out['tokens_per_s']:.1f} tok/s)")


if __name__ == "__main__":
    main()
