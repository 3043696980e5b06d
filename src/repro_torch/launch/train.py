"""End-to-end training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --device cpu --steps 20

It trains on the CUDA card unless asked for the CPU (``--device cpu``).
The mesh is the JAX package's: the production mesh, or the host mesh
over the ranks of the default process group, (ranks / model_par,
model_par) as (data, model), with ``model_par`` clamped to them (on one
rank ``model_par=2`` runs unsharded, as the reference runs it on one
device).  The rules are the defaults with the config's
``sharding_overrides``; each rank holds the local shards of the train
state that they name, trains data-parallel over ``data`` and
tensor-parallel over ``model``.  On more than one rank the seeded
parameters are drawn on the card one leaf at a time and held whole in
host memory (``registry.HostGenerator``), each rank's shards go to its
card and the moments are made there from them: a rank's card holds its
shards and one full leaf at most, its host the whole parameter tree.  Started by ``torchrun``, the launcher
initialises the process group from its environment (NCCL on the card,
gloo on the CPU); a caller's group is left as it is:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen3-0.6b --reduced --device cpu --steps 20

Every rank builds the same global batch and keeps its data index's
rows; only rank 0 prints, and a checkpoint is written by rank 0 as full
leaves gathered from every rank's shards.  Features: seeded init, the train step
with remat and sequential microbatches, WSD/cosine/linear/constant
schedules, a prefetching loader, periodic atomic checkpoints and
automatic restart from the latest one.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.boundary import resolve_device
from repro_torch.dataio import ShardedLoader, lm_token_stream
from repro_torch.distributed.fault import TrainSupervisor
from repro_torch.distributed.sharding import (Layout, ShardingCtx,
                                              default_rules)
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     process_group_from_env, rank)
from repro_torch.models import get_model
from repro_torch.models.registry import HostGenerator, param_shapes
from repro_torch.training import TrainConfig, make_train_step
from repro_torch.training.train_step import (init_train_state,
                                             train_state_axes)


def make_batch_fn(cfg, batch, seq):
    """``make(step)``: a seeded token batch of ``seq`` positions (behind
    ``num_patches`` patch embeddings of 0.01 for a vit_stub model; with
    ``encoder_seq_len`` frames of 0.01 for an encoder-decoder)."""
    P = cfg.num_patches if cfg.frontend == "vit_stub" else 0

    def make(step):
        b = {"tokens": lm_token_stream(batch, seq - P if P else seq,
                                       cfg.vocab_size, step)}
        if P:
            b["patch_embeds"] = (np.ones((batch, P, cfg.d_model), np.float32)
                                 * 0.01)
        if cfg.is_encoder_decoder:
            b["frames"] = np.ones((batch, cfg.encoder_seq_len, cfg.d_model),
                                  np.float32) * 0.01
        return b
    return make


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch: str, *, reduced=True, steps=100, batch=8, seq=128,
        lr=3e-3, ckpt_dir=None, save_every=50, mesh_kind="host",
        model_par=1, microbatches=1, compute_dtype="float32",
        log_every=10, schedule="wsd", device="cuda") -> dict:
    """Train ``steps`` steps (from the latest checkpoint under
    ``ckpt_dir``, if any).  Returns the losses and gradient norms, the
    step it started from, each step's wall time (host clock, to a
    device synchronise) and the total seconds."""
    with process_group_from_env(device):
        dev = resolve_device(device)
        cfg = get_arch(arch, reduced=reduced)
        mesh = (make_production_mesh() if mesh_kind == "production"
                else make_host_mesh(model=model_par))
        rules = dict(default_rules())
        if cfg.sharding_overrides:
            rules.update(cfg.sharding_overrides)
        sh = ShardingCtx(mesh=mesh if mesh.size > 1 else None, rules=rules)
        lead = rank() == 0
        model = get_model(cfg)
        tcfg = TrainConfig(learning_rate=lr, total_steps=steps,
                           warmup_steps=max(steps // 20, 5),
                           schedule=schedule, compute_dtype=compute_dtype,
                           microbatches=microbatches, remat=True)
        step_fn = make_train_step(model, tcfg, sh)

        # on more than one rank each leaf is drawn on the card, held on
        # the host, and this rank's shard of it goes back to the card
        gen = (torch.Generator if mesh.size == 1 else HostGenerator)(
            device=dev).manual_seed(0)
        shapes = param_shapes(model)
        cut = Layout(sh, shapes, model.param_axes())
        state = init_train_state(model, gen,
                                 place=lambda p: cut.local(p, dev))
        layout = Layout(sh, {"params": shapes, "m": shapes, "v": shapes,
                             "step": state["step"]}, train_state_axes(model))
        start = 0
        sup = None
        if ckpt_dir:
            sup = TrainSupervisor(ckpt_dir, save_every=save_every,
                                  layout=layout)
            state, start = sup.resume(state)
            if start and lead:
                print(f"[train] resumed from step {start}")

        loader = ShardedLoader(make_batch_fn(cfg, batch, seq),
                               start_step=start)
        losses, grad_norms, step_s = [], [], []
        t0 = time.time()
        try:
            for i, (_, np_batch) in zip(range(start, steps), loader):
                t_step = time.perf_counter()
                batch_t = {k: torch.from_numpy(v).to(dev)
                           for k, v in np_batch.items()}
                state, metrics = step_fn(state, batch_t)
                loss = float(metrics["loss"])
                _sync(dev)
                step_s.append(time.perf_counter() - t_step)
                losses.append(loss)
                grad_norms.append(float(metrics["grad_norm"]))
                if lead and ((i + 1) % log_every == 0 or i == start):
                    dt = time.time() - t0
                    print(f"[train] step {i+1}/{steps} loss={loss:.4f} "
                          f"lr={float(metrics['lr']):.2e} "
                          f"gnorm={float(metrics['grad_norm']):.2f} "
                          f"({dt:.1f}s)")
                if sup:
                    sup.maybe_save(i + 1, state)
        finally:
            loader.stop()
        return {"losses": losses,
                "final_loss": losses[-1] if losses else None,
                "grad_norms": grad_norms, "steps": len(losses),
                "start_step": start, "step_s": step_s,
                "seconds": time.time() - t0, "rank": rank()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=False)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--mesh", default="host", choices=["host", "production"])
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--schedule", default="wsd",
                    choices=["wsd", "cosine", "linear", "constant"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    out = run(a.arch, reduced=a.reduced, steps=a.steps, batch=a.batch,
              seq=a.seq, lr=a.lr, ckpt_dir=a.ckpt_dir, save_every=a.save_every,
              mesh_kind=a.mesh, model_par=a.model_par,
              microbatches=a.microbatches, compute_dtype=a.dtype,
              schedule=a.schedule, device=a.device)
    if out["rank"] == 0:
        print(f"[train] done: {out['steps']} steps, final loss "
              f"{out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
