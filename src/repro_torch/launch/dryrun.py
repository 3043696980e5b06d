"""Multi-pod dry run: the port's counterpart of the JAX package's
``launch/dryrun.py``.

For every (architecture x input-shape) cell, run rank 0's step (the
train step, prefill or one decode step) on ``meta`` tensors under a
``fake`` process group of the production mesh's 256 or 512 ranks, so
nothing is allocated and no data moves, and record under a
:class:`launch.costs.CostCounter`:

- the exact per-device input bytes (parameters or train state, the
  rank's rows of the batch, caches): rank 0's local shards themselves;
- the per-device FLOPs, HBM bytes and collective bytes, op by op (the
  reference's loop-corrected HLO counts), with each hand-written
  kernel's launches and work in ``kernel_breakdown``;
- the peak of the live bytes (the reference's ``memory_analysis()``);
- the roofline terms at the NVIDIA H100's rates, and which one bounds
  the cell.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod
  python -m repro_torch.launch.dryrun --all --mesh both

It initialises the ``fake`` group itself (once per mesh) when no group
is, and runs on any host: nothing touches a device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ALL_ARCHS, SHAPES, get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import (Layout, Mesh, ShardingCtx,
                                              default_rules, local_rows)
from repro_torch.kernels import work
from repro_torch.launch import costs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import get_model
from repro_torch.models.registry import param_shapes
from repro_torch.training import TrainConfig, make_train_step
from repro_torch.training.optimizer import init_moments


def microbatches(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh) -> int:
    """The reference's count: halve the rank's sequences a microbatch
    until the remat residual stack stays under 1.5e9 bytes."""
    per_dev_seqs = max(shape.global_batch // mesh.batch_extent, 1)
    stack_per_seq = shape.seq_len * cfg.d_model * 2 * max(cfg.num_layers, 1)
    mb = 1
    while (per_dev_seqs // mb) * stack_per_seq > 1.5e9 \
            and mb * 2 <= per_dev_seqs:
        mb *= 2
    return mb


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, *,
               dtype=torch.bfloat16, rules=None):
    """Returns ``(fn, args)``: the cell's step and rank 0's local
    ``meta`` arguments (its shards of the state or parameters and of
    the cache, its rows of the batch), under the default rules (or
    ``rules``) with the config's overrides and those of the shape's
    kind."""
    rules = dict(rules or default_rules())
    if cfg.sharding_overrides:
        rules.update(cfg.sharding_overrides)
    if shape.kind == "train" and cfg.train_sharding_overrides:
        rules.update(cfg.train_sharding_overrides)
    if shape.kind == "prefill" and cfg.prefill_sharding_overrides:
        rules.update(cfg.prefill_sharding_overrides)
    sh = ShardingCtx(mesh=mesh if mesh.size > 1 else None, rules=rules)
    model = get_model(cfg)
    n, index = (1, 0) if sh.mesh is None else (mesh.batch_extent,
                                               sh.data_index)

    if shape.kind == "train":
        tcfg = TrainConfig(compute_dtype="bfloat16", remat=True,
                           microbatches=microbatches(cfg, shape, mesh))
        step = make_train_step(model, tcfg, sh, local_batch=True)
        full = param_shapes(model, torch.float32)
        params = Layout(sh, full, model.param_axes()).local(full)
        m, v = init_moments(params)
        state = {"params": params, "m": m, "v": v,
                 "step": torch.zeros((), dtype=torch.int32, device="meta")}
        batch = local_rows(input_specs(cfg, shape, dtype), n, index)
        return step, (state, batch)

    full = param_shapes(model, dtype)
    params = Layout(sh, full, model.param_axes()).local(full)
    cache_dtype = getattr(torch, cfg.serve_cache_dtype)
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return model.prefill(params, batch, sh, max_cache=shape.seq_len,
                                 cache_dtype=cache_dtype)
        batch = local_rows(input_specs(cfg, shape, dtype), n, index)
        return prefill_fn, (params, batch)

    # decode: one token against a full cache (a meta index has no value:
    # the step writes the last slot)
    def serve_step(params, tokens, cache, cache_index):
        slot = shape.seq_len - 1 if cache_index.is_meta else cache_index
        return model.decode_step(params, tokens, cache, slot, sh)

    tokens = local_rows({"t": input_specs(cfg, shape, cache_dtype)["tokens"]},
                        n, index)["t"]
    cache = model.init_cache(tokens.shape[0], shape.seq_len, cache_dtype,
                             device="meta", sh=sh)
    idx = torch.empty((), dtype=torch.int32, device="meta")
    return serve_step, (params, tokens, cache, idx)


def mesh_name(mesh: Mesh) -> str:
    return "x".join(map(str, mesh.shape))


def run_cell(arch, shape_name, *, multi_pod: bool, mesh=None,
             verbose: bool = True, rules=None, dtype=torch.bfloat16) -> dict:
    """The cell's record (the reference's keys where their meaning
    carries over).  ``arch`` names an architecture or is an
    :class:`ArchConfig`, ``shape_name`` names a shape of ``SHAPES`` or
    is a :class:`ShapeConfig` (a cut of one); ``mesh`` defaults to the
    production mesh, which needs a process group of its ranks
    (:func:`fake_group`)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    ok, reason = cfg.supports_shape(shape)
    rec: dict = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": ("2x16x16" if multi_pod else "16x16") if mesh is None
        else mesh_name(mesh),
        "kind": shape.kind,
    }
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    t0 = time.time()
    try:
        mesh = mesh if mesh is not None else make_production_mesh(
            multi_pod=multi_pod)
        fn, args = build_cell(cfg, shape, mesh, dtype=dtype, rules=rules)
        input_bytes = costs.nbytes(args)
        counter = costs.CostCounter()
        counter.track(args)
        with counter:
            fn(*args)
        del fn, args
        run_s = time.time() - t0
        c = counter.summary()
        rec.update({
            "status": "ok",
            "chips": mesh.size,
            "run_s": round(run_s, 2),
            "flops_per_device": c["flops"],
            "hbm_bytes_per_device": c["hbm_bytes"],
            "collective_bytes_per_device": c["collective_bytes"],
            "collective_breakdown": c["collective_breakdown"],
            "kernel_breakdown": c["kernel_breakdown"],
            "input_bytes_per_device": input_bytes,
            "memory_analysis": {"peak_bytes": c["peak_bytes"]},
            "peak_bytes_per_device": c["peak_bytes"],
            "compute_term_s": c["flops"] / work.PEAK_FLOPS,
            "memory_term_s": c["hbm_bytes"] / work.HBM_BYTES_S,
            "collective_term_s": c["collective_bytes"] / work.NVLINK_BYTES_S,
        })
        terms = {"compute": rec["compute_term_s"],
                 "memory": rec["memory_term_s"],
                 "collective": rec["collective_term_s"]}
        rec["bottleneck"] = max(terms, key=terms.get)
        if verbose:
            print(f"[{rec['mesh']}] {cfg.name} x {shape.name}: OK "
                  f"run={run_s:.1f}s input={input_bytes / 2**30:.2f} GiB/dev "
                  f"peak={c['peak_bytes'] / 2**30:.2f} GiB/dev "
                  f"compute={rec['compute_term_s'] * 1e3:.2f}ms "
                  f"memory={rec['memory_term_s'] * 1e3:.2f}ms "
                  f"collective={rec['collective_term_s'] * 1e3:.2f}ms "
                  f"-> {rec['bottleneck']}-bound", flush=True)
    except Exception as e:   # a cell's failure is its record's
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{rec['mesh']}] {cfg.name} x {shape.name}: FAILED "
                  f"{rec['error']}", flush=True)
    return rec


@contextlib.contextmanager
def fake_group(world: int):
    """Within the block, a ``fake`` process group of ``world`` ranks with
    this process as rank 0 (collectives return at once and move
    nothing), when no group is initialised; a caller's group is left as
    it is."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (or --all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="one shape")
    ap.add_argument("--all", action="store_true", help="all archs x shapes")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args()

    if args.mesh == "both":
        meshes = [False, True]
    elif args.mesh == "multi" or args.multi_pod:
        meshes = [True]
    else:
        meshes = [False]
    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)

    os.makedirs(args.out, exist_ok=True)
    results = []
    t0 = time.time()
    for mp in meshes:
        with fake_group(512 if mp else 256):
            mesh = make_production_mesh(multi_pod=mp)
            for arch in archs:
                for shape in shapes:
                    rec = run_cell(arch, shape, multi_pod=mp, mesh=mesh)
                    results.append(rec)
                    tag = f"{arch}__{shape}__{rec['mesh'].replace('x', '_')}"
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(rec, f, indent=2)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped-by-design, {n_err} errors "
          f"of {len(results)} cells in {time.time() - t0:.1f} s")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
