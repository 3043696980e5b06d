#!/usr/bin/env python3
"""Serving-path throughput benchmarks on the PyTorch port.

``python3 benchmarks/torch_serving_bench.py [--device cuda|cpu]
[--smoke|--full] [--check-baseline]`` from the root of a checkout.  The
port's counterpart of ``benchmarks/serving_bench.py``, with its
workloads, functions, row names and keys:

- ``run``: qwen3-0.6b decoding each request alone (``greedy_generate``)
  against grouped batching (``GroupBatcher``): 12 prompts of 16 tokens,
  8 generated, groups of 6.  The model is at full width (28 layers,
  d 1024) on the card and reduced on the CPU, as the reference's is;
  ``derived`` is batched tokens/s over sequential tokens/s.  The row
  also carries both token lists and whether they are equal;
- ``run_native_pool``: a native-op-heavy pipeline (resize 128 → blur 7
  → grayscale → blur 5 → threshold, two blur kernels an entity on the
  card) from concurrent sessions, one native worker (the paper's
  Thread_2) against the native pool; ``derived`` is the pool's
  throughput over one worker's, and the two responses must be equal.

The card is synchronised before each clock is read.  ``--check-baseline``
exits 2 unless the batched tokens equal the sequential ones and the
pool's responses equal one worker's.  The payload goes with the card's
name and power limit to ``chiprun_out/torch_serving.json``.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_common import (bench_args, entities_equal,  # noqa: E402
                                     finish, write_payload)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(n_requests=12, prompt_len=16, gen=8, group_size=6, *,
        device="cuda", reduced=None, params=None):
    """Per-request greedy decoding against the ``GroupBatcher`` on the
    same prompts.  ``params``: a tree on ``device``
    (``interop.params_from_jax``), else the port's seeded init."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.models import get_model
    from repro_torch.serving.batcher import GroupBatcher
    from repro_torch.serving.serve_step import greedy_generate

    dev = torch.device(device)
    reduced = dev.type == "cpu" if reduced is None else reduced
    cfg = get_arch("qwen3-0.6b", reduced=reduced)
    api = get_model(cfg)
    if params is None:
        params = api.init(torch.Generator(device=dev).manual_seed(0))
    sh = ShardingCtx(mesh=None)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len)
               for _ in range(n_requests)]

    def one(p):
        tokens = torch.tensor(np.asarray(p)[None], dtype=torch.int32,
                              device=dev)
        return greedy_generate(api, params, {"tokens": tokens}, steps=gen,
                               sh=sh)

    # warm both paths
    one(prompts[0])
    warm = GroupBatcher(api, params, group_size=group_size,
                        max_new_default=gen, sh=sh)
    warm.submit(prompts[0])
    warm.run_until_idle()
    _sync(dev)

    t0 = time.monotonic()
    seq = [one(p) for p in prompts]
    _sync(dev)
    t_seq = time.monotonic() - t0
    seq = [t[0].cpu().numpy().tolist() for t in seq]

    b = GroupBatcher(api, params, group_size=group_size,
                     max_new_default=gen, sh=sh)
    reqs = [b.submit(p) for p in prompts]
    t0 = time.monotonic()
    b.run_until_idle()
    _sync(dev)
    t_bat = time.monotonic() - t0
    batched = [np.asarray(r.result(timeout=5)).tolist() for r in reqs]
    assert all(len(t) == gen for t in batched)

    total_toks = n_requests * gen
    return [{
        "name": "serving_grouped_batching",
        "us_per_call": t_bat / total_toks * 1e6,
        "derived": t_seq / t_bat,
        "seq_tok_s": total_toks / t_seq,
        "batched_tok_s": total_toks / t_bat,
        "arch": cfg.name, "num_layers": cfg.num_layers,
        "d_model": cfg.d_model, "groups_run": b.groups_run,
        "tokens_identical": seq == batched,
        "seq_tokens": seq, "batched_tokens": batched,
    }]


# ------------------------------------------------------ native worker pool
NATIVE_HEAVY_PIPE = [
    {"type": "resize", "width": 128, "height": 128},
    {"type": "blur", "ksize": 7, "sigma_x": 2.0},
    {"type": "grayscale"},
    {"type": "blur", "ksize": 5, "sigma_x": 1.5},
    {"type": "threshold", "value": 0.4},
]


def _native_pool_wall(workers, n_images, size, sessions, device="cuda"):
    """Wall clock of ``sessions`` concurrent native-op-heavy queries, and
    the first session's response."""
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.remote import TransportModel
    from repro_torch.dataio.synthetic import synthetic_faces

    # fuse_native: each worker runs its native chain in one call
    eng = VDMSAsyncEngine(device=device, num_remote_servers=1,
                          transport=TransportModel(network_latency_s=0.001),
                          num_native_workers=workers, fuse_native=True)
    try:
        for i, img in enumerate(synthetic_faces(n_images, size=size,
                                                seed=3)):
            eng.add_entity("image", img, {"category": "np", "idx": i})
        q = [{"FindImage": {"constraints": {"category": ["==", "np"]},
                            "operations": NATIVE_HEAVY_PIPE}}]
        eng.execute(q, timeout=600)            # warm-up
        _sync(device)
        t0 = time.monotonic()
        futs = [eng.submit(q) for _ in range(sessions)]
        results = []
        for f in futs:
            r = f.result(timeout=600)
            assert r["stats"]["failed"] == 0
            results.append(r)
        _sync(device)
        return time.monotonic() - t0, results[0]["entities"]
    finally:
        eng.shutdown()


def run_native_pool(n_images=48, size=192, sessions=4, pool_workers=None, *,
                    device="cuda"):
    """One native worker (the paper's Thread_2) against the native pool
    (``min(cpu_count, 8)`` workers, at least 2)."""
    pool_workers = pool_workers or max(2, min(os.cpu_count() or 1, 8))
    t1, ents1 = _native_pool_wall(1, n_images, size, sessions, device)
    tn, entsn = _native_pool_wall(pool_workers, n_images, size, sessions,
                                  device)
    n_ops = n_images * sessions * len(NATIVE_HEAVY_PIPE)
    return [{
        "name": f"native_pool_{pool_workers}w_vs_1w",
        "us_per_call": tn / n_ops * 1e6,
        "derived": t1 / tn,
        "single_worker_s": t1,
        "pooled_s": tn,
        "pool_workers": pool_workers,
        "entities_per_s_pooled": n_images * sessions / tn,
        "responses_identical": entities_equal(ents1, entsn),
    }]


def gates(rows) -> list[str]:
    failures = []
    for r in rows:
        if r["name"] == "serving_grouped_batching" and \
                not r["tokens_identical"]:
            failures.append("batched tokens differ from sequential ones")
        if r["name"].startswith("native_pool") and \
                not r["responses_identical"]:
            failures.append("the native pool's responses differ from one "
                            "worker's")
    return failures


def run_suite(smoke=True, device="cuda", report=True):
    """``run`` and ``run_native_pool`` (24 images from 2 sessions in the
    smoke run, 48 from 4 in the full one); writes
    ``chiprun_out/torch_serving.json``."""
    rows = (run(device=device)
            + run_native_pool(n_images=24 if smoke else 48,
                              sessions=2 if smoke else 4, device=device))
    if report:
        write_payload("serving", {"smoke": smoke, "rows": rows}, device)
    return rows


def headline(rows) -> list[str]:
    sv, npool = rows
    return [
        f"{sv['name']} ({sv['arch']}, {sv['num_layers']} layers, d "
        f"{sv['d_model']}): sequential {sv['seq_tok_s']:.3f} tokens/s, "
        f"batched {sv['batched_tok_s']:.3f} ({sv['derived']:.3f}); tokens "
        f"identical {sv['tokens_identical']}",
        f"{npool['name']}: 1 worker {npool['single_worker_s']:.4f} s, pool "
        f"{npool['pooled_s']:.4f} s ({npool['derived']:.3f}); identical "
        f"{npool['responses_identical']}"]


def main(argv=None) -> int:
    args = bench_args(__doc__.splitlines()[0], argv)
    rows = run_suite(smoke=not args.full, device=args.device)
    return finish(rows, gates(rows), args, headline(rows))


if __name__ == "__main__":
    sys.exit(main())
