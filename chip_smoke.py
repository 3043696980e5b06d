#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA
card: ``python3 chip_smoke.py`` from the root of a checkout.

Phases (any failed check exits non-zero, before the result line):

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and identify the card;
2. the bit-exact ``dispatch_static_hash`` workload (crop → remote flip →
   rotate → threshold over 8 seeded 32x32 images) on
   ``VDMSAsyncEngine(device="cuda")`` must hash to the recorded value;
3. the native path at LFW scale: 64 synthetic 250x250 faces through
   IQ3's blur and the C2 pipeline, checked against the plain versions on
   the host and an engine on the CPU;
4. the device backend: 256 faces through resize → crop → normalize →
   blur pinned onto the device (the fused preprocess kernel, then the
   blur kernel), against the same query run all-native on the card;
5. each kernel against its plain version on the card at the shapes of
   the main paths, with times, bounds (the longest of the bytes at the
   HBM rate, the matrix products at the tensor-core rate for their type
   and the other operations at the fp32 rate) and a library yardstick;
   K3's, K4's and K5's rows name their tensor-core route; besides the
   main shapes, K3 at zamba2's head dim 80 (float32 and bfloat16), K1 at
   one 64x64 image (C1's IQ3 in phase 10), at each shape and window
   phase 21's benches give it (``BENCH_BLURS``: ksize 7 among them) and
   on its general route (ksize 99, and ksize 5 over 64 channels), K2 at
   one image, at a 1080p lanczos3 downsample, at 8 channels and at
   phase 21's fused segment (8 x 72x72 → 48x48), and for the training
   path K3 in bfloat16 at minicpm-2b's head dim 64, K3 at qwen3-0.6b's
   training microbatch and at granite-8b's prefill (phase 14), and K3's
   forward + recomputing backward (``flash_vjp``'s Function: K3, then
   the backward kernel) at qwen3-0.6b's and minicpm-2b's training
   shapes, its output held against the plain forward and its gradients
   against autograd through the plain forward (and, with SDPA's, against
   float32 plain gradients), and the backward kernel alone at both
   shapes against its plain version ``flash_backward``;
6. the model path at the full width of zamba2-2.7b (54 layers,
   d_model 2560, seeded random weights): ``launch.model_serve.run`` over
   16 requests of 512 tokens + 16 generated; prefill + decode logits
   against the no-cache forward; the same past 1024 cache slots (2
   requests of 1,536 tokens + 16 generated, on the same weights), where
   every attention layer of a prefill or forward runs K3 at head dim 80;
   and one engine query over 16 images whose only op is a
   ``register_model_udf`` model UDF, through the per-entity, batcher and
   device-backend arms, which must stamp identical labels;
7. the same at the full width of rwkv6-1.6b (24 layers, d_model 2048):
   every prefill runs the WKV6 kernel K5;
8. the long-context path at the full width of qwen3-0.6b (28 layers,
   16 q heads and 8 kv heads of 128): ``model_serve.run`` over 4
   requests of 4096 tokens + 16 generated, and prefill + 4 decode steps
   of a 2048-token prompt against the no-cache forward; every layer of
   a prefill or forward beyond 1024 positions runs the flash-attention
   kernel K3;
9. the scale-out path: (a) the static-hash workload through a 1-shard
   ``ShardedEngine``, through a ``WireFrontend`` + ``WireClient`` on
   127.0.0.1 in front of an engine, and through the wire in front of the
   1-shard cluster, each hashing to the recorded value; (b) phase 4's
   device chain (256 faces, batch 32) through a 1-shard and a 4-shard
   cluster in process, every shard with its own device backend, and
   through the 4-shard cluster over the wire, against phase 4's
   response; (c) the same at ``replica_factor=2`` with ``kill_shard(1)``
   while the query is in flight (shard 1's first device group held 0.5 s
   by the fault injector; every entity answered, failovers > 0), then a
   query on the surviving shards;
10. the paper's baselines and curves (``benchmarks/torch_suite.py``):
   C1 (IQ1–IQ9 as remote ops, 32 64x64 faces) and C2 through the sync,
   pooled and async systems, whose responses must agree; C3 at 2, 4 and
   8 clients on the simulated transport; the shard curve at 1, 2 and 4
   shards and the kappa curve at 1–64 remote servers.  Times and
   speedups are printed, not gated;
11. the MoE path at the full width of granite-moe-1b-a400m (24 layers,
   d_model 1024, 32 experts top-8 of d_ff 512): ``model_serve.run``
   over 16 requests of 512 tokens + 16 generated at the published
   capacity factor 1.25, and the same past 1024 slots (2 x 1,536 + 16:
   K3 causal at head dim 64, GQA 16/8); the prefill/decode-vs-forward
   checks run on a copy of the config at capacity factor E/K = 4.0,
   where no token is dropped (at 1.25 the forward over S + n tokens
   drops other tokens than prefill + decode, so the two would compute
   different things);
12. the encoder-decoder path at the full width of whisper-small (12 +
   12 layers, d_model 768): ``model_serve.run`` over 16 requests of
   1,500 frames + 32 tokens + 16 generated (each prefill runs K3 not
   causal in every encoder layer, over 1,500 frames, and in every
   decoder layer's cross-attention, 32 rows against 1,500 keys); the
   forward check at (2, 16, 4) with seeded frames; the model UDF's
   batcher and device arms over 16 images (the JAX package's per-entity
   route builds no frames and raises ``KeyError('frames')``: checked
   to raise here too);
13. the vit_stub path at the full width of internvl2-1b (24 layers,
   d_model 896, 14 q and 2 kv heads of 64, 256 patches):
   ``model_serve.run`` over 4 requests of 256 patches + 1,024 tokens +
   16 generated (1,297 cache slots: K3 on every prefill layer), the
   forward check at (1, 1024, 4) with seeded patches, and the
   per-entity model UDF (the only route the JAX package registers for
   a vit_stub model) over 16 images, whose labels must equal those of
   ``greedy_generate`` called on the same prompts;
14. the dense path at the full width of granite-8b (36 layers, d_model
   4096, 32 q and 8 kv heads of 128; about 32 GB of float32 weights):
   ``model_serve.run`` over 2 requests of 1,536 tokens + 16 generated
   (1,553 cache slots: K3 on every prefill layer) and the forward check
   at (1, 1100, 4);
15. training (``launch.train`` and ``training.make_train_step``): (a)
   one step of qwen3-0.6b at full width cut to 2 layers, 1 x 1,536
   tokens in float32, on the card and on the host from one state (loss,
   gradient norm, each leaf of both moments, parameters); (b)
   qwen3-0.6b at full width, 4 x 4,096 tokens as 2 microbatches,
   float32: 3 steps straight, then 2 steps with a checkpoint at step 2
   and a run resuming from it, whose step-3 loss must equal the
   straight run's; (c) minicpm-2b at full width, 1 x 4,096 tokens,
   bfloat16 compute: 2 steps, the first loss against
   ``model.loss`` of the float32 parameters; (d) one step of minicpm-2b
   at full width cut to 2 layers, 1 x 4,096, at the bfloat16 defaults
   against the same step in float32 from one state (gradient norm, each
   leaf's first moment).  Every attention layer runs
   K3 forward and again when remat recomputes it, and the backward
   kernel once a step;
16. training the hybrid and rwkv families, K4 and K5 under their
   autograd Functions (the kernel forward, the recomputed chunked
   form's gradient backward): (a) one step of zamba2-2.7b at full width
   cut to 2 hybrid groups (12 layers), 1 x 1,536 tokens in float32, on
   the card and on the host from one state (loss, gradient norm, each
   leaf's largest |Δparam|), every leaf's gradient on the card finite
   and not all zero; (b) ``launch.train.run`` of zamba2-2.7b at full
   width, 1 x 4,096 tokens, float32: 2 steps (K4 in every Mamba2 layer,
   K3 at head dim 80 at every shared-attention application); (c)
   rwkv6-1.6b at full width, 4 x 4,096 tokens as 2 microbatches,
   bfloat16 compute: 2 steps (K5 in every layer); (d) rwkv6-1.6b cut to
   2 layers, one step at the bfloat16 defaults, every leaf's gradient
   finite and not all zero (those upstream of K5 named);
17. the distribution substrate on one card: ``make_host_mesh(model=2)``
   is 1 x 1, and ``model_serve.run`` and ``train.run`` of reduced
   qwen3-0.6b at ``model_par=2`` equal their ``model_par=1`` runs bit
   for bit; through a one-rank NCCL group, the int8 compressed mean,
   its reducer and error feedback against their numpy formulas, and
   ``remesh_tree`` of a train state onto the one-card mesh;
18. tensor and expert parallelism with two ranks sharing the card (two
   processes in a gloo group over a file store under ``build/``, CUDA
   tensors on the one card; NCCL takes no two ranks on one card), each
   run at ``model_par=2`` against the same run at ``model_par=1`` in
   the parent: ``model_serve.run`` of qwen3-0.6b and zamba2-2.7b (2 x
   1,536 tokens + 15 generated, 1,552 slots: the caches split by
   slots, decode combining the ranks' partial softmaxes) and of
   rwkv6-1.6b (4 x 512 + 4), granite-moe-1b-a400m's ``prefill`` under
   its prefill rules (the EP route: 16 experts a rank, 2 x 1,536 at
   capacity factor E/K), one ``train.run`` step of qwen3-0.6b (1 x
   2,048, float32) and zamba2's ``prefill`` under its
   ``sharding_overrides`` (1 x 1,536: the cache split by heads); at
   full depth.  Logits within ``LOGIT_TOL``, the greedy tokens equal,
   loss and gradient norm within 1e-5 and 1e-4 relative; each rank's
   K3, K4 and K5 launches, peak memory and parameter bytes (equal to
   what the reference's rules give, ``tp_runs``' ``param_bytes``), and
   the walls;
19. the dry run (``launch/dryrun.py``) against the card: (a) in a
   subprocess under ``fake`` process groups, the port's counterparts of
   the reference's production-mesh dry-run tests (whisper-small
   ``decode_32k`` on 16 x 16, rwkv6-1.6b ``decode_32k`` on 2 x 16 x 16);
   (b) qwen3-0.6b's train step at 2 x 4,096 (bf16 compute, K3 forward
   and remat's recompute) and rwkv6-1.6b's prefill at 4 x 4,096 (bf16,
   K5), each predicted by ``run_cell`` on meta tensors on a (1, 1) mesh,
   then run on the card from the port's seeded init: the launches of
   K3, K4 and K5 equal the prediction's, the input bytes equal it, the
   peak allocation is within 15% of its peak; the wall (median of 3
   warm calls) and the counted FLOPs' share of the bf16 peak printed;
20. the engine behaviours that the reference's own engine tests hold
   (after phase 10; ``device`` and ``device_backend`` on the card): (a) the
   ``admission_none_hash`` workload hashes to the recorded ``f9acbed1…``
   and an ``admission="queue"`` engine returns identical arrays; (b)
   phase 3's 64 faces through crop/rotate/flip/threshold under
   ``dispatch="cost"`` (flip placed remote) byte-identical to static;
   (c) phase 4's chain over the 64 faces fused and per op, each within
   ``PIPE_TOL`` of the CPU engine, K2 launched only by the fused run and
   K1 by both; (d) a server killed after the first result of a remote
   pipeline (failed 0, the fault-free response's hash) and the
   reference's seeded fault storm at its first seed (failed 0, retries,
   every response the fault-free one's); (e) 8 sessions from threads,
   4 cancelled mid-pipeline: no thread, admission slot or queued work
   left, and ``torch.cuda.memory_allocated()`` back within one 2 MiB
   allocator block of its level before the phase (read as PyTorch's
   CUDA leak check reads it: after a collection, without the cuBLAS
   workspaces PyTorch keeps for each thread that ran a matmul);
21. the reference's benches on the port (``benchmarks/torch_*.py``, run
   last), each with its ``--check-baseline`` gates, any failed gate
   failing the script: dispatch (the three placement modes identical
   with qwen3-0.6b's model UDF at full width, the device and fused arms
   close, ``778564da…``), admission (``f9acbed1…``, in flight bounded,
   shed p99 within 3× of uncontended), resilience (completion 1.0, no
   leak, peak ≤ cap, p99 factor ≤ 25), the hot path (cache and
   coalescing responses identical to their baselines), the front end
   (the wire hash, ``retry_after_s`` positive and finite, the cache
   served while saturated), serving (batched tokens equal to sequential
   ones at full width, the native pool's responses equal to one
   worker's) and the video suite (C1–C3 and cputrace at ``run.py
   --full``'s sizes, C1 and C2 over 4 clips of 16 240x320 frames: every
   system within 1e-5 of the async engine); each bench's headline
   numbers printed beside the card's name and power limit, its payload
   in ``chiprun_out/torch_<bench>.json``;
22. the examples and the roofline suite (after 21): (a) the four
   ``examples/torch_*.py`` through their ``main`` on the card at their
   own sizes — the quickstart's Fig 8 query over 64 faces (0 failed, the
   thresholded output binary), serve_visual_queries with qwen3-0.6b at
   full width (0 failed, every clip stamped, the warm wave's 24 full
   cache hits), train_lm ``--full-100m`` (10 steps at 8 x 128 with a
   checkpoint every 5 into a temporary directory, then a rerun resuming
   from step 10; finite losses) and scaleout_bench at kappa 1 and 4 (64
   images, 4 clients; every query completes); (b) the roofline suite
   (``benchmarks/torch_{roofline,report}.py``) over phase 19a's records
   (each row's counted terms equal to its record's), and each 19b cell's
   analytic terms beside its counted terms and the card's median wall,
   printed with no limit.

Phase 5 also holds K4's and K5's Functions (forward + backward) at the
training shapes of phase 16 against autograd through the plain chunked
forward on the card, and K3 forward + backward at zamba2's shared
attention, with times and bounds.

Launch counts are zeroed just before phase 2 and read just after
phase 4 (the engine's image path: K1 and K2 must have launched), and
zeroed again just before each of phases 6, 7, 8, 11, 12, 13, 14, 15,
16, 9, 10, 20, 21 and 22 (run in that order, phases 17 and 18 after 16)
and read just after it (phase 6 must have launched K4, and K3 past 1024
slots; phase 7 K5; phases 8 and 11–15 K3; phase 16 K3, K4 and K5;
phases 9, 20 and 21 K1 and K2; phase 10 K1; phase 22 none: no kernel
lies on the examples' paths or the roofline's arithmetic, and what it
launches is reported).  Phase 18's ranks zero
their own counts before each run and read them after it (each run's
kernels must have launched on each rank); the parent's ``model_par=1``
runs, the comparison, count in none.  Phase 19 (after 18) zeroes the counts just before each of
its card steps and reads them just after (its train step must launch
K3, its prefill K5).  K1's and K2's launches in the kernels line are
the sum over phases 2–4, 9, 10, 20, 21 and 22, K3's over phases 6–8,
11–16, 18, 19 and 22, K4's over phases 6, 16, 18 and 22, K5's over
phases 7, 16, 18, 19 and 22.
Phase 5's launches, which only compare kernels with their plain
versions, count in none.  Phases 9, 10, 21 and 22a run under ``HeldCalls``:
every K1 and K2 launch there goes through it, and the first call at
each shape and window is held against the plain version (K1 bit for
bit, K2 within ``K2_TOL``) after the phase, on its own input.  The
last lines are the card's name and power limit, one ``{"kernels":
[...]}`` line, and ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --ab DIR [KERNEL ...]`` instead holds the named
kernels (by default every kernel whose sources in DIR differ from the
checkout's) built from an earlier commit's sources in DIR, and the
checkout's, against their plain versions and times them in turns in one
process (old, new, new, old), and prints ``{"ab": [...]}``: put the
parent's ``csrc`` files in a git-ignored directory, for example with
``git archive``.  A case the old build refuses is recorded as refused
and timed on the new build alone.
"""
from __future__ import annotations

import functools
import gc
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STATIC_SHA256 = "778564da3d5f5530f0f4761d6af9f4c901796a91ff38620f2b75dd8cfa03a1b0"

# the card's rates and the kernels' work formulas: one copy, which the
# kernels' meta routes and the dry run read too
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.kernels.work import (  # noqa: E402
    FP32_FLOP_S, HBM_BYTES_S, PEAK_FLOPS, PRODUCT_FLOP_S, attn_bwd_work,
    attn_grad_work, attn_work,
    ssd_bwd_work, ssd_grad_work, ssd_work, visible_pairs, wkv_bwd_work,
    wkv_grad_work, wkv_work)

# the blur kernel equals its plain version bit for bit (same taps, same
# order, products and sums rounded separately)
K2_TOL = 1e-4       # fused preprocess vs composed ops, absolute
PIPE_TOL = 1e-4     # whole-pipeline comparisons, absolute
NATIVE_TOL = 1e-5   # native blur on the card vs plain on the host
# SSD kernel vs plain, float32, absolute: chunk sums of up to 128
# products in another order than cuBLAS, on outputs up to about 10
K4_TOL = 5e-4
# ... in bfloat16: the same, plus one bfloat16 rounding step of the output
K4_BF16_ATOL, K4_BF16_RTOL = 5e-2, 2.0 ** -7
# full-width prefill + decode logits vs the no-cache forward, absolute:
# the JAX package's 3e-4 at reduced width, widened for 54 layers of
# float32 products of length up to 10240 summed in other orders
MODEL_TOL = 1e-3
LOGIT_TOL = 3e-4     # tests/test_torch_models.py's: model_par=2 vs 1
TP_LOSS_RTOL, TP_NORM_RTOL = 1e-5, 1e-4
# WKV6 kernel vs plain, float32, absolute: sums over 64 steps of decayed
# products in another order, on outputs up to about 10
K5_TOL = 5e-4
# ... in bfloat16: one bfloat16 rounding step of the output, plus 5e-2
K5_BF16_ATOL, K5_BF16_RTOL = 5e-2, 2.0 ** -7
# flash-attention kernel vs plain: float32 2e-5 (the JAX package's flash
# tolerance, tests/test_kernels.py), on softmax averages of N(0,1) values;
# its log-sum-exp 1e-4 on values up to about 10; in bfloat16 both compute
# in float32 from the same inputs and round the output once, so they may
# land one bfloat16 step apart: 2^-7 relative plus 5e-3 absolute, a
# sixth of a typical output (about 0.03 for a row over 4096 keys)
K3_TOL, K3_LSE_TOL = 2e-5, 1e-4
K3_BF16_ATOL, K3_BF16_RTOL = 5e-3, 2.0 ** -7
# flash attention's recomputing backward over K3's output and
# log-sum-exp, against autograd through the plain forward: float32
# 2e-4 (the JAX package's tolerance for its flash gradients,
# tests/test_kernels.py) plus 1e-4 relative (a log-sum-exp within
# K3_LSE_TOL scales a row's probabilities by up to 1e-4); bfloat16
# 2e-2 absolute and relative (its bfloat16 flash tolerance: both round
# the output, whose rounding enters delta = rowsum(dO·O), and the grads)
K3_GRAD_TOL, K3_GRAD_RTOL = 2e-4, 1e-4
K3_GRAD_BF16_TOL = 2e-2
# the float32 route of the backward kernel, as the kernels line names it
K3_BWD_F32_ROUTE = ("wgmma 3xTF32: a pre-pass writing TF32-split images, "
                    "two consumer warpgroups taking the walk's tiles in "
                    "turn, each fed by TMA bulk copies from its own "
                    "producer")
# the SSD and WKV6 Functions' gradients (the kernel forward, the
# backward kernel: SSD's closed-form gradient on the tensor cores in
# 3xTF32, WKV6's summed in float32) and the backward kernels alone,
# against autograd through the plain chunked forward on the same
# tensors: 1e-5 of each
# gradient's largest magnitude; a bfloat16 input's gradient is rounded to
# bfloat16 once in both, one bfloat16 step apart at most (2^-7 relative
# beyond that)
SCAN_GRAD_TOL, SCAN_GRAD_BF16_RTOL = 1e-5, 2.0 ** -7
# a training step on the card against the same step on the host, and a
# resumed step against the straight run's: float32 sums in other orders
# (loss 1e-5 relative; the gradient norm 1e-4, summed over every
# gradient, K3's 3xTF32 products of about 22 bits among them); a
# bfloat16-compute step's loss against the float32 model's, 2e-2
# relative (bfloat16 rounds every activation to 8 bits of mantissa)
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1e-5, 1e-4
TRAIN_BF16_LOSS_RTOL = 2e-2
# the card's step against the host's, each moment leaf's largest
# difference over that leaf's largest magnitude: m 5e-5, v 1e-4.  Every
# leaf differs by about the same 5e-6 relative (the clip scale from the
# two float32 norms, and p = exp(logit - lse) whose float32 lse over
# 151,936 logits scales a row's probabilities); v = g^2 twice that.
# Measured on an H100: m 1.14e-5, v 2.29e-5 (full width, 2 layers)
TRAIN_MOMENT_TOL = {"m": 5e-5, "v": 1e-4}
# a bfloat16-compute step (bfloat16 gradient rounding) against the same
# step in float32, minicpm-2b at full width cut to 2 layers: the
# gradient norm 5e-2 relative (measured 2.05e-2 on an H100); each
# block and norm leaf's first moment 1e-1 in relative L2 (measured
# 0.022-0.029), the tied embedding's 0.5 (measured 0.186: the rows of
# the head no label picks get sums of 4,096 terms of about 1/V whose
# bfloat16 logit noise does not cancel)
TRAIN_BF16_NORM_RTOL, TRAIN_BF16_M_RTOL, TRAIN_BF16_EMBED_M_RTOL = \
    5e-2, 1e-1, 5e-1
# the RWKV6 decay with log w about -8 a step: ww = log(8) + N(0, 1)
STRONG_DECAY_SHIFT = math.log(8.0) + 4.0

ARCH = "zamba2-2.7b"
# the hand-written kernels on the model and training paths
MODEL_KERNELS = ("mamba2_ssd", "mamba2_ssd_backward", "rwkv6_scan",
                 "rwkv6_scan_backward", "flash_attention",
                 "flash_attention_backward")
RWKV_ARCH = "rwkv6-1.6b"
LONG_ARCH = "qwen3-0.6b"
MOE_ARCH = "granite-moe-1b-a400m"
ENCDEC_ARCH = "whisper-small"
VLM_ARCH = "internvl2-1b"
DENSE_ARCH = "granite-8b"
TRAIN_BF16_ARCH = "minicpm-2b"
MODEL_UDF = "lm"

# a few ms of device sleep ahead of each timed call (outlasts the host
# time to enqueue the slowest timed function, the plain blur)
SLEEP_CYCLES = 5_000_000


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


IQ3_BLUR = [{"type": "blur", "ksize": 5, "sigma_x": 1.5}]
C2_PIPE = [  # benchmarks/common.py::image_c2_pipeline
    {"type": "resize", "width": 48, "height": 48},
    {"type": "remote", "url": "u", "options": {"id": "facedetect_box"}},
    {"type": "remote", "url": "u", "options": {"id": "manipulation"}},
    {"type": "rotate", "k": 1},
]


def fill(eng, n, size, category, seed=11):
    """``benchmarks/dispatch_bench.py::_fill``: seeded uniform images."""
    import numpy as np
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        eng.add_entity("image", img, {"category": category, "idx": i})


def ingest_faces(eng, faces, category) -> list[str]:
    return [eng.add_entity("image", img, {"category": category, "idx": i})
            for i, img in enumerate(faces)]


def find(category, ops):
    return [{"FindImage": {"constraints": {"category": ["==", category]},
                           "operations": ops}}]


def response_hash(entities) -> str:
    import numpy as np
    h = hashlib.sha256()
    for eid in entities:
        arr = np.ascontiguousarray(np.asarray(entities[eid]))
        h.update(eid.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def max_err(a: dict, b: dict) -> float:
    import numpy as np
    if list(a) != list(b):
        raise SmokeFailure("responses name different entities")
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64)
                                   - np.asarray(b[k], np.float64))))
               for k in a)


def run_query(eng, query, timeout=600):
    """Execute ``query`` twice on ``eng``: the first run pays the
    engine's first-use costs (CUDA context and library handles of each
    worker thread, kernel loading), the second is warm.  Returns the
    warm response and ``{"cold_s", "warm_s"}`` host wall times."""
    times = []
    for _ in range(2):
        t0 = time.monotonic()
        res = eng.execute(query, timeout=timeout)
        times.append(time.monotonic() - t0)
        if res["stats"]["failed"]:
            raise SmokeFailure(f"query failed: {res['stats']}")
    return res, {"cold_s": times[0], "warm_s": times[1]}


def fmt(t: dict) -> str:
    return f"cold {t['cold_s'] * 1e3:.3f} ms, warm {t['warm_s'] * 1e3:.3f} ms"


# --------------------------------------------------------------- phases
# benchmarks/dispatch_bench.py's static-hash pipeline: index permutations
# and comparisons only, so its bytes are the same on every platform
STATIC_PIPE = [
    {"type": "crop", "x": 4, "y": 4, "width": 24, "height": 24},
    {"type": "remote", "url": "http://svc/flip", "options": {"id": "flip"}},
    {"type": "rotate", "k": 1},
    {"type": "threshold", "value": 0.5},
]


def phase_static_hash(VDMSAsyncEngine, TransportModel, device="cuda"):
    print("phase 2: static hash on the card", flush=True)
    transport = TransportModel(network_latency_s=0.001, service_time_s=0.001)
    eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                          transport=transport)
    try:
        fill(eng, 8, 32, "dsp")
        res, dt = run_query(eng, find("dsp", STATIC_PIPE))
    finally:
        eng.shutdown()
    digest = response_hash(res["entities"])
    print(f"  sha256 {digest}; {fmt(dt)}", flush=True)
    check(res["stats"]["failed"] == 0, "static-hash query: failed == 0")
    check(digest == STATIC_SHA256, "static hash equals the recorded 778564da…")
    return {"sha256": digest, "query": dt}


def phase_native(VDMSAsyncEngine, TransportModel, faces, launches,
                 device="cuda"):
    import numpy as np
    import torch
    from repro_torch.kernels.ref import gaussian_blur_ref
    print("phase 3: native path at LFW scale (64 x 250x250x3)", flush=True)
    transport = TransportModel(network_latency_s=0.002, service_time_s=0.001)
    blur_q = find("lfw", IQ3_BLUR)
    c2_q = find("lfw", C2_PIPE)
    out = {}
    results = {}
    for dev in (device, "cpu"):
        eng = VDMSAsyncEngine(device=dev, num_remote_servers=2,
                              transport=transport)
        try:
            eids = ingest_faces(eng, faces, "lfw")
            k1_before = launches["gaussian_blur"].count
            blur_res, blur_s = run_query(eng, blur_q)
            k1_blur = launches["gaussian_blur"].count - k1_before
            c2_res, c2_s = run_query(eng, c2_q)
        finally:
            eng.shutdown()
        check(blur_res["stats"]["failed"] == 0
              and c2_res["stats"]["failed"] == 0,
              f"IQ3 blur and C2 on device={dev}: failed == 0")
        results[dev] = (blur_res["entities"], c2_res["entities"])
        out[dev] = {"iq3_blur": blur_s, "c2": c2_s,
                    "k1_launches": k1_blur}
        print(f"  device={dev}: IQ3 blur {fmt(blur_s)}; C2 {fmt(c2_s)}; "
              f"K1 launches {k1_blur}", flush=True)
    check(device == "cpu" or out[device]["k1_launches"] >= len(faces),
          f"native blur launched K1 >= {len(faces)} times")
    ref = gaussian_blur_ref(torch.from_numpy(faces), 5, 1.5).numpy()
    got = np.stack([results[device][0][eid] for eid in eids])
    err = float(np.max(np.abs(got - ref)))
    out["iq3_max_abs_err_vs_plain_host"] = err
    check(err <= NATIVE_TOL,
          f"IQ3 blur on the card vs plain on the host: {err:.3g} <= {NATIVE_TOL}")
    err = max_err(results[device][1], results["cpu"][1])
    out["c2_max_abs_err_vs_cpu_engine"] = err
    check(err <= PIPE_TOL,
          f"C2 on the card vs the CPU engine: {err:.3g} <= {PIPE_TOL}")
    return out


DEVICE_PIPE = [
    {"type": "resize", "width": 256, "height": 256},
    {"type": "crop", "x": 16, "y": 16, "width": 224, "height": 224},
    {"type": "normalize", "mean": 0.45, "std": 0.22},
    {"type": "blur", "ksize": 9, "sigma_x": 2.0},
]
# cost overrides that place every op of DEVICE_PIPE on the device backend
DEVICE_PINNED = {o["type"]: {"device": 1e-6, "native": 10.0,
                             "remote": 10.0, "batcher": 10.0}
                 for o in DEVICE_PIPE}


def phase_device(VDMSAsyncEngine, TransportModel, faces, launches,
                 device="cuda"):
    print("phase 4: device backend (256 x 250x250x3, batch 32)", flush=True)
    transport = TransportModel(network_latency_s=0.002, service_time_s=0.001)
    query = find("lfw", DEVICE_PIPE)
    # True: every visible card (one here); "cpu" for a rehearsal
    backend = True if device == "cuda" else device
    eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                          transport=transport, dispatch="cost",
                          device_backend=backend, device_batch_size=32,
                          device_max_wait_ms=50.0,
                          cost_overrides=DEVICE_PINNED)
    try:
        ingest_faces(eng, faces, "lfw")
        before = {k: c.count for k, c in launches.items()}
        dev_res, dev_s = run_query(eng, query)
        rose = {k: c.count - before[k] for k, c in launches.items()}
        stats = eng.dispatch_stats()
    finally:
        eng.shutdown()
    eng = VDMSAsyncEngine(device=device, num_remote_servers=2,
                          transport=transport, dispatch="native")
    try:
        ingest_faces(eng, faces, "lfw")
        before = {k: c.count for k, c in launches.items()}
        nat_res, nat_s = run_query(eng, query)
        nat_rose = {k: c.count - before[k] for k, c in launches.items()}
    finally:
        eng.shutdown()
    dev = stats["device"]
    print(f"  device arm {fmt(dev_s)}; all-native arm {fmt(nat_s)}; "
          f"launches {rose}, all-native arm {nat_rose}; placements "
          f"{stats.get('placements')}; fused_segments "
          f"{dev['fused_segments']}, groups {dev['groups_run']}, "
          f"compiles {dev['compiles']}", flush=True)
    check(dev_res["stats"]["failed"] == 0 and nat_res["stats"]["failed"] == 0,
          "device and all-native arms: failed == 0")
    check(dev["platform"] == device, f"device backend runs on {device}")
    check(dev["fused_segments"] > 0, "fused_segments > 0")
    check(device == "cpu" or rose["fused_resize_crop_normalize"] > 0,
          "device arm launched the fused preprocess kernel")
    check(device == "cpu" or rose["gaussian_blur"] > 0,
          "device arm launched the blur kernel")
    err = max_err(dev_res["entities"], nat_res["entities"])
    check(err <= PIPE_TOL,
          f"device arm vs all-native on the card: {err:.3g} <= {PIPE_TOL}")
    return {"device_arm": dev_s, "native_arm": nat_s,
            "response": dev_res["entities"],
            "launches": rose, "native_launches": nat_rose,
            "max_abs_err_vs_native": err,
            "fused_segments": dev["fused_segments"],
            "groups_run": dev["groups_run"], "compiles": dev["compiles"],
            "placements": stats.get("placements")}


def time_ms(fn, flush, reps=30):
    """Median device time of ``fn()`` in ms: CUDA events around each
    call, the L2 cache flushed before each (the caller finds its inputs
    cold), and a device-side sleep enqueued ahead of the start event so
    the host has queued all of ``fn``'s work before the clock starts —
    without it an idle card would time the wrapper's host overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launch_split(fn, reps=3):
    """Device ms a call of ``fn()`` spends in each kernel it launches,
    by the kernel's name: ``torch.profiler`` over ``reps`` warm calls
    (no L2 flush, so each launch reads what the one before left in L2)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", 0)
        name = re.search(r"(\w+_kernel)", e.key)
        if total > 0 and name:
            split[name.group(1)] = split.get(name.group(1), 0.0) + \
                total / reps / 1e3
    return split


class HeldCalls:
    """Within ``with HeldCalls() as held:``, the engine's calls of K1's
    and K2's wrappers (through ``repro_torch.kernels.ops``, its only way
    to them) keep, for the first call at each signature (the shape, and
    the window or the resize and crop), a copy of the input and of the
    output.  ``held.check(phase)`` then holds each output against the
    plain version on the same input, K1 bit for bit and K2 within
    ``K2_TOL``, and returns each signature with its calls: a kernel is
    checked at every shape a phase gave it, whatever the micro-batches
    came to.  The check launches no kernel; the wrappers count their
    launches as they do outside the block."""

    def __init__(self):
        self.calls, self._lock = {}, threading.Lock()

    def _held(self, kind, fn):
        def held(img, *args, **kw):
            key = (kind, tuple(img.shape), args, tuple(sorted(kw.items())))
            x = img.clone()
            out = fn(img, *args, **kw)
            with self._lock:
                entry = self.calls.setdefault(key, {"n": 0})
                entry["n"] += 1
                if entry["n"] == 1:
                    entry.update(x=x, out=out.clone(), kw=kw)
            return out
        return held

    def launches(self, kind) -> int:
        """Calls of ``kind`` that returned: its wrapper's launches."""
        return sum(e["n"] for key, e in self.calls.items()
                   if key[0] == kind)

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels import preprocess as pp
        self._saved = (ops.gaussian_blur_cuda,
                       pp.fused_resize_crop_normalize_cuda)
        ops.gaussian_blur_cuda = self._held("K1", self._saved[0])
        pp.fused_resize_crop_normalize_cuda = self._held("K2",
                                                         self._saved[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.kernels import preprocess as pp
        ops.gaussian_blur_cuda, pp.fused_resize_crop_normalize_cuda = \
            self._saved

    def check(self, phase) -> list:
        import torch
        from repro_torch.kernels import preprocess as pp
        from repro_torch.kernels.ref import gaussian_blur_ref
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        rows = []
        for (kind, shape, args, _), e in sorted(self.calls.items(),
                                                key=lambda kv: str(kv[0])):
            if kind == "K1":
                want = gaussian_blur_ref(e["x"], *args, **e["kw"])
            else:
                want = pp.fused_resize_crop_normalize_ref(e["x"], *args,
                                                          **e["kw"])
            err = (float((e["out"] - want).abs().max()) if want.numel()
                   else 0.0)
            ok = (torch.equal(e["out"], want) if kind == "K1"
                  else err <= K2_TOL)
            params = list(args) or e["kw"]
            check(ok, f"phase {phase}: {kind} {shape} {params}, {e['n']} "
                  f"calls: the first "
                  + ("equal to the plain version" if kind == "K1"
                     else f"within {K2_TOL} of the plain version")
                  + f" (max_abs_err {err:.3g})")
            rows.append({"kernel": kind, "shape": list(shape),
                         "params": params, "calls": e["n"],
                         "max_abs_err": err})
        return rows


def ssd_inputs(rng, B, T, H, P, G, N, dtype):
    """x ~ N(0,1), dt = softplus(N(0,1)) / 2, A = -exp(0.3 N), B, C ~
    0.5 N, D = |0.1 N|, h0 ~ 0.1 N (the JAX package's kernel-test
    inputs), drawn with numpy and moved to the card."""
    import numpy as np
    import torch

    def n(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()

    x = n((B, T, H, P)).to(dtype)
    dt = torch.nn.functional.softplus(n((B, T, H))) * 0.5
    A = -torch.exp(n((H,), 0.3))
    Bm, Cm = n((B, T, G, N), 0.5).to(dtype), n((B, T, G, N), 0.5).to(dtype)
    return x, dt, A, Bm, Cm, n((H,), 0.1).abs(), n((B, H, P, N), 0.1)


def wkv_inputs(rng, B, T, H, K, dtype, shift=0.0):
    """r, k ~ 0.5 N, v ~ N, u ~ 0.1 N, s0 ~ 0.1 N, and the model's decay
    w = exp(-exp(ww)) with ww = -4 + shift + N(0, 1) (the seeded LoRA's
    spread around ``decay_base``), drawn with numpy, moved to the card;
    r, k and v in ``dtype``, w, u and s0 in float32."""
    import numpy as np
    import torch

    def n(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()

    r, k, v = n((B, T, H, K), 0.5), n((B, T, H, K), 0.5), n((B, T, H, K))
    w = torch.exp(-torch.exp(-4.0 + shift + n((B, T, H, K))))
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, n((H, K), 0.1),
            n((B, H, K, K), 0.1))


def blur_work(shape, ksize):
    """Bytes and operations of one blur call: the image read and written
    once in float32; a multiply and an add per tap, in each of the two
    passes, per value (fp32 FMA, no product on the tensor cores)."""
    n, h, w, c = shape
    return 2 * n * h * w * c * 4, 4 * ksize * n * h * w * c


def preprocess_work(n, h, w, c, hc, wc, py, px, nnz_y, nnz_x):
    """Bytes and operations of one fused resize/crop/normalize call of
    ``n`` images of ``h`` x ``w`` x ``c`` to ``hc`` x ``wc``: the images
    and the output once in float32, and the tap tables that stand for the
    cropped matrices (per output row and column a 4-byte first index and
    ``py`` or ``px`` float32 taps); the two banded contractions over the
    matrices' ``nnz_y`` and ``nnz_x`` nonzeros and the affine epilogue
    (fp32 FMA, no product on the tensor cores)."""
    nbytes = (n * h * w * c + n * hc * wc * c
              + hc * (py + 1) + wc * (px + 1)) * 4
    flops = 2 * n * c * (nnz_y * w + hc * nnz_x) + 2 * n * hc * wc * c
    return nbytes, flops


# the device backend's preprocess (DEVICE_PIPE), and a 1080p frame
# downsampled to a model's input with lanczos3 (the wide-window route)
K2_MAIN = dict(resize_h=256, resize_w=256, method="bilinear", crop_x=16,
               crop_y=16, crop_w=224, crop_h=224, mean=0.45, std=0.22)
K2_1080P = dict(resize_h=224, resize_w=224, method="lanczos3", crop_x=0,
                crop_y=0, crop_w=224, crop_h=224, mean=0.45, std=0.22)
# the 1080p frame to 8 x 8: windows of 1,440 columns (the wide route)
K2_WIDE = dict(K2_1080P, resize_h=8, resize_w=8, crop_w=8, crop_h=8)
# phase 21's K1 calls (benchmarks/torch_*; phase 21 holds every one it
# makes through HeldCalls): the native pool's two blurs of 128 x 128, the
# video suite's VQ3 on 240 x 320 and 48 x 48 frames, cputrace's 32 x 32,
# the dispatch device arm's all-native side (an image a launch) and its
# micro-batch of 8, and the fused segment's 8 crops of 48 x 48; and K2
# in that fused segment
BENCH_BLURS = [((1, 128, 128, 3), 7, 2.0), ((1, 128, 128, 3), 5, 1.5),
               ((1, 240, 320, 3), 5, 1.5), ((1, 48, 48, 3), 5, 1.5),
               ((1, 32, 32, 3), 5, 1.0), ((1, 64, 64, 3), 9, 2.0),
               ((8, 64, 64, 3), 9, 2.0), ((8, 48, 48, 3), 9, 2.0)]
K2_FUSED_ARM = dict(resize_h=64, resize_w=64, method="bilinear", crop_x=8,
                    crop_y=8, crop_w=48, crop_h=48, mean=0.45, std=0.22)
K2_ROUTES = {"direct": "fp32 FMA over tap tables: direct, a thread per "
                       "output float (2 x 2 taps)",
             "tiled": "fp32 FMA over tap tables: tiled, streamed vertical "
                      "pass into a shared tile",
             "wide": "fp32 FMA over tap tables: wide, two passes through "
                     "a scratch image"}


def offset_mask(Sq, Sk, q_offset, device="cuda"):
    """The causal mask of a prefill of ``Sq`` rows at ``q_offset`` into a
    cache of ``Sk`` slots, as ``scaled_dot_product_attention``'s boolean
    ``attn_mask``: row i sees key j when j <= q_offset + i."""
    import torch
    return (torch.arange(Sk, device=device)[None, :]
            <= q_offset + torch.arange(Sq, device=device)[:, None])


def bound(nbytes, products, other, dtype):
    """Least time in ms and what sets it, the longest of three: the bytes
    at the HBM rate (``"bytes"``), the matrix products at the
    tensor-core rate for the operands' type ``dtype`` (``"products"``),
    and the other operations at the float32 rate outside the tensor
    cores (``"other"``)."""
    times = {"bytes": nbytes / HBM_BYTES_S,
             "products": products / PRODUCT_FLOP_S[str(dtype)],
             "other": other / FP32_FLOP_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def phase_kernels():
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import preprocess as pp
    from repro_torch.kernels import ref
    from repro_torch.kernels.gaussian_blur import fast_route, gaussian_blur_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_cuda
    from repro_torch.kernels.ref import gaussian_blur_ref, gaussian_kernel_1d
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    print("phase 5: kernels against their plain versions", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rows, entries = [], {}

    def blur_case(shape, ksize, sigma):
        x = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).cuda()
        got = gaussian_blur_cuda(x, ksize, sigma)
        want = gaussian_blur_ref(x, ksize, sigma)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"K1 {shape} k{ksize}: equal to the plain version (max_abs_err {err:.3g})")
        c = shape[-1]
        taps = torch.from_numpy(gaussian_kernel_1d(ksize, sigma)).cuda()
        wy = taps.view(1, 1, ksize, 1).expand(c, 1, ksize, 1).contiguous()
        wx = taps.view(1, 1, 1, ksize).expand(c, 1, 1, ksize).contiguous()
        pad = ksize // 2

        def library():  # composition: reflect pad + two depthwise conv2d
            y = x.permute(0, 3, 1, 2)
            y = F.pad(y, (pad, pad, pad, pad), mode="reflect")
            y = F.conv2d(y, wy, groups=c)
            return F.conv2d(y, wx, groups=c).permute(0, 2, 3, 1)

        lib_err = float((library() - want).abs().max())
        nbytes, flops = blur_work(shape, ksize)
        bound_ms, bound_by = bound(nbytes, 0, flops, x.dtype)
        return {
            "shape": list(shape), "ksize": ksize, "sigma": sigma,
            "route": ("fp32, window in registers" if fast_route(ksize, c)
                      else "fp32, general route (two passes)"),
            "max_abs_err": err,
            "ms": time_ms(lambda: gaussian_blur_cuda(x, ksize, sigma), flush),
            "plain_ms": time_ms(lambda: gaussian_blur_ref(x, ksize, sigma), flush),
            "library_ms": time_ms(library, flush),
            "library_call": "F.pad(reflect) + 2 x depthwise F.conv2d "
                            "(a composition; no single torch call)",
            "library_max_abs_err": lib_err,
            "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }

    def preprocess_case(shape, kw):
        n, h, w, c = shape
        x = torch.from_numpy(
            rng.uniform(0, 1, shape).astype(np.float32)).cuda()
        got = pp.fused_resize_crop_normalize_cuda(x, **kw)
        want = pp.fused_resize_crop_normalize_ref(x, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= K2_TOL, f"K2 {tuple(x.shape)} {kw['method']}: "
              f"max_abs_err {err:.3g} <= {K2_TOL}")
        geometry = (h, w, kw["resize_h"], kw["resize_w"],
                    pp._canonical_method(kw["method"]), kw["crop_x"],
                    kw["crop_y"], kw["crop_w"], kw["crop_h"])
        ry, rx = pp._cropped_matrices(*geometry)
        ry_t, rx_t = torch.from_numpy(ry.copy()).cuda(), torch.from_numpy(rx.copy()).cuda()

        def library():  # one einsum: the cropped resize
            return torch.einsum("oh,nhwc,pw->nopc", ry_t, x, rx_t)

        hc, wc = got.shape[1], got.shape[2]
        nnz_y, nnz_x = int((ry != 0).sum()), int((rx != 0).sum())
        (_, yt), (_, xt) = pp._tables(*geometry)
        nbytes, flops = preprocess_work(n, h, w, c, hc, wc, yt.shape[1],
                                        xt.shape[1], nnz_y, nnz_x)
        dense_flops = 2 * n * c * (hc * h * w + hc * wc * w)
        bound_ms, bound_by = bound(nbytes, 0, flops, x.dtype)
        return {
            "shape": list(shape), "params": kw,
            "route": K2_ROUTES[pp._plan(geometry, n, c)["route"]],
            "max_abs_err": err,
            "ms": time_ms(lambda: pp.fused_resize_crop_normalize_cuda(x, **kw), flush),
            "plain_ms": time_ms(
                lambda: pp.fused_resize_crop_normalize_ref(x, **kw), flush),
            "library_ms": time_ms(library, flush),
            "library_call": "torch.einsum('oh,nhwc,pw->nopc') of the "
                            "cropped matrices (no normalize)",
            "bytes": nbytes, "flops": flops, "dense_flops": dense_flops,
            "dense_fp32_ms": dense_flops / FP32_FLOP_S * 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }

    def ssd_case(B, T, H, P, G, N, dtype=torch.float32, chunk=128):
        x, dt, A, Bm, Cm, D, h0 = ssd_inputs(rng, B, T, H, P, G, N, dtype)
        c = min(chunk, max(T, 8))
        y, h = mamba2_ssd_cuda(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
        y_p, h_p = ref.mamba2_ssd_chunked(x, dt, A, Bm, Cm, D, h0, chunk=c)
        torch.cuda.synchronize()
        dy, dh = (y.float() - y_p.float()).abs(), (h - h_p).abs()
        err = max(float(dy.max()), float(dh.max()))
        what = (f"K4 {(B, T, H, P)} G={G} N={N} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3g}")
        if dtype == torch.float32:
            check(err <= K4_TOL, f"{what} <= {K4_TOL}")
        else:
            excess = max(float((dy - K4_BF16_RTOL * y_p.float().abs()).max()),
                         float((dh - K4_BF16_RTOL * h_p.abs()).max()))
            check(excess <= K4_BF16_ATOL,
                  f"{what}; beyond {K4_BF16_RTOL:.4g} relative: "
                  f"{excess:.3g} <= {K4_BF16_ATOL}")
        nbytes, products, other = ssd_work(B, T, H, P, G, N,
                                           x.element_size())
        flops = products + other
        bound_ms, bound_by = bound(nbytes, products, other, dtype)
        return {
            "shape": [B, T, H, P], "G": G, "N": N, "chunk": c,
            "dtype": str(dtype), "max_abs_err": err,
            "ms": time_ms(lambda: mamba2_ssd_cuda(x, dt, A, Bm, Cm, D, h0,
                                                  chunk=chunk), flush),
            "plain_ms": time_ms(lambda: ref.mamba2_ssd_chunked(
                x, dt, A, Bm, Cm, D, h0, chunk=c), flush, reps=10),
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes SSD",
            "route": ("mma.sync 3xTF32" if dtype == torch.float32 else
                      "mma.sync TF32, bf16 operands exact (1-2 passes)"),
            "bytes": nbytes, "flops": flops, "products": products,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }

    def ssd_model_layout():
        """x, B and C as the model hands them over: strided slices of one
        packed in-projection (B=2, T=130, H=80, P=N=64)."""
        Bsz, T, H, P, N = 2, 130, 80, 64, 64
        x, dt, A, Bm, Cm, D, h0 = ssd_inputs(rng, Bsz, T, H, P, 1, N,
                                             torch.float32)
        packed = torch.cat([x.reshape(Bsz, T, H * P), Bm.reshape(Bsz, T, N),
                            Cm.reshape(Bsz, T, N)], dim=-1)
        xv, bv, cv = torch.split(packed, [H * P, N, N], dim=-1)
        y, h = mamba2_ssd_cuda(xv.reshape(Bsz, T, H, P), dt, A,
                               bv.reshape(Bsz, T, 1, N),
                               cv.reshape(Bsz, T, 1, N), D, h0)
        y_p, h_p = ref.mamba2_ssd_chunked(x, dt, A, Bm, Cm, D, h0)
        torch.cuda.synchronize()
        err = max(float((y - y_p).abs().max()), float((h - h_p).abs().max()))
        check(err <= K4_TOL, f"K4 on strided slices of a packed in-projection: "
              f"max_abs_err {err:.3g} <= {K4_TOL}")
        return {"shape": [Bsz, T, H, P], "strided": True, "max_abs_err": err}

    def held(what, got, want, atol, rtol=0.0):
        """Max |got - want| over pairs; checks that it stays within
        ``atol`` beyond ``rtol`` of |want|.  Returns the max error."""
        err, excess = 0.0, 0.0
        for g, w in zip(got, want):
            d = (g.float() - w.float()).abs()
            err = max(err, float(d.max()))
            excess = max(excess, float((d - rtol * w.float().abs()).max()))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        beyond = f"; beyond {rtol:.4g} relative {excess:.3g}" if rtol else ""
        check(finite and excess <= atol,
              f"{what}: finite, max_abs_err {err:.3g}{beyond} <= {atol}")
        return err

    def wkv_case(B, T, H, K, dtype=torch.float32, shift=0.0, plain=None,
                 timed=True, what=""):
        r, k, v, w, u, s0 = wkv_inputs(rng, B, T, H, K, dtype, shift)
        plain = plain or ref.rwkv6_chunked
        y, s = rwkv6_scan_cuda(r, k, v, w, u, s0)
        y_p, s_p = plain(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        name = (f"K5 {(B, T, H, K)} {str(dtype)[6:]}{what} against "
                f"{plain.__name__}")
        if dtype == torch.float32:
            err = held(name, (y, s), (y_p, s_p), K5_TOL)
        else:
            err = held(name, (y, s), (y_p, s_p), K5_BF16_ATOL, K5_BF16_RTOL)
        row = {"kernel": "rwkv6_scan", "shape": [B, T, H, K],
               "dtype": str(dtype), "decay_shift": shift, "max_abs_err": err,
               "route": ("mma.sync 3xTF32" if dtype == torch.float32 else
                         "mma.sync 3xTF32, bf16 v exact (2 passes)"),
               # the reference's clamp: strong decays underflow w to 0
               "log_w_median": float(torch.log(w.clamp_min(1e-30)).median())}
        if not timed:
            return row
        nbytes, products, other = wkv_work(B, T, H, K, K, r.element_size())
        flops = products + other
        bound_ms, bound_by = bound(nbytes, products, other, dtype)
        row.update({
            "ms": time_ms(lambda: rwkv6_scan_cuda(r, k, v, w, u, s0), flush),
            "plain_ms": time_ms(lambda: ref.rwkv6_chunked(r, k, v, w, u, s0),
                                flush, reps=10),
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes WKV6",
            "bytes": nbytes, "flops": flops, "products": products,
            "bound_ms": bound_ms, "bound_by": bound_by})
        return row

    def wkv_carry(B, T, H, K, split):
        """Two calls that carry the state, against one over the whole."""
        r, k, v, w, u, s0 = wkv_inputs(rng, B, T, H, K, torch.float32)
        y, s = rwkv6_scan_cuda(r, k, v, w, u, s0)
        y1, s1 = rwkv6_scan_cuda(r[:, :split], k[:, :split], v[:, :split],
                                 w[:, :split], u, s0)
        y2, s2 = rwkv6_scan_cuda(r[:, split:], k[:, split:], v[:, split:],
                                 w[:, split:], u, s1)
        torch.cuda.synchronize()
        err = held(f"K5 {(B, T, H, K)} as two calls split at {split} "
                   "carrying the state, against one call",
                   (torch.cat([y1, y2], 1), s2), (y, s), K5_TOL)
        return {"kernel": "rwkv6_scan", "shape": [B, T, H, K],
                "split": split, "max_abs_err": err}

    def attn_case(B, Sq, Sk, H, Hkv, D, q_offset=0, causal=True,
                  dtype=torch.float32, library=False):
        def n(shape):
            return torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)).cuda().to(dtype)
        q, k, v = n((B, Sq, H, D)), n((B, Sk, Hkv, D)), n((B, Sk, Hkv, D))
        o, lse = flash_attention_cuda(q, k, v, q_offset=q_offset,
                                      causal=causal)
        o_p, lse_p = ref.flash_attention_chunked(q, k, v, causal=causal,
                                                 q_offset=q_offset)
        torch.cuda.synchronize()
        what = (f"K3 q {(B, Sq, H, D)} kv {(Sk, Hkv)} q_offset {q_offset} "
                f"{'causal' if causal else 'full'} {str(dtype)[6:]}")
        if dtype == torch.float32:
            err = held(what, (o,), (o_p,), K3_TOL)
        else:
            err = held(what, (o,), (o_p,), K3_BF16_ATOL, K3_BF16_RTOL)
        lse_err = held(f"{what}: log-sum-exp", (lse,), (lse_p,), K3_LSE_TOL)
        nbytes, products, other = attn_work(B, Sq, Sk, H, Hkv, D, q_offset,
                                            causal, q.element_size())
        flops = products + other
        bound_ms, bound_by = bound(nbytes, products, other, dtype)
        row = {"kernel": "flash_attention", "shape": [B, Sq, H, D],
               "kv": [Sk, Hkv], "q_offset": q_offset, "causal": causal,
               "dtype": str(dtype), "max_abs_err": err,
               "lse_max_abs_err": lse_err,
               "ms": time_ms(lambda: flash_attention_cuda(
                   q, k, v, q_offset=q_offset, causal=causal), flush),
               "plain_ms": time_ms(lambda: ref.flash_attention_chunked(
                   q, k, v, causal=causal, q_offset=q_offset), flush, reps=5),
               "library_ms": None,
               "library_call": "none timed at this shape",
               "route": ("mma.sync 3xTF32" if dtype == torch.float32
                         else "wgmma bf16"),
               "bytes": nbytes, "flops": flops, "products": products,
               "bound_ms": bound_ms, "bound_by": bound_by}
        if library:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if q_offset:  # is_causal would align its mask top-left
                kw, call = dict(attn_mask=offset_mask(Sq, Sk, q_offset)), (
                    f"F.scaled_dot_product_attention(a ({Sq}, {Sk}) boolean "
                    "attn_mask, enable_gqa) on (B,H,S,D) views")
            else:  # top-left causal mask: the same function at offset 0
                kw, call = dict(is_causal=causal), (
                    "F.scaled_dot_product_attention(is_causal, enable_gqa) "
                    "on (B,H,S,D) views")

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      enable_gqa=True, **kw)

            row["library_max_abs_err"] = float(
                (lib().transpose(1, 2).float() - o_p.float()).abs().max())
            row["library_ms"] = time_ms(lib, flush)
            row["library_call"] = call
        return row

    def attn_grad_case(B, S, H, Hkv, D, dtype, earlier):
        """Flash attention forward (K3) and its recomputing backward
        (the backward kernel) through ``flash_vjp``'s Function, causal,
        against autograd through the plain chunked forward on the same
        tensors; timed forward + backward, beside SDPA's forward +
        backward.  Both the Function's and SDPA's gradients are also held
        against float32 plain gradients (printed, not gated: in bfloat16
        SDPA's error is the yardstick of the kernel's).  ``earlier``: the
        same row's ms on an H100 with earlier backwards, by route
        (``PERF.md`` §6 names the runs)."""
        from repro_torch.kernels import flash_vjp

        def n(shape):
            return torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)).cuda().to(dtype)
        q, k, v, do = n((B, S, H, D)), n((B, S, Hkv, D)), n((B, S, Hkv, D)), \
            n((B, S, H, D))

        def grads(forward):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = forward(*leaves)
            out.backward(do)
            return out.detach(), [t.grad for t in leaves]

        def kernel(*t):
            return flash_vjp.flash_attention(*t)

        def plain(*t):
            return ref.flash_attention_chunked(*t)[0]

        (o, got), (o_p, want) = grads(kernel), grads(plain)
        torch.cuda.synchronize()
        what = (f"K3 forward + recomputing backward q {(B, S, H, D)} kv heads "
                f"{Hkv} causal {str(dtype)[6:]}")
        if dtype == torch.float32:
            fwd_err = held(f"{what}: the Function's output against the plain "
                           "forward", (o,), (o_p,), K3_TOL)
        else:
            fwd_err = held(f"{what}: the Function's output against the plain "
                           "forward", (o,), (o_p,), K3_BF16_ATOL, K3_BF16_RTOL)
        what += ": dq, dk, dv against autograd through the plain forward"
        if dtype == torch.float32:
            err = held(what, got, want, K3_GRAD_TOL, K3_GRAD_RTOL)
        else:
            err = held(what, got, want, K3_GRAD_BF16_TOL, K3_GRAD_BF16_TOL)
        check(all(g.dtype == dtype for g in got), f"{what}: grads in {dtype}")
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))

        def library():
            leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            F.scaled_dot_product_attention(
                *leaves, is_causal=True, enable_gqa=Hkv != H).backward(dot)
            return [t.grad.transpose(1, 2) for t in leaves]

        # float32 plain gradients: the kernel's and SDPA's error against them
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        plain(*leaves).backward(do.float())
        want32 = [t.grad for t in leaves]
        del leaves
        err32, lib_err32 = (max(float((g.float() - w).abs().max())
                                for g, w in zip(gs, want32))
                            for gs in (got, library()))
        print(f"  {what}: against float32 plain gradients, the Function "
              f"{err32:.4g}, SDPA {lib_err32:.4g}", flush=True)
        del want32

        nbytes, products, other = attn_grad_work(B, S, S, H, Hkv, D, 0, True,
                                                 q.element_size())
        bound_ms, bound_by = bound(nbytes, products, other, dtype)
        return {"kernel": "flash_attention+backward", "shape": [B, S, H, D],
                "kv": [S, Hkv], "causal": True, "dtype": str(dtype),
                "max_abs_err": err, "forward_max_abs_err": fwd_err,
                "ms": time_ms(lambda: grads(kernel), flush, reps=10),
                "plain_ms": time_ms(lambda: grads(plain), flush, reps=3),
                "library_ms": time_ms(library, flush, reps=10),
                "library_call": "F.scaled_dot_product_attention(is_causal"
                                ", enable_gqa) forward + backward on "
                                "(B,H,S,D) views",
                "route": ("K3 forward (" + ("mma.sync 3xTF32" if dtype ==
                          torch.float32 else "wgmma bf16") + ") + the "
                          "backward kernel flash_attention_bwd.cu (" + (
                          K3_BWD_F32_ROUTE if dtype == torch.float32 else
                          "wgmma bf16, TMA producer warp") +
                          "; dQ pass, then dK/dV pass)"),
                "earlier_ms": earlier,
                "max_abs_err_vs_f32": err32,
                "library_max_abs_err_vs_f32": lib_err32,
                "bytes": nbytes, "flops": products + other,
                "products": products, "bound_ms": bound_ms,
                "bound_by": bound_by}

    def attn_bwd_case(B, S, H, Hkv, D, dtype, earlier=None):
        """The backward kernel alone, causal, over K3's output and
        log-sum-exp, against its plain version (``flash_backward``, the
        reference's ``_bwd`` in ``torch.einsum``) on the same tensors;
        timed beside SDPA's backward alone (``torch.autograd.grad``
        through one SDPA forward, the graph kept).  In float32 the plain
        version's gradients are float32 plain gradients: SDPA's error
        against them is printed beside the kernel's.  ``earlier``: the
        row's ms with earlier backward kernels, by route (``PERF.md`` §6
        names the runs)."""
        from repro_torch.kernels import flash_vjp
        from repro_torch.kernels.flash_attention import \
            flash_attention_backward_cuda

        def n(shape):
            return torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)).cuda().to(dtype)
        q, k, v, do = n((B, S, H, D)), n((B, S, Hkv, D)), n((B, S, Hkv, D)), \
            n((B, S, H, D))
        out, lse = flash_attention_cuda(q, k, v)

        def kernel():
            return flash_attention_backward_cuda(q, k, v, out, lse, do)

        def plain():
            return flash_vjp.flash_backward(q, k, v, out, lse, do)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        what = (f"K3 backward kernel alone q {(B, S, H, D)} kv heads {Hkv} "
                f"causal {str(dtype)[6:]}: dq, dk, dv against flash_backward")
        if dtype == torch.float32:
            err = held(what, got, want, K3_GRAD_TOL, K3_GRAD_RTOL)
        else:
            err = held(what, got, want, K3_GRAD_BF16_TOL, K3_GRAD_BF16_TOL)
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                               enable_gqa=Hkv != H)
        dot = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(o_lib, leaves, dot, retain_graph=True)

        lib_err = None
        if dtype == torch.float32:
            lib_err = max(float((g.transpose(1, 2) - w).abs().max())
                          for g, w in zip(library(), want))
            print(f"  {what[:what.index(':')]}: against float32 plain "
                  f"gradients, the kernel {err:.4g}, SDPA's backward "
                  f"{lib_err:.4g}", flush=True)
        del got, want

        nbytes, products, other = attn_bwd_work(B, S, S, H, Hkv, D, 0, True,
                                                q.element_size())
        bound_ms, bound_by = bound(nbytes, products, other, dtype)
        # the two passes' own floor: S and dP recomputed, 14D a pair
        floor_ms = bound(nbytes, products * 14 // 10, other, dtype)[0]
        row = {"kernel": "flash_attention_backward", "shape": [B, S, H, D],
               "kv": [S, Hkv], "causal": True, "dtype": str(dtype),
               "max_abs_err": err, "ms": time_ms(kernel, flush),
               "plain_ms": time_ms(plain, flush, reps=3),
               "library_ms": time_ms(library, flush),
               "library_call": "torch.autograd.grad through one "
                               "F.scaled_dot_product_attention(is_causal, "
                               "enable_gqa) forward: its backward alone",
               "route": (K3_BWD_F32_ROUTE if dtype == torch.float32 else
                         "wgmma bf16: a TMA producer warp, two consumer "
                         "warpgroups") + ", two passes (dQ; "
                         "dK/dV)",
               "earlier_ms": earlier,
               "library_max_abs_err_vs_f32": lib_err,
               "bytes": nbytes, "flops": products + other,
               "products": products, "bound_ms": bound_ms,
               "bound_by": bound_by, "floor_14d_ms": floor_ms}
        del o_lib, leaves
        return row

    def scan_grad_case(kind, shape, dtype, earlier=None):
        """K4 or K5 forward (the kernel) and its Function's backward (the
        backward kernel), with a cotangent for y only (as a training
        step), against
        ``torch.autograd.grad`` through the plain chunked forward on the
        same tensors on the card; timed forward + backward, beside
        autograd through the plain forward (no single PyTorch call
        computes either scan).  ``earlier``: the same row's times before
        the backward kernel, by run."""
        from repro_torch.kernels import mamba2_ssd as ssd_mod
        from repro_torch.kernels import rwkv6_scan as wkv_mod
        if kind == "mamba2_ssd":
            B, T, H, P, G, N = shape
            inputs = ssd_inputs(rng, B, T, H, P, G, N, dtype)[:6]
            chunk = min(128, max(T, 8))

            def kernel(*t):
                return ssd_mod.mamba2_ssd(*t, chunk=chunk)

            def plain(*t):
                return ref.mamba2_ssd_chunked(*t, chunk=chunk)

            nbytes, products, other = ssd_grad_work(
                B, T, H, P, G, N, inputs[0].element_size())
            tol, bf16 = K4_TOL, (K4_BF16_ATOL, K4_BF16_RTOL)
            dims = [B, T, H, P]
        else:
            B, T, H, K = shape
            inputs = wkv_inputs(rng, B, T, H, K, dtype)[:5]
            kernel, plain = wkv_mod.rwkv6_scan, ref.rwkv6_chunked
            nbytes, products, other = wkv_grad_work(
                B, T, H, K, K, inputs[0].element_size())
            tol, bf16 = K5_TOL, (K5_BF16_ATOL, K5_BF16_RTOL)
            dims = [B, T, H, K]
        dy = torch.from_numpy(rng.standard_normal(
            tuple(inputs[0].shape[:3]) + (dims[3],)).astype(np.float32)
        ).cuda().to(dtype)

        def grads(forward):
            leaves = [t.detach().requires_grad_() for t in inputs]
            y = forward(*leaves)[0]
            return y.detach(), torch.autograd.grad(y, leaves, dy)

        (y, got), (y_p, want) = grads(kernel), grads(plain)
        torch.cuda.synchronize()
        what = (f"{'K4' if kind == 'mamba2_ssd' else 'K5'} forward + "
                f"backward kernel {tuple(shape)} {str(dtype)[6:]}")
        if dtype == torch.float32:
            fwd_err = held(f"{what}: the Function's output against the "
                           "plain forward", (y,), (y_p,), tol)
        else:
            fwd_err = held(f"{what}: the Function's output against the "
                           "plain forward", (y,), (y_p,), *bf16)
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            top = float(w.float().abs().max())
            rtol = SCAN_GRAD_BF16_RTOL if g.dtype == torch.bfloat16 else 0.0
            err = max(err, held(
                f"{what}: gradient {i} against autograd through the plain "
                f"forward", (g,), (w,), SCAN_GRAD_TOL * max(top, 1e-30),
                rtol))
            check(g.dtype == inputs[i].dtype,
                  f"{what}: gradient {i} in its input's {g.dtype}")
        bound_ms, bound_by = bound(nbytes, products, other, dtype)
        return {"kernel": f"{kind}+backward", "shape": dims,
                "dtype": str(dtype), "max_abs_err": err,
                "forward_max_abs_err": fwd_err,
                "ms": time_ms(lambda: grads(kernel), flush, reps=10),
                "plain_ms": time_ms(lambda: grads(plain), flush, reps=3),
                "library_ms": None,
                "library_call": "none: no single PyTorch call computes "
                                "the scan or its gradient",
                "route": ("K4 forward + the backward kernel "
                          "mamba2_ssd_bwd.cu (mma.sync 3xTF32)"
                          if kind == "mamba2_ssd" else
                          "K5 forward + the backward kernel "
                          "rwkv6_scan_bwd.cu (mma.sync 3xTF32, a walk over "
                          "64-step boundaries)"),
                "earlier_ms": earlier,
                "bytes": nbytes, "flops": products + other,
                "products": products, "bound_ms": bound_ms,
                "bound_by": bound_by}

    def wkv_bwd_case(B, T, H, K, dtype, earlier):
        """K5's backward kernel alone, y's cotangent only (as a training
        step), against autograd through the plain chunked forward
        computed in float64 on the same tensors under the scans' gradient
        gates, each gradient in its input's dtype, two launches equal bit
        for bit (no atomics); timed beside its plain version,
        ``ref.rwkv6_chunked_backward``.  The yardstick is float64: at
        (2,4096,32,64) bf16 autograd through the float32 plain forward
        lies 1.08e-5 of dw's largest from it, past the 1e-5 gate, and the
        kernel 3.5e-6 (on an H100 80GB HBM3 at 700 W, this phase's draw),
        so a float32 yardstick fails the kernel on its own rounding; its
        distance is printed.  ``earlier`` names earlier routes' times at
        this shape."""
        from repro_torch.kernels.rwkv6_scan import rwkv6_scan_backward_cuda
        r, k, v, w, u, _ = wkv_inputs(rng, B, T, H, K, dtype)
        dy = torch.from_numpy(rng.standard_normal((B, T, H, K)).astype(
            np.float32)).cuda().to(dtype)

        def kernel():
            return rwkv6_scan_backward_cuda(r, k, v, w, u, None, dy, None)[:5]

        def plain():
            return ref.rwkv6_chunked_backward(r, k, v, w, u, None, dy,
                                              None)[:5]

        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        leaves = [t.detach().double().requires_grad_()
                  for t in (r, k, v, w, u)]
        want = torch.autograd.grad(ref.rwkv6_chunked(
            *leaves, compute_dtype=torch.float64)[0], leaves, dy.double())
        leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u)]
        want32 = torch.autograd.grad(ref.rwkv6_chunked(*leaves)[0], leaves,
                                     dy)
        del leaves
        what = f"K5 backward kernel alone {(B, T, H, K)} {str(dtype)[6:]}"
        err = 0.0
        for name, g, wt, w32, t in zip(("dr", "dk", "dv", "dw", "du"), got,
                                       want, want32, (r, k, v, w, u)):
            top = float(wt.abs().max())
            rtol = SCAN_GRAD_BF16_RTOL if g.dtype == torch.bfloat16 else 0.0
            err = max(err, held(
                f"{what}: {name} against autograd through the plain forward "
                "in float64", (g,), (wt,), SCAN_GRAD_TOL * max(top, 1e-30),
                rtol))
            check(g.dtype == t.dtype, f"{what}: {name} in its input's "
                  f"{t.dtype} ({g.dtype})")
            gap = float((g.double() - wt).abs().max()) / max(top, 1e-30)
            gap32 = float((w32.double() - wt).abs().max()) / max(top, 1e-30)
            print(f"  {what}: {name}: the kernel {gap:.3g} of the largest "
                  "from float64, autograd through the float32 plain "
                  f"forward {gap32:.3g}", flush=True)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{what}: two launches give equal bits")
        del want, want32, again
        plain_err = max(float((g.float() - p.float()).abs().max())
                        for g, p in zip(got, plain()))
        print(f"  {what}: against its plain version {plain_err:.4g}",
              flush=True)
        nbytes, products, other = wkv_bwd_work(B, T, H, K, K,
                                               r.element_size())
        bound_ms, bound_by = bound(nbytes, products, other, dtype)
        split = launch_split(kernel)
        print(f"  {what}: by launch (warm) " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in split.items()), flush=True)
        return {"kernel": "rwkv6_scan_backward", "shape": [B, T, H, K],
                "dtype": str(dtype), "max_abs_err": err,
                "max_abs_err_vs_plain": plain_err,
                "ms": time_ms(kernel, flush),
                "launch_ms": split,
                "plain_ms": time_ms(plain, flush, reps=3),
                "library_ms": None,
                "library_call": "none: no single PyTorch call computes "
                                "the WKV6 gradient",
                "route": "mma.sync 3xTF32: each 64-step block's own "
                         "state and adjoint shares (chained from 16-step "
                         "sub-shares), a walk over the 64-step boundaries, "
                         "a CTA a block walking its four 16-step "
                         "sub-blocks, du summed in order",
                "earlier_ms": earlier,
                "bytes": nbytes, "flops": products + other,
                "products": products, "bound_ms": bound_ms,
                "bound_by": bound_by}

    def ssd_bwd_case(B, T, H, P, G, N, dtype, dA_share=1.0):
        """K4's backward kernel alone, y's cotangent only (as a training
        step), against autograd through the plain chunked forward on
        float32 copies of the same tensors under the scans' gradient
        gates, each gradient in its input's dtype (the reference's
        rounded once), dA within ``dA_share`` of its gate, two launches
        equal bit for bit (no atomics); timed beside its plain version,
        ``ref.mamba2_ssd_chunked_backward``."""
        from repro_torch.kernels.mamba2_ssd import mamba2_ssd_backward_cuda
        x, dt, A, Bm, Cm, D, _ = ssd_inputs(rng, B, T, H, P, G, N, dtype)
        dy = torch.from_numpy(rng.standard_normal((B, T, H, P)).astype(
            np.float32)).cuda().to(dtype)
        chunk = min(128, max(T, 8))

        def kernel():
            return mamba2_ssd_backward_cuda(x, dt, A, Bm, Cm, D, None, dy,
                                            None)[:6]

        def plain():
            return ref.mamba2_ssd_chunked_backward(
                x, dt, A, Bm, Cm, D, None, dy, None, chunk=chunk)[:6]

        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        # autograd on float32 copies, each gradient rounded to its input's
        # dtype once (the plain forward casts a bfloat16 x once a use, so
        # autograd through it would round dx twice)
        leaves = [t.detach().float().requires_grad_()
                  for t in (x, dt, A, Bm, Cm, D)]
        want = [g.to(t.dtype) for g, t in zip(torch.autograd.grad(
            ref.mamba2_ssd_chunked(*leaves, chunk=chunk)[0], leaves,
            dy.float()), (x, dt, A, Bm, Cm, D))]
        del leaves
        what = f"K4 backward kernel alone {(B, T, H, P)} {str(dtype)[6:]}"
        err, shares = 0.0, {}
        for name, g, wt, t in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got,
                                  want, (x, dt, A, Bm, Cm, D)):
            top = float(wt.float().abs().max())
            rtol = SCAN_GRAD_BF16_RTOL if g.dtype == torch.bfloat16 else 0.0
            gate = SCAN_GRAD_TOL * max(top, 1e-30)
            err = max(err, held(
                f"{what}: {name} against autograd through the plain forward",
                (g,), (wt,), gate, rtol))
            # the share of its gate the gradient takes (dA's the least
            # margin of the card's checks)
            shares[name] = float(((g.float() - wt.float()).abs() -
                                  rtol * wt.float().abs()).max()) / gate
            check(g.dtype == t.dtype, f"{what}: {name} in its input's "
                  f"{t.dtype} ({g.dtype})")
        print(f"  {what}: share of each gate " + ", ".join(
            f"{k} {v:.4f}" for k, v in shares.items()), flush=True)
        check(shares["dA"] <= dA_share, f"{what}: dA takes "
              f"{shares['dA']:.4f} of its gate, at most {dA_share}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{what}: two launches give equal bits")
        del want, again
        plain_err = max(float((g.float() - p.float()).abs().max())
                        for g, p in zip(got, plain()))
        print(f"  {what}: against its plain version {plain_err:.4g}",
              flush=True)
        nbytes, products, other = ssd_bwd_work(B, T, H, P, G, N,
                                               x.element_size())
        bound_ms, bound_by = bound(nbytes, products, other, dtype)
        split = launch_split(kernel)
        print(f"  {what}: by launch (warm) " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in split.items()), flush=True)
        return {"kernel": "mamba2_ssd_backward", "shape": [B, T, H, P],
                "G": G, "N": N, "dtype": str(dtype), "max_abs_err": err,
                "max_abs_err_vs_plain": plain_err,
                "gate_share": shares,
                "ms": time_ms(kernel, flush),
                "launch_ms": split,
                "plain_ms": time_ms(plain, flush, reps=3),
                "library_ms": None,
                "library_call": "none: no single PyTorch call computes "
                                "the SSD gradient",
                "route": ("mma.sync 3xTF32" if dtype == torch.float32 else
                          "mma.sync TF32, bf16 operands exact") +
                         ": persistent local and gradient passes over "
                         "(batch, 64-step block, 8-head slice) items, fed "
                         "by a producer warp's TMA copies, B, C and C B^T "
                         "once an item; a walk over the block boundaries; "
                         "slice and group sums in order",
                "bytes": nbytes, "flops": products + other,
                "products": products, "bound_ms": bound_ms,
                "bound_by": bound_by}

    entries["gaussian_blur"] = blur_case((32, 224, 224, 3), 9, 2.0)
    rows.append(entries["gaussian_blur"])
    rows.append(blur_case((1, 224, 224, 3), 9, 2.0))
    rows.append(blur_case((1, 250, 250, 3), 5, 1.5))
    rows.append(blur_case((1, 64, 64, 3), 5, 1.5))    # C1's IQ3, phase 10
    rows.append(blur_case((1, 1080, 1920, 3), 5, 1.5))
    # K1's general route: a window past 63 taps, and a halo of 2 x 64
    # floats a side (ksize 5 over a 64-channel feature map)
    rows.append(blur_case((1, 250, 250, 3), 99, 0.0))
    rows.append(blur_case((1, 224, 224, 64), 5, 1.5))
    # K1 at every shape and window that phase 21's benches give it
    for shape, ksize, sigma in BENCH_BLURS:
        rows.append(blur_case(shape, ksize, sigma))
    # K2 at the device backend's batch of 32, at one image (the pow-2
    # padded partial batch), a 1080p frame to 224 with lanczos3 (29 and 52
    # taps a window), 8 channels, and the 1080p frame to 8 x 8 (windows of
    # 1,440 columns: the wide route)
    entries["fused_resize_crop_normalize"] = preprocess_case(
        (32, 250, 250, 3), K2_MAIN)
    rows.append(entries["fused_resize_crop_normalize"])
    rows.append(preprocess_case((1, 250, 250, 3), K2_MAIN))
    rows.append(preprocess_case((1, 1080, 1920, 3), K2_1080P))
    rows.append(preprocess_case((4, 250, 250, 8), K2_MAIN))
    rows.append(preprocess_case((1, 1080, 1920, 3), K2_WIDE))
    rows.append(preprocess_case((8, 72, 72, 3), K2_FUSED_ARM))  # phase 21a
    # K4 at launch.model_serve's prefill shape (16 x 512 tokens, zamba2's
    # 80 heads of 64, state 64, one group), the model UDF's 3-token
    # prompts, grouped B/C, and bfloat16
    entries["mamba2_ssd"] = ssd_case(16, 512, 80, 64, 1, 64)
    rows.append(entries["mamba2_ssd"])
    rows.append(ssd_case(16, 3, 80, 64, 1, 64))
    rows.append(ssd_case(16, 512, 80, 64, 8, 64))
    rows.append(ssd_case(16, 512, 80, 64, 1, 64, torch.bfloat16))
    # K5 at launch.model_serve's prefill shape (16 x 512 tokens, rwkv6's
    # 32 heads of 64, chunk 64), bfloat16 r/k/v with float32 w, the model
    # UDF's 3-token prompts, and decays of log w about -8 a step against
    # the sequential scan (an overflowing factored decay shows there)
    entries["rwkv6_scan"] = wkv_case(16, 512, 32, 64)
    rows.append(entries["rwkv6_scan"])
    rows.append(wkv_case(16, 512, 32, 64, torch.bfloat16))
    rows.append(wkv_case(8, 3, 32, 64))
    rows.append(wkv_case(16, 512, 32, 64, shift=STRONG_DECAY_SHIFT,
                         plain=ref.rwkv6_scan_ref, timed=False,
                         what=" strong decay"))
    # lengths across the kernel's 16-step sub-chunks
    for T in (16, 17, 33):
        rows.append(wkv_case(8, T, 32, 64, timed=False))
    # K3 at the long-context prefill (4 x 4096 rows of qwen3's 16 heads of
    # 128 against a 4113-slot cache of 8 kv heads), in bfloat16, a
    # 512-row prefill at q_offset 3584 into that cache, a non-causal case
    # and lengths that are no multiple of the 64-row tile
    entries["flash_attention"] = attn_case(4, 4096, 4113, 16, 8, 128,
                                           library=True)
    rows.append(entries["flash_attention"])
    rows.append(attn_case(4, 4096, 4113, 16, 8, 128, dtype=torch.bfloat16,
                          library=True))
    rows.append(attn_case(4, 512, 4113, 16, 8, 128, q_offset=3584,
                          library=True))
    rows.append(attn_case(2, 64, 192, 6, 2, 32, causal=False))
    rows.append(attn_case(1, 100, 100, 2, 1, 64))
    rows.append(attn_case(2, 1100, 1105, 4, 2, 16))
    # K3 at zamba2-2.7b's attention past 1024 slots (phase 6): a prefill
    # of 2 x 1,536 rows of 32 heads of 80 into a 1,553-slot cache, in
    # float32 (the model's route) and bfloat16 (tiles padded to 128)
    rows.append(attn_case(2, 1536, 1553, 32, 32, 80, library=True))
    rows.append(attn_case(2, 1536, 1553, 32, 32, 80, dtype=torch.bfloat16,
                          library=True))
    # K3 on phase 12's whisper-small prefill (16 requests, 12 heads of
    # 64): the encoder's self-attention over 1,500 frames and the
    # decoder's cross-attention of 32 rows against them, neither causal,
    # both ending in a partial 64-row tile; phase 11's granite-moe past
    # 1024 slots (2 x 1,536 rows, GQA 16/8 at head dim 64, into the
    # 1,553-slot cache that run allocates, a partial last key tile); and
    # phase 13's internvl2-1b prefill (4 x 1,280 rows, GQA 14/2, into
    # 1,297 slots)
    rows.append(attn_case(16, 1500, 1500, 12, 12, 64, causal=False,
                          library=True))
    rows.append(attn_case(16, 32, 1500, 12, 12, 64, causal=False,
                          library=True))
    rows.append(attn_case(2, 1536, 1553, 16, 8, 64, library=True))
    rows.append(attn_case(4, 1280, 1297, 14, 2, 64, library=True))
    # phase 14's granite-8b prefill past 1024 slots (2 x 1,536 rows, GQA
    # 32/8 at head dim 128, into 1,553 slots, a partial last key tile)
    rows.append(attn_case(2, 1536, 1553, 32, 8, 128, library=True))
    # phase 23's qwen1.5-32b prefill past 1024 slots (2 x 1,536 rows, 40
    # heads of 128, MHA, into 1,553 slots): its float32 queries run the
    # kernel in float32 against the bfloat16 cache and the float8 one
    rows.append(attn_case(2, 1536, 1553, 40, 40, 128, library=True))
    # the training slice (phase 15): minicpm-2b's attention (1 x 4,096
    # rows, 36 heads of 64, MHA) on K3's bfloat16 route, K3 alone at
    # qwen3-0.6b's microbatch (2 x 4,096, GQA 16/8 at D 128, float32),
    # and the forward + recomputing backward at qwen3-0.6b's microbatch
    # and minicpm-2b's (bfloat16)
    rows.append(attn_case(1, 4096, 4096, 36, 36, 64, dtype=torch.bfloat16,
                          library=True))
    rows.append(attn_case(2, 4096, 4096, 16, 8, 128, library=True))
    rows.append(attn_grad_case(2, 4096, 16, 8, 128, torch.float32,
                               {"mma.sync backward kernel": 14.390976,
                                "torch.einsum backward": 25.818064}))
    rows.append(attn_grad_case(1, 4096, 36, 36, 64, torch.bfloat16,
                               19.220528))
    # the backward kernel alone at qwen3-0.6b's microbatch (float32) and
    # minicpm-2b's (bfloat16), against the backward's bound
    entries["flash_attention_backward"] = attn_bwd_case(
        2, 4096, 16, 8, 128, torch.float32,
        {"mma.sync backward kernel": 11.226624})
    rows.append(entries["flash_attention_backward"])
    rows.append(attn_bwd_case(1, 4096, 36, 36, 64, torch.bfloat16))
    # the scans' training slice (phase 16): K4 forward + backward at
    # zamba2-2.7b's microbatch (1 x 4,096, 80 heads of 64, one group of
    # state 64, float32), K5 at rwkv6-1.6b's (2 x 4,096, 32 heads of 64)
    # in bfloat16 (its training dtype) and float32, and K3 forward +
    # backward at zamba2's shared attention (1 x 4,096, 32 heads of 80,
    # float32)
    rows.append(scan_grad_case("mamba2_ssd", (1, 4096, 80, 64, 1, 64),
                               torch.float32,
                               {"the recomputing backward, run 2": 47.499216,
                                "the recomputing backward, run 1": 50.252144}))
    # K4's backward kernel alone at zamba2-2.7b's microbatch, in float32
    # (its training dtype) and bfloat16; float32's dA, the least margin of
    # the card's checks, within 0.85 of its gate
    entries["mamba2_ssd_backward"] = ssd_bwd_case(1, 4096, 80, 64, 1, 64,
                                                  torch.float32,
                                                  dA_share=0.85)
    rows.append(entries["mamba2_ssd_backward"])
    rows.append(ssd_bwd_case(1, 4096, 80, 64, 1, 64, torch.bfloat16))
    rows.append(scan_grad_case("rwkv6_scan", (2, 4096, 32, 64),
                               torch.bfloat16,
                               {"PR 20, call 1": 133.845566,
                                "PR 20, call 2": 182.965004}))
    rows.append(scan_grad_case("rwkv6_scan", (2, 4096, 32, 64),
                               torch.float32,
                               {"PR 20, call 1": 136.6,
                                "PR 20, call 2": 140.7}))
    # K5's backward kernel alone at rwkv6-1.6b's microbatch, in bfloat16
    # (its training dtype) and float32, then K5's forward alone at the
    # same shape in bfloat16, which phase 16c launches 192 times
    entries["rwkv6_scan_backward"] = wkv_bwd_case(
        2, 4096, 32, 64, torch.bfloat16,
        {"fp32 FMA walks over every step": 2.857168})
    rows.append(entries["rwkv6_scan_backward"])
    rows.append(wkv_bwd_case(
        2, 4096, 32, 64, torch.float32,
        {"fp32 FMA walks over every step": 2.5612}))
    rows.append(wkv_case(2, 4096, 32, 64, torch.bfloat16))
    rows.append(attn_grad_case(1, 4096, 32, 32, 80, torch.float32,
                               {"mma.sync backward kernel": 8.668752,
                                "torch.einsum backward": 20.554751}))
    # K4's forward alone at phase 16's training shape (1 x 4,096, 80
    # heads of 64), then the shapes each rank of phase 18 launches
    # (model_par=2): qwen3-0.6b's prefill (2 x 1,536 rows, 8 q and 4 kv
    # heads of 128; the cache split by slots, so the keys are the new
    # prefix), zamba2-2.7b's shared attention (16 heads of 80) and SSD
    # (40 heads), rwkv6-1.6b's WKV (4 x 512, 16 heads), granite-moe's
    # attention (8 and 4 heads of 64), qwen3's train step (1 x 2,048:
    # K3 forward, then forward + recomputing backward) and zamba2's
    # prefill into a cache split by heads (1 x 1,536 rows, 1,537 slots)
    rows.append(ssd_case(1, 4096, 80, 64, 1, 64))
    rows.append(attn_case(2, 1536, 1536, 8, 4, 128, library=True))
    rows.append(attn_case(2, 1536, 1536, 16, 16, 80, library=True))
    rows.append(ssd_case(2, 1536, 40, 64, 1, 64))
    rows.append(wkv_case(4, 512, 16, 64))
    rows.append(attn_case(2, 1536, 1536, 8, 4, 64, library=True))
    rows.append(attn_case(1, 2048, 2048, 8, 4, 128, library=True))
    rows.append(attn_grad_case(1, 2048, 8, 4, 128, torch.float32,
                               {"mma.sync backward kernel": 2.187552,
                                "torch.einsum backward": 3.339664}))
    rows.append(attn_case(1, 1536, 1537, 16, 16, 80, library=True))
    # the shapes phase 19b's cells launch: qwen3-0.6b's train cell (2 x
    # 4,096 rows, GQA 16/8 at D 128, causal) on K3's bfloat16 route and
    # the backward kernel's, and rwkv6-1.6b's prefill cell (4 x 4,096, 32
    # heads of 64) on K5's
    rows.append(attn_case(2, 4096, 4096, 16, 8, 128, dtype=torch.bfloat16,
                          library=True))
    rows.append(attn_bwd_case(2, 4096, 16, 8, 128, torch.bfloat16))
    rows.append(wkv_case(4, 4096, 32, 64, torch.bfloat16))
    for r in rows:
        r.setdefault("route", "fp32 FMA")
        print("  " + json.dumps({k: r.get(k) for k in (
            "shape", "dtype", "route", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}), flush=True)
    rows.append(ssd_model_layout())
    rows.append(wkv_carry(16, 512, 32, 64, 200))
    return entries, rows


def kernels_line(entries, path_launches):
    """The ``{"kernels": [...]}`` entries: each kernel's phase-5 row at
    its main shape, with its launches on the path that runs it.  The
    line's ``bound_by`` has two values, ``bytes`` or ``operations``
    (products or other); the phase-5 row names which."""
    meta = {
        "gaussian_blur": ("src/repro_torch/kernels/csrc/gaussian_blur.cu",
                          "src/repro/kernels/gaussian_blur.py:44"),
        "fused_resize_crop_normalize": (
            "src/repro_torch/kernels/csrc/preprocess.cu",
            "src/repro/kernels/preprocess.py:79"),
        "mamba2_ssd": ("src/repro_torch/kernels/csrc/mamba2_ssd.cu",
                       "src/repro/kernels/mamba2_ssd.py:68"),
        # autodiff of the reference's chunked form: no Pallas kernel
        "mamba2_ssd_backward": (
            "src/repro_torch/kernels/csrc/mamba2_ssd_bwd.cu",
            "src/repro/kernels/ref.py:316"),
        "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                       "src/repro/kernels/rwkv6_scan.py:78"),
        # autodiff of the reference's chunked form: no Pallas kernel
        "rwkv6_scan_backward": (
            "src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
            "src/repro/kernels/ref.py:232"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:77"),
        # the reference's _bwd: jnp, no Pallas kernel
        "flash_attention_backward": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_vjp.py:106"),
    }
    kernels = []
    for name, e in entries.items():
        source, replaces = meta[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[name],
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": "bytes" if e["bound_by"] == "bytes" else "operations",
            "design": e["route"],
            "library_ms": e["library_ms"],
            "library_call": e["library_call"], "shape": e["shape"]})
    return kernels


def model_inputs(cfg, batch, seed, device):
    """The inputs besides tokens that ``cfg`` asks for, seeded: a
    vit_stub model's patch embeddings, an encoder-decoder's frames."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "vit_stub":
        out["patch_embeds"] = (batch, cfg.num_patches, cfg.d_model)
    if cfg.is_encoder_decoder:
        out["frames"] = (batch, cfg.encoder_seq_len, cfg.d_model)
    return {k: torch.from_numpy((rng.standard_normal(shape) * 0.1)
                                .astype(np.float32)).to(device)
            for k, shape in out.items()}


def consistency_check(api, params, cfg, shape, device):
    """Prefill + decode logits against the no-cache forward over
    ``shape`` = (batch, prompt, decode steps), held to MODEL_TOL (with
    seeded frames or patch embeddings where ``cfg`` takes them; a
    vit_stub model's tokens sit behind its patches)."""
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.models.registry import token_start
    batch, S, extra = shape
    P = token_start(cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (batch, S + extra)).astype(np.int32)).to(device)
    inputs = model_inputs(cfg, batch, 3, device)
    with torch.no_grad():
        full, _ = api.forward(params, {"tokens": toks, **inputs}, REPLICATED)
        lg, cache = api.prefill(params, {"tokens": toks[:, :S], **inputs},
                                REPLICATED, P + S + extra + 1)
        errs = [float((lg - full[:, P + S - 1]).abs().max())]
        for i in range(extra):
            lg, cache = api.decode_step(params, toks[:, S + i:S + i + 1],
                                        cache, P + S + i, REPLICATED)
            errs.append(float((lg - full[:, P + S + i]).abs().max()))
    finite = bool(torch.isfinite(full).all())
    out = {"shape": list(shape), "max_abs_err": max(errs), "per_step": errs,
           "logit_absmax": float(full.abs().max())}
    print(f"  prefill of {batch} x {S} + {extra} decode steps vs forward: "
          f"max_abs_err {max(errs):.3g} (logits up to "
          f"{float(full.abs().max()):.3g})", flush=True)
    check(finite and full.shape == (batch, P + S + extra, cfg.padded_vocab),
          f"forward logits finite, shape ({batch}, {P + S + extra}, padded "
          "vocab)")
    check(max(errs) <= MODEL_TOL,
          f"prefill/decode logits vs forward: {max(errs):.3g} <= {MODEL_TOL}")
    return out


def serve_once(arch, reduced, requests, prompt_len, gen, device, vocab,
               params=None):
    """``model_serve.run`` once; its walls in ms and whether its tokens
    have the expected shape and lie inside the vocabulary."""
    from repro_torch.launch import model_serve
    r = model_serve.run(arch, reduced=reduced, requests=requests,
                        prompt_len=prompt_len, gen=gen, device=device,
                        params=params)
    gen_toks = r.pop("generated")
    r.pop("logits")
    r["generated_ok"] = bool(gen_toks.shape == (requests, gen)
                             and (gen_toks >= 0).all()
                             and (gen_toks < vocab).all())
    r["prefill_ms"], r["decode_ms"] = r["prefill_s"] * 1e3, r["decode_s"] * 1e3
    check(r["generated_ok"], f"generated tokens: shape ({requests}, {gen}), "
          "inside the vocabulary")
    return r


def no_drop_moe(arch, reduced=False) -> dict:
    """The capacity factor E/K at which a MoE drops no token: each expert
    then has a slot for every token of the batch."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch, reduced=reduced)
    return {"moe_capacity_factor": cfg.num_experts / cfg.num_experts_per_tok}


def phase_model(launches, arch=ARCH, kernel="mamba2_ssd", phase=6,
                device="cuda", reduced=False, requests=16, prompt_len=512,
                gen=16, consistency=(2, 16, 4), n_images=16, beyond=None,
                check_cfg=None):
    """A model path: ``launch.model_serve.run`` (cold, then warm), prefill
    + decode against the no-cache forward over ``consistency`` = (batch,
    prompt, decode steps), and, when ``n_images`` is not 0, the model UDF
    through the engine arms the JAX package registers for the arch,
    counting ``kernel``'s launches in each.  ``beyond`` = (batch, prompt,
    decode steps), with prompt + steps past 1024 cache slots, serves and
    checks that much on the same weights, where attention takes the
    flash route (K3), and counts K3's and ``kernel``'s launches there.
    ``check_cfg`` (a dict of config fields) runs the prefill/decode
    checks on a copy of the config with those fields replaced, on the
    same weights.  ``device`` and ``reduced`` let a host without a card
    rehearse it."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_leaves
    cfg = get_arch(arch, reduced=reduced)
    on_card = device == "cuda"
    print(f"phase {phase}: model path, {cfg.name} ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.param_count() / 1e9:.3f} B params "
          "by the configs' formula)", flush=True)
    out = {"arch": cfg.name, "params": cfg.param_count()}
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # -- the launcher: prefill + decode, twice (the first pays set-up)
    serve = []
    for run_i in range(2):
        before = launches[kernel].count
        r = serve_once(arch, reduced, requests, prompt_len, gen, device,
                       cfg.vocab_size)
        r["kernel_launches"] = launches[kernel].count - before
        serve.append(r)
        print(f"  model_serve {'cold' if run_i == 0 else 'warm'}: "
              f"{requests} x {prompt_len} tokens, prefill "
              f"{r['prefill_ms']:.3f} ms, {gen} decode steps "
              f"{r['decode_ms']:.3f} ms, {r['tokens_per_s']:.3f} tokens/s, "
              f"{kernel} launches {r['kernel_launches']}", flush=True)
    out["serve"] = serve

    # -- prefill + decode against the no-cache forward
    api = get_model(cfg.replace(**(check_cfg or {})))
    if check_cfg:
        print(f"  the checks run on the config with {check_cfg}", flush=True)
    params = api.init(torch.Generator(device=device).manual_seed(1))
    out["tree_params"] = sum(t.numel() for t in tree_leaves(params))
    print(f"  the parameter tree holds {out['tree_params']} values "
          f"({cfg.param_count()} by the configs' formula)", flush=True)
    out["forward_consistency"] = consistency_check(api, params, cfg,
                                                   consistency, device)
    if beyond:
        batch, S, extra = beyond
        print(f"  past 1024 slots: {batch} x {S} tokens + {extra} "
              f"({S + extra + 1} slots), the same weights", flush=True)
        before = {k: c.count for k, c in launches.items()}
        r = serve_once(arch, reduced, batch, S, extra, device,
                       cfg.vocab_size, params=params)
        print(f"  model_serve: prefill {r['prefill_ms']:.3f} ms, {extra} "
              f"decode steps {r['decode_ms']:.3f} ms, "
              f"{r['tokens_per_s']:.3f} tokens/s", flush=True)
        r["forward_consistency"] = consistency_check(api, params, cfg,
                                                     beyond, device)
        r["launches"] = {k: c.count - before[k] for k, c in launches.items()}
        print(f"  launches past 1024 slots: {r['launches']}", flush=True)
        for name in ("flash_attention", kernel):
            check(not on_card or r["launches"][name] > 0,
                  f"{name} launched past 1024 slots "
                  f"({r['launches'][name]})")
        out["beyond_1024"] = r
    del params

    if n_images:
        out.update(_model_udf_arms(launches, arch, kernel, device, reduced,
                                   n_images))
    if on_card:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {out['peak_memory_bytes'] / 2**30:.3f} "
              "GiB", flush=True)
    return out


def _model_udf_arms(launches, arch, kernel, device, reduced, n_images):
    """The model UDF through the engine arms of the routes that
    ``register_model_udf`` registered for ``arch`` (the batcher and
    device arms where it registered a batched or a device route, the
    per-entity arm where its per-entity route answers an image alone),
    which must stamp identical labels.  An encoder-decoder's per-entity
    route must raise ``KeyError('frames')``, as the JAX package's does.
    A vit_stub model's labels must also equal those of
    ``greedy_generate`` called on the same prompts: a wiring check of
    the engine's path (the UDF generates through ``greedy_generate``
    itself), not a check of the model."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.remote import TransportModel
    from repro_torch.core.udf import (get_udf, has_batched_udf,
                                      has_device_udf, patch_embeds,
                                      prompt_tokens, register_model_udf,
                                      unregister_udf)
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.models import get_model
    from repro_torch.serving.serve_step import greedy_generate
    from repro_torch.visual.font import draw_text
    on_card = device == "cuda"
    cfg = get_arch(arch, reduced=reduced)
    api = get_model(cfg)
    # the UDF's own seeded init, kept here for the direct generation
    params = api.init(torch.Generator(device=device).manual_seed(0))
    register_model_udf(MODEL_UDF, arch=arch, reduced=reduced, device=device,
                       params=params)
    query = find("lm", [{"type": "udf", "options": {"id": MODEL_UDF}}])
    rng = np.random.default_rng(11)    # fill()'s images, in fill()'s order
    images = [torch.from_numpy(rng.uniform(0, 1, (32, 32, 3))
                               .astype(np.float32)) for _ in range(n_images)]
    transport = TransportModel(network_latency_s=0.001, service_time_s=0.001)
    responses, out = {}, {"arms": {}}
    try:
        try:
            get_udf(MODEL_UDF)(images[0].to(device))
            raised = None
        except KeyError as e:
            raised = e
        check(raised is None if not cfg.is_encoder_decoder
              else raised is not None and raised.args == ("frames",),
              "the per-entity route answers an image alone, or raises "
              "KeyError('frames') for an encoder-decoder, as the JAX "
              "package's does")
        off = {"native": 10.0, "remote": 10.0}
        arms = {}
        if raised is None:
            arms["per_entity"] = dict(dispatch="native")
        if has_batched_udf(MODEL_UDF):
            arms["batcher"] = dict(dispatch="cost", cost_overrides={
                MODEL_UDF: {**off, "batcher": 1e-6}})
        if has_device_udf(MODEL_UDF):
            arms["device_backend"] = dict(
                dispatch="cost", device_backend=True if on_card else device,
                cost_overrides={MODEL_UDF: {**off, "batcher": 10.0,
                                            "device": 1e-6}})
        out["registered_arms"] = list(arms)
        for arm, kw in arms.items():
            eng = VDMSAsyncEngine(device=device, num_remote_servers=1,
                                  transport=transport, **kw)
            try:
                fill(eng, n_images, 32, "lm")
                before = launches[kernel].count
                res, dt = run_query(eng, query)
                stats = eng.dispatch_stats()
            finally:
                eng.shutdown()
            responses[arm] = res["entities"]
            out["arms"][arm] = {
                "query": dt, "placements": stats.get("placements"),
                "kernel_launches": launches[kernel].count - before}
            print(f"  {arm} arm: {n_images} images, {fmt(dt)}; placements "
                  f"{stats.get('placements')}; {kernel} launches "
                  f"{out['arms'][arm]['kernel_launches']}", flush=True)
        if cfg.frontend == "vit_stub":
            with torch.no_grad():
                direct = []
                for img in images:
                    dimg = img.to(device)
                    toks = greedy_generate(
                        api, params, {
                            "tokens": prompt_tokens(dimg, cfg.vocab_size)[None],
                            "patch_embeds": patch_embeds(dimg, cfg)[None]},
                        steps=4, sh=REPLICATED)
                    direct.append(int(toks[0, -1]) % 4)
    finally:  # free the model's parameters before the next phase
        unregister_udf(MODEL_UDF)
        del params
    # which image each response is (its bottom-right corner, which no
    # stamp reaches) and which label it carries: the stamp that
    # reproduces it; listed in fill()'s order
    first = next(iter(responses))
    names = ("WALK", "RUN", "JUMP", "SIT")
    labels = [None] * n_images
    for got in responses[first].values():
        got = np.asarray(got)
        i = next(j for j, img in enumerate(images)
                 if np.array_equal(img.numpy()[-8:, -8:], got[-8:, -8:]))
        diff = {lab: float(np.abs(draw_text(images[i], lab, 4, 4).numpy()
                                  - got).max()) for lab in names}
        labels[i] = min(diff, key=diff.get)
    out["labels"] = labels
    print(f"  labels ({first}): {labels}", flush=True)
    for arm in list(responses)[1:]:
        same = list(responses[arm]) == list(responses[first]) and all(
            np.array_equal(responses[arm][e], responses[first][e])
            for e in responses[first])
        check(same, f"{arm} arm stamps the {first} arm's labels exactly")
    if cfg.frontend == "vit_stub":
        check(labels == [names[t] for t in direct],
              "per-entity labels equal greedy_generate's on the same "
              "prompts")
    return out


# ------------------------------------------------- phases 9 and 10
def train_step_products(cfg, batch, seq) -> int:
    """Matrix-product operations of one remat training step over
    ``batch`` x ``seq`` tokens: each layer's weights 2 operations a
    token forward, 2 again when remat recomputes the layer and 4
    backward; the head 2 + 4 (not recomputed); attention 4D a visible
    pair and head forward, 4D recomputed and 10D backward; a scan's
    products per step (SSD's and WKV6's readout and update, 4NP or 4KV)
    forward, again recomputed, and 10NP or 10KV backward
    (:func:`ssd_grad_work`, :func:`wkv_grad_work`).  Dense blocks,
    zamba2's Mamba2 layers with its shared attention block at every
    application, rwkv6's time and channel mix."""
    from repro_torch.models.lm import family_kind, hybrid_shape
    d = cfg.d_model
    tokens = batch * seq
    pairs = visible_pairs(seq, seq, 0, True)
    head = 6 * tokens * d * cfg.padded_vocab
    kind = family_kind(cfg)
    if kind == "rwkv":
        f, L, Dl = cfg.d_ff, cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
        H, K = cfg.rwkv_nheads, cfg.rwkv_head_dim
        layer = 6 * d * d + 10 * d * L + 2 * d * Dl + 2 * d * f
        scan = 18 * K * K * H * tokens
        return 8 * tokens * layer * cfg.num_layers + head \
            + scan * cfg.num_layers
    hd = cfg.resolved_head_dim
    block = (2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
             + 3 * d * cfg.d_ff)
    attn = 18 * pairs * hd * cfg.num_heads * batch
    if kind == "tblock":
        return (8 * tokens * block * cfg.num_layers + head
                + attn * cfg.num_layers)
    di, N, G = cfg.mamba_d_inner, cfg.ssm_state, cfg.mamba_ngroups
    H, P = cfg.mamba_nheads, cfg.mamba_head_dim
    mamba = d * (2 * di + 2 * G * N + H) + di * d
    scan = 18 * N * P * H * tokens
    n_app, _ = hybrid_shape(cfg)
    return (8 * tokens * mamba * cfg.num_layers + scan * cfg.num_layers
            + n_app * (8 * tokens * block + attn) + head)


def backward_count(launches) -> int:
    """The backward kernel's launches so far, 0 where ``launches`` (a CPU
    rehearsal's) has no counter for it."""
    c = launches.get("flash_attention_backward")
    return c.count if c is not None else 0


def _train_run(label, launches, arch, device,
               kernels=("flash_attention", "flash_attention_backward"), **kw):
    """``launch.train.run`` once on the card: its step walls, tokens/s,
    peak device memory and the launches of each kernel, printed and
    returned; on the card each of ``kernels`` must have launched."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    before = {k: c.count for k, c in launches.items()}
    r = train.run(arch, device=device, log_every=1, **kw)
    r["launches"] = {k: c.count - before[k] for k, c in launches.items()}
    r["flash_launches"] = r["launches"]["flash_attention"]
    r["peak_memory_bytes"] = (torch.cuda.max_memory_allocated() if on_card
                              else 0)
    cfg = get_arch(arch, reduced=kw.get("reduced", True))
    tokens = kw["batch"] * kw["seq"]
    r["step_ms"] = [t * 1e3 for t in r["step_s"]]
    r["tokens_per_s"] = [tokens / t for t in r["step_s"]]
    products = train_step_products(cfg, kw["batch"], kw["seq"])
    r["bound_ms"] = products / PRODUCT_FLOP_S[
        "torch." + kw["compute_dtype"]] * 1e3
    counts = ", ".join(f"{k} {r['launches'].get(k, 0)}" for k in kernels)
    print(f"  {label}: steps from {r['start_step']}, losses {r['losses']}, "
          f"grad norms {r['grad_norms']}; step ms {r['step_ms']}; tokens/s "
          f"{r['tokens_per_s']}; peak device memory "
          f"{r['peak_memory_bytes'] / 2**30:.3f} GiB; launches {counts}; "
          f"least step time {r['bound_ms']:.3f} ms "
          f"({products / 1e12:.3f} TFLOP of products)", flush=True)
    check(all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]),
          f"{label}: finite losses and gradient norms (so every leaf's "
          "gradient norm is finite)")
    for k in kernels:
        check(not on_card or r["launches"].get(k, 0) > 0,
              f"{label}: {k} launched ({r['launches'].get(k, 0)})")
    return r


def moment_diff(a, b) -> float:
    """The largest elementwise difference of two moment trees (card and
    host), each leaf's over that leaf's largest magnitude: a wrong
    gradient on any one leaf shows, whatever its scale."""
    from repro_torch.models.lm import tree_leaves
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        y = y.float()
        x = x.to(y.device).float()
        top = float(y.abs().max())
        worst = max(worst, float((x - y).abs().max()) / max(top, 1e-30))
    return worst


def moment_rel_l2(a, b) -> tuple[float, float]:
    """The relative L2 difference ``|a - b| / |b|`` of two moment trees'
    ``embed`` leaf, and the largest of their other leaves'."""
    from repro_torch.models.lm import tree_leaves

    def rel(x, y):
        return float((x.double() - y.double()).norm() / y.double().norm())

    rest = [k for k in b if k != "embed"]
    return rel(a["embed"], b["embed"]), max(
        rel(x, y) for x, y in zip(tree_leaves({k: a[k] for k in rest}),
                                  tree_leaves({k: b[k] for k in rest})))


def phase_training(launches, device="cuda", reduced=False, seq=4096):
    """Phase 15: the training slice.  (a) one ``make_train_step`` step of
    qwen3-0.6b at full width cut to 2 layers, 1 x 1,536 tokens, float32
    compute and gradients, on the card and on the host from one state;
    (b) ``launch.train.run`` of qwen3-0.6b at full width, 4 x 4,096
    tokens as 2 microbatches of 2, float32: 3 steps straight, then 2
    steps saving a checkpoint and 3 steps resuming from it at step 2,
    whose third loss must be the straight run's; (c) 2 steps of
    minicpm-2b at full width, 1 x 4,096 tokens, bfloat16 compute, whose
    first loss must be ``model.loss`` of the float32 parameters on the
    same batch; (d) one step of minicpm-2b cut to 2 layers on that batch
    at the bfloat16 defaults against float32 compute from one state.
    ``device``, ``reduced`` and ``seq`` (of (b)–(d)) let a host without
    a card rehearse it."""
    import shutil
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.dataio import lm_token_stream
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.train_step import init_train_state
    out = {}

    # -- (a) card against host
    cfg = get_arch(LONG_ARCH, reduced).replace(num_layers=2)
    width = "reduced" if reduced else "full width"
    print(f"phase 15a: one train step of {cfg.name} at {width}, 2 layers, "
          "1 x 1,536 tokens, float32, on the card and on the host",
          flush=True)
    api = get_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=100,
                       compute_dtype="float32", grad_reduce_dtype="float32")
    step = make_train_step(api, tcfg, REPLICATED)
    host = init_train_state(api, torch.Generator().manual_seed(0))
    card = tree_map(lambda a: a.to(device, copy=True), host)
    toks = torch.from_numpy(lm_token_stream(1, 1536, cfg.vocab_size, 0))
    before = backward_count(launches), launches["flash_attention"].count
    t0 = time.perf_counter()
    card, mc = step(card, {"tokens": toks.to(device)})
    card_loss = float(mc["loss"])
    card_s = time.perf_counter() - t0
    k3 = launches["flash_attention"].count - before[1]
    k3b = backward_count(launches) - before[0]
    t0 = time.perf_counter()
    host, mh = step(host, {"tokens": toks})
    host_s = time.perf_counter() - t0
    lr, b1, eps = mh["lr"], tcfg.b1, tcfg.eps
    loss_rel = abs(card_loss / float(mh["loss"]) - 1)
    norm_rel = abs(float(mc["grad_norm"]) / float(mh["grad_norm"]) - 1)
    moment_rel = {k: moment_diff(card[k], host[k]) for k in ("m", "v")}
    dp_lr, excess = 0.0, 0.0
    for pc, ph, m_c, m_h in zip(*(tree_leaves(st[k]) for k, st in (
            ("params", card), ("params", host), ("m", card), ("m", host)))):
        dp = (pc.cpu() - ph).abs()
        allowed = lr * (1e-3 + (m_c.cpu() - m_h).abs() / ((1 - b1) * eps))
        dp_lr = max(dp_lr, float(dp.max()) / lr)
        excess = max(excess, float((dp - allowed).max()))
    out["card_vs_host"] = {
        "card_ms": card_s * 1e3, "host_ms": host_s * 1e3,
        "loss": [card_loss, float(mh["loss"])], "loss_rel": loss_rel,
        "grad_norm": [float(mc["grad_norm"]), float(mh["grad_norm"])],
        "grad_norm_rel": norm_rel, "max_param_diff_over_lr": dp_lr,
        "moment_diff_over_leaf_max": moment_rel, "flash_launches": k3}
    print(f"  card {card_s * 1e3:.3f} ms, host {host_s * 1e3:.3f} ms; loss "
          f"{card_loss} / {float(mh['loss'])} (rel {loss_rel:.3g}); grad norm "
          f"rel {norm_rel:.3g}; max |Δm|, |Δv| over the leaf's largest "
          f"{moment_rel['m']:.3g}, {moment_rel['v']:.3g}; max |Δparam| / lr "
          f"{dp_lr:.3g}; flash_attention launches {k3}", flush=True)
    check(device != "cuda" or k3 == 2 * cfg.num_layers, f"K3 launched forward and under remat in "
          f"every layer ({k3} == {2 * cfg.num_layers})")
    check(device != "cuda" or k3b == cfg.num_layers, "the backward kernel "
          f"launched once in every layer ({k3b} == {cfg.num_layers})")
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"card vs host loss: {loss_rel:.3g} <= {TRAIN_LOSS_RTOL}")
    check(norm_rel <= TRAIN_NORM_RTOL,
          f"card vs host grad norm: {norm_rel:.3g} <= {TRAIN_NORM_RTOL}")
    for k, d in moment_rel.items():
        check(d <= TRAIN_MOMENT_TOL[k], f"card vs host {k}, leaf by leaf: "
              f"{d:.3g} <= {TRAIN_MOMENT_TOL[k]} of the leaf's largest")
    check(excess <= 1e-7, "card vs host parameters within "
          f"lr (1e-3 + |Δm| / ((1 - b1) eps)) (+1e-7): excess {excess:.3g}")
    del card, host

    # -- (b) qwen3-0.6b at full width, straight and resumed
    print(f"phase 15b: launch.train.run {LONG_ARCH} at {width}, 4 x {seq} "
          "tokens as 2 microbatches, float32", flush=True)
    kw = dict(reduced=reduced, batch=4, seq=seq, microbatches=2,
              compute_dtype="float32")
    out["qwen3_straight"] = _train_run("straight, 3 steps", launches,
                                       LONG_ARCH, device, steps=3, **kw)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        out["qwen3_saved"] = _train_run(
            "2 steps, checkpoint at 2", launches, LONG_ARCH, device, steps=2,
            ckpt_dir=ckpt, save_every=2, **kw)
        out["qwen3_resumed"] = _train_run(
            "3 steps, resumed", launches, LONG_ARCH, device, steps=3,
            ckpt_dir=ckpt, save_every=2, **kw)
        out["qwen3_resume_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    r3 = out["qwen3_resumed"]
    check(r3["start_step"] == 2 and r3["steps"] == 1,
          f"the run resumed at step 2 ({r3['start_step']}) and ran 1 step")
    rel = abs(r3["losses"][0] / out["qwen3_straight"]["losses"][2] - 1)
    out["qwen3_resume_loss_rel"] = rel
    check(rel <= TRAIN_LOSS_RTOL, f"resumed step-3 loss vs the straight run's: "
          f"{rel:.3g} <= {TRAIN_LOSS_RTOL}")
    if device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()

    # -- (c) minicpm-2b at full width, bfloat16 compute
    print(f"phase 15c: launch.train.run {TRAIN_BF16_ARCH} at {width}, 1 x "
          f"{seq} tokens, bfloat16 compute", flush=True)
    kw = dict(reduced=reduced, batch=1, seq=seq, compute_dtype="bfloat16")
    r = _train_run("2 steps", launches, TRAIN_BF16_ARCH, device, steps=2, **kw)
    out["minicpm"] = r
    if device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    cfg = get_arch(TRAIN_BF16_ARCH, reduced)
    api = get_model(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in make_batch_fn(cfg, 1, seq)(0).items()}
    with torch.no_grad():
        want, _ = api.loss(params, batch, REPLICATED, remat=False)
    want = float(want)
    rel = abs(r["losses"][0] / want - 1)
    r["float32_loss"], r["loss_rel_vs_float32"] = want, rel
    print(f"  first step's loss {r['losses'][0]} against model.loss of the "
          f"float32 parameters {want}: rel {rel:.3g}", flush=True)
    check(rel <= TRAIN_BF16_LOSS_RTOL, f"bfloat16 step loss vs float32 "
          f"model.loss: {rel:.3g} <= {TRAIN_BF16_LOSS_RTOL}")
    del params

    # -- (d) the bfloat16 step's gradients against float32 compute: the
    # first loss is ln V whatever the precision, so hold what the
    # backward computes (the gradient norm and the first moments)
    cfg = cfg.replace(num_layers=2)
    print(f"phase 15d: one train step of {cfg.name} at {width}, 2 layers, 1 x "
          f"{seq} tokens, at the bfloat16 defaults and in float32, from one "
          "state", flush=True)
    api = get_model(cfg)
    f32 = init_train_state(api, torch.Generator(device=device).manual_seed(0))
    bf16 = tree_map(lambda a: a.clone(), f32)
    before = backward_count(launches), launches["flash_attention"].count
    bf16, mb = make_train_step(api, TrainConfig(), REPLICATED)(bf16, batch)
    f32, mf = make_train_step(api, TrainConfig(
        compute_dtype="float32", grad_reduce_dtype="float32"),
        REPLICATED)(f32, batch)
    k3 = launches["flash_attention"].count - before[1]
    k3b = backward_count(launches) - before[0]
    norm_rel = abs(float(mb["grad_norm"]) / float(mf["grad_norm"]) - 1)
    embed_rel, m_rel = moment_rel_l2(bf16["m"], f32["m"])
    out["minicpm_bf16_vs_f32"] = {
        "grad_norm": [float(mb["grad_norm"]), float(mf["grad_norm"])],
        "grad_norm_rel": norm_rel, "embed_m_rel_l2": embed_rel,
        "m_rel_l2": m_rel, "flash_launches": k3}
    print(f"  grad norm {float(mb['grad_norm'])} / {float(mf['grad_norm'])} "
          f"(rel {norm_rel:.3g}); |Δm| / |m| of the embedding {embed_rel:.3g}"
          f", of the worst other leaf {m_rel:.3g}; flash_attention launches "
          f"{k3}", flush=True)
    check(device != "cuda" or k3 == 4 * cfg.num_layers, "K3 launched forward "
          f"and under remat in every layer of both steps ({k3})")
    check(device != "cuda" or k3b == 2 * cfg.num_layers, "the backward "
          f"kernel launched once in every layer of both steps ({k3b})")
    check(norm_rel <= TRAIN_BF16_NORM_RTOL, f"bfloat16 vs float32 grad norm: "
          f"{norm_rel:.3g} <= {TRAIN_BF16_NORM_RTOL}")
    check(m_rel <= TRAIN_BF16_M_RTOL, f"bfloat16 vs float32 first moments, "
          f"leaf by leaf: {m_rel:.3g} <= {TRAIN_BF16_M_RTOL}")
    check(embed_rel <= TRAIN_BF16_EMBED_M_RTOL, "bfloat16 vs float32 first "
          f"moment of the embedding: {embed_rel:.3g} <= "
          f"{TRAIN_BF16_EMBED_M_RTOL}")
    del bf16, f32
    return out


def leaf_grads_from_m(m, b1) -> dict:
    """Each leaf's gradient norm after one step from zero moments, read
    from its first moment (m = (1 - b1) · clipped gradient), by path."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (k,), v)
        else:
            out["/".join(prefix)] = float(node.double().norm()) / (1 - b1)
    walk((), m)
    return out


def check_leaf_grads(label, norms, upstream) -> None:
    """Every leaf's gradient norm finite and none all zero, the leaves
    upstream of a scan named: a dropped gradient would leave them 0."""
    bad = {k: v for k, v in norms.items() if not math.isfinite(v)}
    zero = sorted(k for k, v in norms.items() if v == 0.0)
    ups = {k: v for k, v in norms.items()
           if any(k.endswith("/" + u) for u in upstream)}
    missing = [u for u in upstream
               if not any(k.endswith("/" + u) for k in norms)]
    print(f"  {label}: {len(norms)} leaves; upstream of the scan: "
          + ", ".join(f"{k} {v:.4g}" for k, v in sorted(ups.items())),
          flush=True)
    check(not bad, f"{label}: every leaf's gradient norm finite ({bad})")
    check(not zero, f"{label}: no leaf's gradient all zero ({zero})")
    check(not missing and all(v > 0 for v in ups.values()),
          f"{label}: the {len(ups)} leaves upstream of the scan have "
          f"gradients (missing: {missing})")


SSD_UPSTREAM = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D")
WKV_UPSTREAM = ("w_r", "w_k", "w_v", "decay_base", "decay_w1", "decay_w2",
                "u", "mix_w1", "mix_w2", "mu", "mu_base")


def phase_scan_training(launches, device="cuda", reduced=False, seq=4096,
                        host_seq=1536):
    """Phase 16: the hybrid and rwkv families in training, K4 and K5
    under their autograd Functions.  (a) one ``make_train_step`` step of
    zamba2-2.7b at full width cut to 2 hybrid groups (12 layers), 1 x
    ``host_seq`` tokens, float32 compute and gradients, on the card and
    on the host from one state (loss, gradient norm, each leaf's largest
    |Δparam|, the moments), each leaf's gradient on the card finite and
    not all zero; (b) ``launch.train.run`` of zamba2-2.7b at full width,
    1 x ``seq`` tokens, float32: 2 steps; (c) the same for rwkv6-1.6b at
    full width, 4 x ``seq`` as 2 microbatches of 2, bfloat16 compute;
    (d) one step of rwkv6-1.6b cut to 2 layers at the bfloat16 defaults,
    1 x ``seq``, each leaf's gradient finite and not all zero; (e) one
    ``make_train_step`` step of rwkv6-1.6b at full width cut to 2 layers,
    1 x ``host_seq`` tokens, float32, on the card and on the host from
    one state (loss and gradient norm), K5's backward kernel against its
    plain version.  On the card K5's backward kernel launches once a
    layer and microbatch.  ``device``, ``reduced``, ``seq`` and
    ``host_seq`` let a host without a card rehearse it."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.dataio import lm_token_stream
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.train_step import init_train_state
    out = {}
    width = "reduced" if reduced else "full width"

    # -- (a) card against host
    cfg = get_arch(ARCH, reduced)
    cfg = cfg.replace(num_layers=2 * cfg.shared_attn_every)
    print(f"phase 16a: one train step of {cfg.name} at {width}, 2 hybrid "
          f"groups ({cfg.num_layers} layers), 1 x {host_seq} tokens, "
          "float32, on the card and on the host", flush=True)
    api = get_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=100,
                       compute_dtype="float32", grad_reduce_dtype="float32")
    step = make_train_step(api, tcfg, REPLICATED)
    host = init_train_state(api, torch.Generator().manual_seed(0))
    card = tree_map(lambda a: a.to(device, copy=True), host)
    toks = torch.from_numpy(lm_token_stream(1, host_seq, cfg.vocab_size, 0))
    before = {k: c.count for k, c in launches.items()}
    t0 = time.perf_counter()
    card, mc = step(card, {"tokens": toks.to(device)})
    card_loss = float(mc["loss"])
    card_s = time.perf_counter() - t0
    counts = {k: c.count - before[k] for k, c in launches.items()}
    t0 = time.perf_counter()
    host, mh = step(host, {"tokens": toks})
    host_s = time.perf_counter() - t0
    lr, b1, eps = mh["lr"], tcfg.b1, tcfg.eps
    loss_rel = abs(card_loss / float(mh["loss"]) - 1)
    norm_rel = abs(float(mc["grad_norm"]) / float(mh["grad_norm"]) - 1)
    moment_rel = {k: moment_diff(card[k], host[k]) for k in ("m", "v")}
    dp_leaf, excess = {}, 0.0
    paths = list(leaf_grads_from_m(host["m"], b1))
    for path, pc, ph, m_c, m_h in zip(paths, *(tree_leaves(st[k]) for k, st
                                               in (("params", card),
                                                   ("params", host),
                                                   ("m", card),
                                                   ("m", host)))):
        dp = (pc.cpu() - ph).abs()
        allowed = lr * (1e-3 + (m_c.cpu() - m_h).abs() / ((1 - b1) * eps))
        dp_leaf[path] = float(dp.max()) / lr
        excess = max(excess, float((dp - allowed).max()))
    norms = leaf_grads_from_m(card["m"], b1)
    out["card_vs_host"] = {
        "card_ms": card_s * 1e3, "host_ms": host_s * 1e3,
        "loss": [card_loss, float(mh["loss"])], "loss_rel": loss_rel,
        "grad_norm": [float(mc["grad_norm"]), float(mh["grad_norm"])],
        "grad_norm_rel": norm_rel, "max_param_diff_over_lr": dp_leaf,
        "moment_diff_over_leaf_max": moment_rel, "launches": counts,
        "leaf_grad_norms": norms}
    print(f"  card {card_s * 1e3:.3f} ms, host {host_s * 1e3:.3f} ms; loss "
          f"{card_loss} / {float(mh['loss'])} (rel {loss_rel:.3g}); grad norm "
          f"rel {norm_rel:.3g}; max |Δm|, |Δv| over the leaf's largest "
          f"{moment_rel['m']:.3g}, {moment_rel['v']:.3g}; launches "
          f"{counts}", flush=True)
    print("  max |Δparam| / lr per leaf: " + ", ".join(
        f"{k} {v:.3g}" for k, v in dp_leaf.items()), flush=True)
    n_app = cfg.num_layers // cfg.shared_attn_every
    if device == "cuda":
        check(counts["mamba2_ssd"] == 2 * cfg.num_layers,
              "K4 launched forward and under remat in every Mamba2 layer "
              f"({counts['mamba2_ssd']} == {2 * cfg.num_layers})")
        nb = counts.get("mamba2_ssd_backward", 0)
        check(nb == cfg.num_layers, "K4's backward kernel launched once in "
              f"every Mamba2 layer ({nb} == {cfg.num_layers})")
        check(host_seq <= 1024 or counts["flash_attention"] == 2 * n_app,
              "K3 launched forward and under remat at every shared-block "
              f"application ({counts['flash_attention']} == {2 * n_app})")
        nb = counts.get("flash_attention_backward", 0)
        check(host_seq <= 1024 or nb == n_app, "the backward kernel "
              f"launched once at every shared-block application ({nb} == "
              f"{n_app})")
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"card vs host loss: {loss_rel:.3g} <= {TRAIN_LOSS_RTOL}")
    check(norm_rel <= TRAIN_NORM_RTOL,
          f"card vs host grad norm: {norm_rel:.3g} <= {TRAIN_NORM_RTOL}")
    check(excess <= 1e-7, "card vs host parameters within "
          f"lr (1e-3 + |Δm| / ((1 - b1) eps)) (+1e-7): excess {excess:.3g}")
    check_leaf_grads("16a on the card", norms, SSD_UPSTREAM)
    del card, host

    # -- (b) zamba2-2.7b at full width, float32
    print(f"phase 16b: launch.train.run {ARCH} at {width}, 1 x {seq} "
          "tokens, float32", flush=True)
    out["zamba2"] = _train_run(
        "2 steps", launches, ARCH, device, steps=2, reduced=reduced,
        batch=1, seq=seq, compute_dtype="float32",
        kernels=("mamba2_ssd", "mamba2_ssd_backward", "flash_attention",
                 "flash_attention_backward"))
    nb, layers = out["zamba2"]["launches"].get("mamba2_ssd_backward", 0), \
        get_arch(ARCH, reduced).num_layers
    check(device != "cuda" or nb == layers * 2, "K4's backward kernel "
          f"launched once a layer and step ({nb} == {layers} x 2)")
    if device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()

    # -- (c) rwkv6-1.6b at full width, bfloat16 compute
    print(f"phase 16c: launch.train.run {RWKV_ARCH} at {width}, 4 x {seq} "
          "tokens as 2 microbatches, bfloat16 compute", flush=True)
    out["rwkv6"] = _train_run(
        "2 steps", launches, RWKV_ARCH, device, steps=2, reduced=reduced,
        batch=4, seq=seq, microbatches=2, compute_dtype="bfloat16",
        kernels=("rwkv6_scan", "rwkv6_scan_backward"))
    nb, layers = out["rwkv6"]["launches"].get("rwkv6_scan_backward", 0), \
        get_arch(RWKV_ARCH, reduced).num_layers
    check(device != "cuda" or nb == layers * 2 * 2, "K5's backward kernel "
          f"launched once a layer, microbatch and step ({nb} == "
          f"{layers} x 2 x 2)")
    if device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()

    # -- (d) rwkv6-1.6b cut to 2 layers, one step at the bfloat16
    # defaults: every leaf's gradient, those upstream of K5 among them
    cfg = get_arch(RWKV_ARCH, reduced).replace(num_layers=2)
    print(f"phase 16d: one train step of {cfg.name} at {width}, 2 layers, "
          f"1 x {seq} tokens, at the bfloat16 defaults", flush=True)
    api = get_model(cfg)
    tcfg = TrainConfig()
    state = init_train_state(api, torch.Generator(device=device)
                             .manual_seed(0))
    toks = torch.from_numpy(lm_token_stream(1, seq, cfg.vocab_size, 0))
    before = {k: c.count for k, c in launches.items()}
    state, m = make_train_step(api, tcfg, REPLICATED)(
        state, {"tokens": toks.to(device)})
    k5 = launches["rwkv6_scan"].count - before["rwkv6_scan"]
    k5b = (launches["rwkv6_scan_backward"].count
           - before["rwkv6_scan_backward"]
           if "rwkv6_scan_backward" in launches else 0)
    out["rwkv6_leaves"] = {"loss": float(m["loss"]),
                           "grad_norm": float(m["grad_norm"]),
                           "launches": k5, "backward_launches": k5b,
                           "leaf_grad_norms": leaf_grads_from_m(state["m"],
                                                                tcfg.b1)}
    print(f"  loss {float(m['loss'])}, grad norm {float(m['grad_norm'])}, "
          f"rwkv6_scan launches {k5}, rwkv6_scan_backward {k5b}",
          flush=True)
    check(math.isfinite(float(m["loss"])), "16d: finite loss")
    check(device != "cuda" or k5 == 2 * cfg.num_layers,
          f"K5 launched forward and under remat in every layer ({k5})")
    check(device != "cuda" or k5b == cfg.num_layers,
          f"K5's backward kernel launched once in every layer ({k5b})")
    check_leaf_grads("16d", out["rwkv6_leaves"]["leaf_grad_norms"],
                     WKV_UPSTREAM)
    del state
    if device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()

    # -- (e) card against host: K5's backward kernel on the card, its
    # plain version on the host
    cfg = get_arch(RWKV_ARCH, reduced).replace(num_layers=2)
    print(f"phase 16e: one train step of {cfg.name} at {width}, 2 layers, "
          f"1 x {host_seq} tokens, float32, on the card and on the host",
          flush=True)
    api = get_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=100,
                       compute_dtype="float32", grad_reduce_dtype="float32")
    step = make_train_step(api, tcfg, REPLICATED)
    host = init_train_state(api, torch.Generator().manual_seed(0))
    card = tree_map(lambda a: a.to(device, copy=True), host)
    toks = torch.from_numpy(lm_token_stream(1, host_seq, cfg.vocab_size, 0))
    before = {k: c.count for k, c in launches.items()}
    t0 = time.perf_counter()
    card, mc = step(card, {"tokens": toks.to(device)})
    card_loss = float(mc["loss"])
    card_s = time.perf_counter() - t0
    counts = {k: c.count - before[k] for k, c in launches.items()}
    t0 = time.perf_counter()
    host, mh = step(host, {"tokens": toks})
    host_s = time.perf_counter() - t0
    loss_rel = abs(card_loss / float(mh["loss"]) - 1)
    norm_rel = abs(float(mc["grad_norm"]) / float(mh["grad_norm"]) - 1)
    moment_rel = {k: moment_diff(card[k], host[k]) for k in ("m", "v")}
    out["rwkv6_card_vs_host"] = {
        "card_ms": card_s * 1e3, "host_ms": host_s * 1e3,
        "loss": [card_loss, float(mh["loss"])], "loss_rel": loss_rel,
        "grad_norm": [float(mc["grad_norm"]), float(mh["grad_norm"])],
        "grad_norm_rel": norm_rel, "moment_diff_over_leaf_max": moment_rel,
        "launches": counts}
    print(f"  card {card_s * 1e3:.3f} ms, host {host_s * 1e3:.3f} ms; loss "
          f"{card_loss} / {float(mh['loss'])} (rel {loss_rel:.3g}); grad norm "
          f"rel {norm_rel:.3g}; max |Δm|, |Δv| over the leaf's largest "
          f"{moment_rel['m']:.3g}, {moment_rel['v']:.3g}; launches "
          f"{counts}", flush=True)
    if device == "cuda":
        check(counts["rwkv6_scan_backward"] == cfg.num_layers,
              "16e: K5's backward kernel launched once in every layer "
              f"({counts['rwkv6_scan_backward']} == {cfg.num_layers})")
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"16e card vs host loss: {loss_rel:.3g} <= {TRAIN_LOSS_RTOL}")
    check(norm_rel <= TRAIN_NORM_RTOL,
          f"16e card vs host grad norm: {norm_rel:.3g} <= {TRAIN_NORM_RTOL}")
    del card, host
    return out


def phase_distribution(device="cuda"):
    """Phase 17: the distribution substrate on one card.  The host mesh
    clamps ``model_par=2`` to the one rank, so ``model_serve.run`` and
    ``train.run`` of reduced qwen3-0.6b at ``model_par=2`` equal their
    ``model_par=1`` runs bit for bit; then, through a one-rank process
    group (NCCL on the card, a file store under ``build/``, destroyed at
    the end): the int8 compressed mean and the reducer on a (1, 7·5)
    leaf and two steps of error feedback against their numpy formulas,
    and ``remesh_tree`` of a qwen3 train state onto the one-card mesh.
    Runs over several ranks are phase 18's (two gloo ranks sharing the
    card: NCCL takes no two ranks on one card) and the CPU gloo
    tests'."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.distributed import compression
    from repro_torch.distributed.elastic import remesh_tree
    from repro_torch.distributed.sharding import default_rules
    from repro_torch.launch import model_serve, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.training.train_step import (init_train_state,
                                                 train_state_axes)
    print("phase 17: the distribution substrate on one card", flush=True)
    out = {}
    mesh = make_host_mesh(model=2)
    check(mesh.shape == (1, 1) and mesh.axis_names == ("data", "model"),
          f"make_host_mesh(model=2) on one rank: {mesh.shape}")
    kw = dict(reduced=True, requests=4, prompt_len=16, gen=4, device=device)
    one = model_serve.run(LONG_ARCH, model_par=1, **kw)["generated"]
    two = model_serve.run(LONG_ARCH, model_par=2, **kw)["generated"]
    check(np.array_equal(one, two), "model_serve.run at model_par=2 equals "
          "model_par=1 (the reference's clamp)")
    kw = dict(reduced=True, steps=2, batch=4, seq=64, device=device,
              log_every=100)
    one = train.run(LONG_ARCH, model_par=1, **kw)
    two = train.run(LONG_ARCH, model_par=2, **kw)
    out["train_model_par"] = {"losses": [one["losses"], two["losses"]],
                              "grad_norms": [one["grad_norms"],
                                             two["grad_norms"]]}
    check(one["losses"] == two["losses"]
          and one["grad_norms"] == two["grad_norms"],
          f"train.run at model_par=2 equals model_par=1 bit for bit "
          f"({two['losses']})")

    store = os.path.join(ROOT, "build", "chip_smoke_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method="file://" + store, rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()
        check(mesh.device_mesh is not None and mesh.size == 1,
              f"a one-rank {dist.get_backend()} group gives the (1, 1) mesh "
              "with its DeviceMesh")
        rng = np.random.default_rng(0)
        g = rng.standard_normal((1, 7, 5)).astype(np.float32)

        def q8(x):
            scale = np.float32(max(np.abs(x).max(), np.float32(1e-12))
                               / np.float32(127.0))
            return np.clip(np.round(x / scale), -127, 127) * scale

        want = q8(q8(g.reshape(1, 35)))     # one rank: both phases
        got = compression.compressed_psum_int8(
            torch.from_numpy(g.reshape(1, 35)).to(device)).cpu().numpy()
        red = compression.make_compressed_grad_reducer(mesh)(
            {"w": torch.from_numpy(g).to(device)})["w"].cpu().numpy()
        step = np.abs(want).max() / 127
        err = max(float(np.abs(got - want).max()),
                  float(np.abs(red.reshape(1, 35) - want).max()))
        check(err <= step, f"compressed_psum_int8 and the reducer on a "
              f"(1, 7*5) leaf against the numpy formula: {err:.3g} <= one "
              f"int8 step {step:.3g}")
        grads = {"w": torch.from_numpy(g).to(device)}
        ef = compression.ErrorFeedback.init(grads)
        e_np, ef_err = np.zeros_like(g), 0.0
        for _ in range(2):
            sent, ef = compression.ErrorFeedback.apply(grads, ef)
            c = g + e_np
            s_np = q8(c)
            e_np = c - s_np
            ef_err = max(ef_err, float(np.abs(sent["w"].cpu().numpy()
                                              - s_np).max()),
                         float(np.abs(ef["w"].cpu().numpy() - e_np).max()))
        check(ef_err <= step, f"two steps of ErrorFeedback against the numpy "
              f"formula: {ef_err:.3g} <= {step:.3g}")
        from torch.distributed.tensor import DTensor
        cfg = get_arch(LONG_ARCH, reduced=True)
        api = get_model(cfg)
        state = init_train_state(api, torch.Generator(device=device)
                                 .manual_seed(0))
        axes = train_state_axes(api)
        rules = dict(default_rules(), **(cfg.sharding_overrides or {}))
        moved = remesh_tree(state, axes, mesh, rules)
        from repro_torch.distributed.sharding import tree_to_shardings
        from repro_torch.models.lm import tree_leaves
        want = tree_leaves(tree_to_shardings(state, axes, mesh, rules))
        triples = list(zip(tree_leaves(state), tree_leaves(moved), want))
        ok = all(isinstance(b, DTensor) and list(b.placements) == pl
                 and torch.equal(b.to_local(), a) for a, b, pl in triples)
        check(ok, f"remesh_tree of a {cfg.name} train state onto the "
              f"one-card mesh: {len(triples)} leaves as DTensors with their "
              "specs' placements, each shard the whole leaf")
        out.update({"psum_err": err, "error_feedback_err": ef_err,
                    "remeshed_leaves": len(triples),
                    "backend": dist.get_backend()})
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    print("  the 8-rank reducer, the 4-rank data-parallel train.run and "
          "remesh on a 2 x 2 mesh are the CPU gloo tests' "
          "(tests/test_torch_distributed_ranks.py); two ranks on this card "
          "run in phase 18", flush=True)
    return out


# ---- phase 18: tensor and expert parallelism, two ranks on one card
TP_RANKS = 2
TP_TIMEOUT_S = 600
TP_ZAMBA2_LAYERS = 12


def tp_runs(reduced=False) -> list[dict]:
    """Phase 18's runs at ``model_par=2``: ``kind`` serve goes through
    ``launch.model_serve.run`` (default rules), prefill through the
    model's ``prefill`` (the rules named), train through
    ``launch.train.run``; ``kernels`` are those each rank must launch;
    ``param_bytes`` is what a rank's float32 parameter shards hold at
    ``model_par=2`` by the reference's rules and spec arithmetic
    (``tests/test_torch_tensor_parallel.py`` derives each from the JAX
    package).  ``reduced`` gives the CPU rehearsal's sizes."""
    if reduced:
        serve = dict(requests=2, prompt_len=20, gen=3)      # 24 slots
        return [
            dict(name="qwen3_serve", kind="serve", arch=LONG_ARCH, **serve,
                 kernels=("flash_attention",), param_bytes=214528),
            dict(name="zamba2_serve", kind="serve", arch=ARCH, **serve,
                 kernels=("mamba2_ssd",), param_bytes=2054080),
            dict(name="rwkv6_serve", kind="serve", arch=RWKV_ARCH,
                 requests=4, prompt_len=8, gen=4, kernels=("rwkv6_scan",),
                 param_bytes=361472),
            dict(name="moe_ep_prefill", kind="prefill", arch=MOE_ARCH,
                 batch=2, seq=20, slots=22, ep=True,
                 kernels=("flash_attention",), param_bytes=513280),
            dict(name="qwen3_train", kind="train", arch=LONG_ARCH, batch=1,
                 seq=32, kernels=("flash_attention",)),
            dict(name="zamba2_heads_prefill", kind="prefill", arch=ARCH,
                 batch=1, seq=20, slots=21, overrides=True,
                 kernels=("mamba2_ssd",), param_bytes=2054080),
        ]
    serve = dict(requests=2, prompt_len=1536, gen=15)       # 1,552 slots
    # zamba2-2.7b cut to 12 of its 54 layers: two applications of the
    # shared attention (one every 6 Mamba2 layers), so K3 and K4 launch
    return [
        dict(name="qwen3_serve", kind="serve", arch=LONG_ARCH, **serve,
             kernels=("flash_attention",), param_bytes=1192493056),
        dict(name="zamba2_serve", kind="serve", arch=ARCH, **serve,
             layers=TP_ZAMBA2_LAYERS, kernels=("flash_attention",
                                               "mamba2_ssd"),
             param_bytes=1542017280),
        dict(name="rwkv6_serve", kind="serve", arch=RWKV_ARCH, requests=4,
             prompt_len=512, gen=4, kernels=("rwkv6_scan",),
             param_bytes=3245375488),
        dict(name="moe_ep_prefill", kind="prefill", arch=MOE_ARCH, batch=2,
             seq=1536, slots=1538, ep=True, kernels=("flash_attention",),
             param_bytes=2671972352),
        dict(name="qwen3_train", kind="train", arch=LONG_ARCH, batch=1,
             seq=2048, kernels=("flash_attention",
                                "flash_attention_backward")),
        dict(name="zamba2_heads_prefill", kind="prefill", arch=ARCH,
             batch=1, seq=1536, slots=1537, overrides=True,
             layers=TP_ZAMBA2_LAYERS, kernels=("flash_attention",
                                               "mamba2_ssd"),
             param_bytes=1542017280),
    ]


def tp_run(run, device, reduced, model_par):
    """One of phase 18's runs at ``model_par`` on the default group's
    ranks (none: one rank).  Returns its numpy outputs (full-vocabulary
    logits, greedy tokens; loss and gradient norm) and what the ranks
    report: the cache leaves' local against full shapes, the parameter
    bytes held, the wall time."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (Layout, ShardingCtx,
                                                  default_rules)
    from repro_torch.launch import model_serve, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_leaves
    from repro_torch.models.registry import HostGenerator, vocab_split
    t0 = time.perf_counter()
    cfg = get_arch(run["arch"], reduced=reduced)
    if run.get("layers"):
        cfg = cfg.replace(num_layers=run["layers"])
    out, info = {}, {}
    if run["kind"] == "train":
        r = train.run(run["arch"], reduced=reduced, steps=1,
                      batch=run["batch"], seq=run["seq"],
                      model_par=model_par, device=device, log_every=100)
        out["loss"] = np.float64(r["losses"][0])
        out["grad_norm"] = np.float64(r["grad_norms"][0])
        info["step_s"] = r["step_s"][0]
        info["wall_s"] = time.perf_counter() - t0
        return out, info
    if run["kind"] == "serve":
        r = model_serve.run(run["arch"], reduced=reduced,
                            requests=run["requests"],
                            prompt_len=run["prompt_len"], gen=run["gen"],
                            model_par=model_par, device=device,
                            layers=run.get("layers"))
        out["logits"], out["tokens"] = r["logits"], r["generated"]
        info["prefill_s"], info["decode_s"] = r["prefill_s"], r["decode_s"]
        cache_shapes, param_bytes = r["cache_shapes"], r["param_bytes"]
        mesh = make_host_mesh(model=model_par)
        sh = ShardingCtx(mesh=mesh if mesh.size > 1 else None)
        slots = run["prompt_len"] + run["gen"] + 1
        rows = run["requests"] // mesh.batch_extent
    else:
        rules = default_rules()
        if run.get("overrides"):
            rules.update(cfg.sharding_overrides or {})
        if run.get("ep"):
            cfg = cfg.replace(**no_drop_moe(run["arch"], reduced))
            rules.update(cfg.sharding_overrides or {})
            rules.update(cfg.prefill_sharding_overrides)
        mesh = make_host_mesh(model=model_par)
        sh = ShardingCtx(mesh=mesh if mesh.size > 1 else None, rules=rules)
        api = get_model(cfg)
        params = api.init((torch.Generator if mesh.size == 1
                           else HostGenerator)(device=device).manual_seed(0))
        params = Layout(sh, params, api.param_axes()).local(params, device)
        toks = np.random.default_rng(4).integers(
            1, cfg.vocab_size, (run["batch"], run["seq"])).astype(np.int32)
        with torch.no_grad():
            t1 = time.perf_counter()
            logits, cache = api.prefill(
                params, {"tokens": torch.from_numpy(toks).to(device)}, sh,
                run["slots"])
            if device == "cuda":
                torch.cuda.synchronize()
            info["prefill_s"] = time.perf_counter() - t1
            if vocab_split(cfg, sh) is not None:
                logits = sh.gather(logits, -1)
        out["logits"] = logits.float().cpu().numpy()
        slots, rows = run["slots"], run["batch"]
        cache_shapes = {k: tuple(v.shape) for k, v in cache.items()}
        param_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(params))
        del params, cache
        if run.get("ep"):
            from repro_torch.models.moe import _use_shardmap_ep
            info["ep_route"] = _use_shardmap_ep(cfg, sh)
    if device == "cuda":
        torch.cuda.synchronize()
    info["wall_s"] = time.perf_counter() - t0
    api = get_model(cfg)
    full = api.init_cache(rows, slots, torch.float32, device="meta")
    info["cache"] = {k: [list(full[k].shape), list(v)]
                     for k, v in cache_shapes.items()}
    info["cache_split_dims"] = {k: [d for d, (a, b) in enumerate(zip(*s))
                                    if a != b]
                                for k, s in info["cache"].items()}
    info["param_bytes"] = param_bytes
    return out, info


def tp_compare(run, got, ref) -> dict:
    """A run at ``model_par=2`` against its ``model_par=1`` run:
    logits (absolute), greedy tokens (equal), loss and gradient norm
    (relative)."""
    import numpy as np
    res = {}
    if "logits" in ref:
        res["logits_err"] = float(np.abs(got["logits"] - ref["logits"]).max())
        res["logits_ok"] = (got["logits"].shape == ref["logits"].shape
                            and res["logits_err"] <= LOGIT_TOL)
    if "tokens" in ref:
        res["tokens_equal"] = bool(np.array_equal(got["tokens"],
                                                  ref["tokens"]))
    if "loss" in ref:
        res["loss_rel"] = float(abs(got["loss"] - ref["loss"])
                                / abs(ref["loss"]))
        res["grad_norm_rel"] = float(abs(got["grad_norm"] - ref["grad_norm"])
                                     / abs(ref["grad_norm"]))
        res["train_ok"] = (res["loss_rel"] <= TP_LOSS_RTOL
                           and res["grad_norm_rel"] <= TP_NORM_RTOL)
    return res


def tp_rank_main(rank: int, store: str, device: str, reduced: bool) -> int:
    """One rank of phase 18: a gloo group with the other rank over a
    file store in ``store``, tensors on ``device`` (the one card), every
    run of :func:`tp_runs` at ``model_par=2``, each against the parent's
    ``model_par=1`` outputs in ``store``; the results go to
    ``store/rank_<r>.json``.  The kernels are the ones phase 1 built."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import rwkv6_scan as wkv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"flash_attention": fa.launches, "mamba2_ssd": ssd.launches,
                "mamba2_ssd_backward": ssd.backward_launches,
                "rwkv6_scan": wkv.launches,
                "flash_attention_backward": fa.backward_launches}
    if device == "cuda":
        torch.cuda.set_device(0)
        for name in counters:
            if not _build.library_path(name).exists():
                raise SmokeFailure(f"rank {rank}: {name} is not built")
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        store, "group"), rank=rank, world_size=TP_RANKS)
    results = {}
    try:
        for run in tp_runs(reduced):
            for c in counters.values():
                c.reset()
            if device == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            got, info = tp_run(run, device, reduced, TP_RANKS)
            ref = dict(np.load(os.path.join(store, run["name"] + ".npz")))
            info.update(tp_compare(run, got, ref))
            info["launches"] = {k: c.count for k, c in counters.items()}
            if device == "cuda":
                info["peak_bytes"] = torch.cuda.max_memory_allocated()
            results[run["name"]] = info
            del got
            gc.collect()
        dist.barrier()
    finally:
        dist.destroy_process_group()
        with open(os.path.join(store, f"rank_{rank}.json"), "w") as f:
            json.dump(results, f)
    return 0


def phase_tensor_parallel(device="cuda", reduced=False):
    """Phase 18: tensor and expert parallelism with two ranks sharing the
    one card.  The parent first runs every run of :func:`tp_runs` at
    ``model_par=1`` and writes its outputs to a store directory under
    ``build/``; then two rank processes (``chip_smoke.py --tp-rank``)
    meet in a gloo group over a file store there, hold CUDA tensors on
    the card, load the kernels phase 1 built, and run every run at
    ``model_par=2``, each against the parent's outputs: logits within
    ``LOGIT_TOL``, the greedy tokens equal, the train step's loss and
    gradient norm within ``TP_LOSS_RTOL`` and ``TP_NORM_RTOL``.  Each
    rank's K3, K4 and K5 launches, peak memory and parameter bytes
    (equal to the reference's rules', ``param_bytes``) are printed, and the walls (the
    two ranks time-share the card: no speed-up is claimed).  The card
    must be in the Default compute mode, which lets two processes hold
    contexts on it."""
    import numpy as np
    import torch
    print("phase 18: tensor and expert parallelism, two ranks on one card",
          flush=True)
    if device == "cuda":
        mode = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True
        ).stdout.strip().splitlines()[0]
        check(mode == "Default", f"the card's compute mode is {mode!r}; "
              "two ranks on one card need 'Default'")
    store = os.path.join(ROOT, "build", "tp_store")
    if os.path.exists(store):
        import shutil
        shutil.rmtree(store)
    os.makedirs(store)
    out = {"runs": {}}
    for run in tp_runs(reduced):
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ref, info = tp_run(run, device, reduced, 1)
        np.savez(os.path.join(store, run["name"] + ".npz"), **ref)
        info["peak_bytes"] = (torch.cuda.max_memory_allocated()
                              if device == "cuda" else None)
        out["runs"][run["name"]] = {"model_par_1": info}
        print(f"  {run['name']} at model_par=1: " + json.dumps(
            {k: v for k, v in info.items() if k.endswith("_s")}), flush=True)
        gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         store, device, "reduced" if reduced else "full"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for r in range(TP_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out["ranks_s"] = time.monotonic() - t0
    codes = [p.returncode for p in procs]
    if codes != [0] * TP_RANKS:
        for r, log in enumerate(logs):
            print(f"  rank {r} exited {codes[r]}:\n" + log[-4000:], flush=True)
    check(codes == [0] * TP_RANKS, f"phase 18's ranks exited {codes}")
    launches = dict.fromkeys(MODEL_KERNELS, 0)
    for r in range(TP_RANKS):
        with open(os.path.join(store, f"rank_{r}.json")) as f:
            res = json.load(f)
        for run in tp_runs(reduced):
            info = res[run["name"]]
            out["runs"][run["name"]][f"rank_{r}"] = info
            what = f"phase 18 {run['name']} rank {r}"
            print(f"  {what}: " + json.dumps(info), flush=True)
            if "logits_ok" in info:
                check(info["logits_ok"], f"{what}: logits within {LOGIT_TOL} "
                      f"of model_par=1 ({info['logits_err']:.3g})")
            if "tokens_equal" in info:
                check(info["tokens_equal"], f"{what}: greedy tokens equal "
                      "model_par=1's")
            if "train_ok" in info:
                check(info["train_ok"], f"{what}: loss {info['loss_rel']:.3g}"
                      f" <= {TP_LOSS_RTOL}, grad norm "
                      f"{info['grad_norm_rel']:.3g} <= {TP_NORM_RTOL} "
                      "relative to model_par=1")
            if "param_bytes" in info:
                check(info["param_bytes"] == run["param_bytes"],
                      f"{what}: parameter bytes {info['param_bytes']} equal "
                      f"the reference's rules' {run['param_bytes']}")
            if run.get("ep"):
                check(info["ep_route"], f"{what}: the EP route ran")
            for k, n in info["launches"].items():
                launches[k] += n
            if device == "cuda":
                for k in run["kernels"]:
                    check(info["launches"][k] > 0,
                          f"{what}: {k} launched ({info['launches'][k]})")
    out["launches"] = launches
    print(f"  phase 18 ranks: {out['ranks_s']:.3f} s (two ranks "
          f"time-sharing one {device} device); launches {launches}",
          flush=True)
    return out


# ------------------------------------------------------------ phase 19
# phase 19b's cells on a (1, 1) mesh: (arch, shape cut from, batch,
# seq, the kernel its program launches)
DRYRUN_CELLS = [(LONG_ARCH, "train_4k", 2, 4096, "flash_attention"),
                (RWKV_ARCH, "prefill_32k", 4, 4096, "rwkv6_scan")]
# the card's peak allocation over a step against the dry run's peak
DRYRUN_PEAK_RTOL = 0.15
TERMS = ("compute", "memory", "collective")
DRYRUN_TIMEOUT_S = 300
# phase 19a: the counterparts of the reference's two production-mesh
# dry-run tests, under fake groups of 256 and 512 ranks
DRYRUN_PRODUCTION = """
import json
from repro_torch.launch import dryrun
recs = []
with dryrun.fake_group(256):
    recs.append(dryrun.run_cell("whisper-small", "decode_32k",
                                multi_pod=False, verbose=False))
with dryrun.fake_group(512):
    recs.append(dryrun.run_cell("rwkv6-1.6b", "decode_32k",
                                multi_pod=True, verbose=False))
print(json.dumps(recs))
"""


def dryrun_shape(base, batch, seq):
    """``SHAPES[base]`` cut to ``batch`` x ``seq``: a phase 19b cell."""
    import dataclasses
    from repro_torch.configs import SHAPES
    shape = SHAPES[base]
    return dataclasses.replace(shape, global_batch=batch, seq_len=seq,
                               name=f"{shape.kind}_{batch}x{seq}")


def _materialise(meta, cfg, device, gen):
    """Seeded tensors on ``device`` of a meta batch's shapes and dtypes:
    token ids below the vocabulary, floats ~ 0.1 N(0, 1)."""
    import torch
    out = {}
    for k, t in meta.items():
        if t.dtype.is_floating_point:
            out[k] = (torch.randn(t.shape, generator=gen, device=device)
                      * 0.1).to(t.dtype)
        else:
            out[k] = torch.randint(1, cfg.vocab_size, t.shape, generator=gen,
                                   device=device, dtype=t.dtype)
    return out


def _same_layout(a, b) -> bool:
    """Whether two nested trees hold tensors of the same shapes and
    dtypes in the same places."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_layout(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(map(_same_layout, a, b)))
    return a.shape == b.shape and a.dtype == b.dtype


def phase_dryrun(launches, device="cuda", reduced=False, cells=None):
    """Phase 19: the dry run (``launch/dryrun.py``) against the card.
    (a) In a subprocess under ``fake`` groups, the production-mesh cells
    of the reference's dry-run tests: whisper-small decode_32k on 16 x 16
    and rwkv6-1.6b decode_32k on 2 x 16 x 16, each ``ok`` with its
    terms and bottleneck printed.  (b) Each of ``cells`` on a (1, 1)
    mesh: ``run_cell`` on meta tensors predicts it, then the same
    program runs once on the card from the port's seeded init (the
    train state or parameters, a seeded batch): each kernel's launches
    must equal the dry run's ``kernel_breakdown``, the input bytes on
    the card its ``input_bytes_per_device``, and the card's peak
    allocation over the step be within ``DRYRUN_PEAK_RTOL`` of its
    ``peak_bytes_per_device``.  Then 3 warm calls: the median wall and
    the counted FLOPs over it as a share of the card's bf16 peak; a
    train cell also beside ``train_step_products``.  With
    ``device="cpu"`` (a rehearsal) launches and memory are not
    compared."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch import costs, dryrun
    from repro_torch.models import get_model
    from repro_torch.training.train_step import init_train_state
    on_card = device == "cuda"
    print("phase 19: the dry run against the card", flush=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("WORLD_SIZE", None)
    prod = subprocess.Popen([sys.executable, "-c", DRYRUN_PRODUCTION],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    out = {"cells": []}
    mesh = Mesh(("data", "model"), (1, 1))
    for arch, base, batch, seq, kernel in cells or DRYRUN_CELLS:
        cfg = get_arch(arch, reduced=reduced)
        shape = dryrun_shape(base, batch, seq)
        kind = shape.kind
        label = f"19b {arch} {shape.name}"
        t0 = time.monotonic()
        rec = dryrun.run_cell(cfg, shape, multi_pod=False, mesh=mesh,
                              verbose=False)
        dry_s = time.monotonic() - t0
        check(rec["status"] == "ok", f"{label}: dry run ok "
              f"({rec.get('error', '')})")
        fn, meta_args = dryrun.build_cell(cfg, shape, mesh)
        model = get_model(cfg)
        gen = torch.Generator(device).manual_seed(0)
        if on_card:
            torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated() if on_card else 0
        args = ((init_train_state(model, gen) if kind == "train"
                 else model.init(gen, dtype=torch.bfloat16)),
                _materialise(meta_args[1], cfg, device, gen))
        check(_same_layout(args, meta_args), f"{label}: the {device}'s "
              "arguments have the dry run's shapes and dtypes")
        del meta_args
        input_bytes = costs.nbytes(args)
        check(input_bytes == rec["input_bytes_per_device"],
              f"{label}: {input_bytes} input bytes on the {device} equal "
              f"the dry run's {rec['input_bytes_per_device']}")
        for c in launches.values():
            c.reset()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        res = fn(*args)
        if on_card:
            torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        counts = {k: c.count for k, c in launches.items()}
        peak = (torch.cuda.max_memory_allocated() - base_bytes if on_card
                else 0)
        del res
        predicted = {k: v["launches"]
                     for k, v in rec["kernel_breakdown"].items()}
        ratio = peak / rec["peak_bytes_per_device"]
        print(f"  {label}: dry run {dry_s:.3f} s; launches on the "
              f"{device} {counts}, predicted {predicted}; peak "
              f"{peak} B against the predicted "
              f"{rec['peak_bytes_per_device']} B (ratio {ratio:.4f})",
              flush=True)
        if on_card:
            check(counts[kernel] > 0, f"{label}: {kernel} launched")
            for name in MODEL_KERNELS:
                check(counts[name] == predicted.get(name, 0),
                      f"{label}: {name} launches {counts[name]} equal the "
                      f"dry run's {predicted.get(name, 0)}")
            check(abs(ratio - 1) <= DRYRUN_PEAK_RTOL,
                  f"{label}: peak within {DRYRUN_PEAK_RTOL} of the dry "
                  f"run's (ratio {ratio:.4f})")
        walls = []
        for _ in range(3):
            t0 = time.monotonic()
            res = fn(*args)
            if on_card:
                torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
            del res
        wall = statistics.median(walls)
        share = rec["flops_per_device"] / wall / PEAK_FLOPS
        row = {"arch": arch, "shape": shape.name, "cell": [base, batch, seq],
               "reduced": reduced, "dry_run_s": dry_s,
               "first_s": first_s, "walls_s": walls, "wall_s": wall,
               "launches": counts, "predicted_launches": predicted,
               "input_bytes": input_bytes, "peak_bytes": peak,
               "predicted_peak_bytes": rec["peak_bytes_per_device"],
               "peak_ratio": ratio, "flops": rec["flops_per_device"],
               "hbm_bytes": rec["hbm_bytes_per_device"],
               "terms_s": {k: rec[f"{k}_term_s"] for k in TERMS},
               "share_of_bf16_peak": share}
        line = (f"  {label}: wall {wall * 1e3:.3f} ms (median of "
                f"{[round(w * 1e3, 3) for w in walls]}); "
                f"{rec['flops_per_device']:.6g} counted FLOPs, "
                f"{share:.6f} of the bf16 peak ({PEAK_FLOPS:.4g} "
                "FLOP/s)")
        if kind == "train":
            products = train_step_products(cfg, batch, seq)
            row["train_step_products"] = products
            line += (f"; train_step_products {products:.6g}, counted / "
                     f"hand {rec['flops_per_device'] / products:.6f}")
        print(line, flush=True)
        out["cells"].append(row)
        del args, fn
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    stdout, stderr = prod.communicate(timeout=DRYRUN_TIMEOUT_S)
    check(prod.returncode == 0, "19a: the production-mesh dry runs exit 0"
          + ("" if prod.returncode == 0 else f" ({stderr[-2000:]})"))
    recs = json.loads(stdout.strip().splitlines()[-1])
    for rec, chips, mesh_name in zip(recs, (256, 512),
                                     ("16x16", "2x16x16")):
        label = f"19a {rec['arch']} {rec['shape']} on {mesh_name}"
        check(rec["status"] == "ok" and rec["chips"] == chips
              and rec["mesh"] == mesh_name
              and rec["collective_bytes_per_device"] >= 0,
              f"{label}: ok on {chips} ranks ({rec.get('error', '')})")
        print(f"  {label}: compute {rec['compute_term_s'] * 1e3:.6f} ms, "
              f"memory {rec['memory_term_s'] * 1e3:.6f} ms, collective "
              f"{rec['collective_term_s'] * 1e3:.6f} ms -> "
              f"{rec['bottleneck']}-bound; {rec['run_s']} s", flush=True)
    out["production"] = recs
    return out


def wire_query(engine, query):
    """``run_query`` through a ``WireFrontend`` on 127.0.0.1 in front of
    ``engine`` and a ``WireClient``: the response reassembled from the
    streamed frames, cold and warm."""
    from repro_torch.serving.frontend import WireClient, WireFrontend
    front = WireFrontend(engine).start()
    try:
        with WireClient(front.address) as client:
            return run_query(client, query)
    finally:
        front.close()


def codec_ms(entities, n=32):
    """Median host ms to code one response entity as a wire ``entity``
    frame and decode it back (``to_jsonable``, ``encode_frame``,
    ``FrameDecoder.feed``, ``from_jsonable``) over the first ``n``
    entities, and the frame's bytes."""
    from repro_torch.serving.wire import (FrameDecoder, encode_frame,
                                          from_jsonable, to_jsonable)
    times = []
    for eid in list(entities)[:n]:
        t0 = time.perf_counter()
        frame = encode_frame("entity", {"rid": "r", "eid": eid,
                                        "data": to_jsonable(entities[eid])})
        (_, payload), = FrameDecoder().feed(frame)
        from_jsonable(payload["data"])
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3, len(frame)


def phase_wire_hash(device="cuda"):
    """Phase 9a: the static-hash workload through a 1-shard cluster, the
    wire in front of an engine, and the wire in front of that cluster."""
    from repro_torch.cluster import ShardedEngine
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.remote import TransportModel
    print("phase 9a: static hash through a 1-shard cluster and the wire",
          flush=True)
    transport = TransportModel(network_latency_s=0.001, service_time_s=0.001)
    query = find("dsp", STATIC_PIPE)
    kw = dict(device=device, num_remote_servers=2, transport=transport)
    cluster = ShardedEngine(num_shards=1, replica_factor=1, **kw)
    engine = VDMSAsyncEngine(**kw)
    out = {}
    try:
        fill(cluster, 8, 32, "dsp")
        fill(engine, 8, 32, "dsp")
        for name, eng, run in (("cluster_1_shard", cluster, run_query),
                               ("wire", engine, wire_query),
                               ("wire_cluster", cluster, wire_query)):
            res, dt = run(eng, query)
            digest = response_hash(res["entities"])
            print(f"  {name}: sha256 {digest}; {fmt(dt)}", flush=True)
            check(digest == STATIC_SHA256,
                  f"{name}: static hash equals the recorded 778564da…")
            out[name] = {"sha256": digest, "query": dt}
    finally:
        engine.shutdown()
        cluster.shutdown()
    return out


KILL_HOLD_S = 0.5


def phase_cluster_chain(faces, reference, launches, device="cuda",
                        num_shards=4):
    """Phases 9b and 9c: phase 4's device-backend chain through a
    1-shard and a ``num_shards``-shard cluster, every shard with its own
    device backend (K2 then K1 on stacked batches), in process, and
    through the ``num_shards``-shard cluster over the wire; then at
    ``replica_factor=2`` with ``kill_shard(1)`` while the query is in
    flight, and a query on the surviving shards.  ``reference`` is phase
    4's device-arm response."""
    from repro_torch.cluster import ShardedEngine
    from repro_torch.core.remote import TransportModel
    from repro_torch.distributed.fault import FaultInjector
    print(f"phase 9b: phase 4's device chain through 1 and {num_shards} "
          "shards, and over the wire", flush=True)
    transport = TransportModel(network_latency_s=0.002, service_time_s=0.001)
    query = find("lfw", DEVICE_PIPE)
    kw = dict(device=device, num_remote_servers=2, transport=transport,
              dispatch="cost", device_backend=True if device == "cuda"
              else device, device_batch_size=32, device_max_wait_ms=50.0,
              cost_overrides=DEVICE_PINNED)
    engine_path = ("gaussian_blur", "fused_resize_crop_normalize")
    out = {}
    for shards in (1, num_shards):
        cluster = ShardedEngine(num_shards=shards, **kw)
        try:
            ingest_faces(cluster, faces, "lfw")
            before = {k: launches[k].count for k in engine_path}
            res, dt = run_query(cluster, query)
            rose = {k: launches[k].count - before[k] for k in engine_path}
            dev = [e.dispatch_stats()["device"]
                   for e in cluster.shards.values()]
            batching = {k: sum(d[k] for d in dev)
                        for k in ("groups_run", "entities_run")}
            if shards == num_shards:
                wire_res, wire_dt = wire_query(cluster, query)
            stats = cluster.cluster_stats()
        finally:
            cluster.shutdown()
        owned = {sid: v["owned"] for sid, v in stats["per_shard"].items()}
        err = max_err(res["entities"], reference)
        print(f"  {shards} shard(s) in process: {fmt(dt)}; primaries per "
              f"shard {owned} (imbalance {stats['imbalance']:.3f}); "
              f"device groups {batching}; launches {rose}; max_abs_err vs "
              f"phase 4 {err:.3g}", flush=True)
        check(sum(owned.values()) == len(faces),
              f"the {shards} shard(s)' primaries sum to {len(faces)}")
        check(err <= PIPE_TOL, f"{shards} shard(s) vs phase 4: "
              f"{err:.3g} <= {PIPE_TOL}")
        for name in engine_path:
            check(device == "cpu" or rose[name] > 0,
                  f"{name} launched behind {shards} shard(s) ({rose[name]})")
        out[f"shards_{shards}"] = {
            "query": dt, "owned_primary": owned,
            "imbalance": stats["imbalance"], "chain_launches": rose,
            "device_batching": batching, "max_abs_err_vs_phase4": err}
    err = max_err(wire_res["entities"], reference)
    coded_ms, frame_bytes = codec_ms(wire_res["entities"])
    print(f"  {num_shards} shards over the wire: {fmt(wire_dt)}; "
          f"max_abs_err vs phase 4 {err:.3g}; one entity frame of "
          f"{frame_bytes} bytes coded and decoded in {coded_ms:.3f} ms "
          "(host)", flush=True)
    check(err <= PIPE_TOL, f"{num_shards} shards over the wire vs phase 4: "
          f"{err:.3g} <= {PIPE_TOL}")
    out["wire"] = {"shards": num_shards, "query": wire_dt,
                   "max_abs_err_vs_phase4": err,
                   "codec_ms_per_entity": coded_ms,
                   "frame_bytes": frame_bytes}
    res = wire_res

    print(f"phase 9c: the same at replica_factor=2, shard 1 killed in "
          "flight", flush=True)
    cluster = ShardedEngine(num_shards=num_shards, replica_factor=2, **kw)
    # hold shard 1's first device group for KILL_HOLD_S, so the kill below
    # lands while its piece is in flight on every run, as the reference's
    # tests hold theirs with a slow transport
    cluster.shards[1].device_backend.fault_injector = FaultInjector().at(
        "backend:device", 0, "latency", latency_s=KILL_HOLD_S)
    try:
        ingest_faces(cluster, faces, "lfw")
        t0 = time.monotonic()
        fut = cluster.submit(query)          # the scatter is on the shards
        cluster.kill_shard(1)
        killed = fut.result(timeout=600)
        kill_s = time.monotonic() - t0
        stats = cluster.cluster_stats()
        after, after_s = run_query(cluster, query)
    finally:
        cluster.shutdown()
    err_kill = max_err(killed["entities"], res["entities"])
    err_after = max_err(after["entities"], res["entities"])
    print(f"  killed in flight: {kill_s * 1e3:.3f} ms, failovers "
          f"{stats['failovers']}, live {stats['live_shards']}, max_abs_err "
          f"vs 9b {err_kill:.3g}; then on the survivors "
          f"{fmt(after_s)}, max_abs_err {err_after:.3g}", flush=True)
    check(killed["stats"]["failed"] == 0
          and len(killed["entities"]) == len(faces),
          "every entity answered after kill_shard(1) "
          f"({len(killed['entities'])})")
    check(stats["failovers_total"] > 0,
          f"failovers > 0 ({stats['failovers_total']})")
    check(1 not in stats["live_shards"], "shard 1 is dead")
    check(err_kill <= PIPE_TOL,
          f"response after the kill vs 9b: {err_kill:.3g} <= {PIPE_TOL}")
    check(err_after <= PIPE_TOL,
          f"query on the survivors vs 9b: {err_after:.3g} <= {PIPE_TOL}")
    out["kill"] = {"query_s": kill_s, "failovers": stats["failovers"],
                   "live_shards": stats["live_shards"],
                   "max_abs_err_vs_9b": err_kill, "survivors": after_s,
                   "survivors_max_abs_err_vs_9b": err_after}
    return out


def phase_baselines(device="cuda", sizes=None):
    """Phase 10: ``benchmarks/torch_suite.py``'s C1–C3, shard and κ
    runs.  Sync, pooled and async responses must agree for every C1
    query and C2, and the blur kernel must launch in IQ3 in all three
    systems; the times are printed, not gated."""
    from benchmarks import torch_suite
    print("phase 10: the paper's baselines and curves", flush=True)
    result = torch_suite.run_all(device, **(sizes or {}))
    for row in result["c1"] + result["c2"]:
        err = max(row["max_abs_err"].values())
        print(f"  {row['name']}: sync {row['sync_s'] * 1e3:.3f} ms, pool "
              f"{row['pool_s'] * 1e3:.3f} ms, async "
              f"{row['async_s'] * 1e3:.3f} ms; sync/async "
              f"{row['sync_over_async']:.3f}, pool/async "
              f"{row['pool_over_async']:.3f}; K1 launches "
              f"{row['k1_launches']}", flush=True)
        check(err <= PIPE_TOL,
              f"{row['name']}: sync, pool and async agree "
              f"({err:.3g} <= {PIPE_TOL})")
    iq3 = next(r for r in result["c1"] if r["name"] == "image_c1_IQ3_blur")
    for system, n in iq3["k1_launches"].items():
        check(device == "cpu" or n > 0,
              f"IQ3 launched the blur kernel in the {system} system ({n})")
    for row in result["c3"]:
        print(f"  {row['name']}: sync/async {row['sync_over_async']:.3f}, "
              f"pool/async {row['pool_over_async']:.3f}, sync/async-opt "
              f"{row['opt_speedup']:.3f}", flush=True)
    for key in ("shards", "kappa"):
        print(f"  {key}: " + ", ".join(
            f"{r['name'].split('_')[-1]} {r['wall_s'] * 1e3:.3f} ms "
            f"(T(1)/T {r['gain']:.3f}, efficiency {r['derived']:.3f})"
            for r in result[key]), flush=True)
    print(f"  seconds per suite: {result['seconds']}", flush=True)
    return result


def changed_kernels(old_csrc) -> list[str]:
    """The kernels whose sources in ``old_csrc`` differ from the
    checkout's: the kernel's ``.cu`` file or a header it includes."""
    import re
    from pathlib import Path
    from repro_torch.kernels import _build
    old, out = Path(old_csrc), []
    for name, (source, _) in _build._DECLARED.items():
        files = [source] + re.findall(r'#include "([^"]+)"',
                                      (_build.CSRC / source).read_text())
        if any(not (old / f).exists()
               or (old / f).read_bytes() != (_build.CSRC / f).read_bytes()
               for f in files):
            out.append(name)
    return out


def wkv_backward_16step(lib, r, k, v, w, u, dy):
    """``(dr, dk, dv, dw, du)`` from a build of K5's backward that has no
    geometry entry point (the design that walked every step), for
    ``--ab``: its entry point takes the arguments the wrapper passes, but
    its scratch holds the states and adjoints at every 16-step boundary,
    (B, H, T/16 + 1, K, V) floats each, and du's shares (B, T/16, H, K).
    y's cotangent only, no initial state; r, k, v, dy contiguous."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan import _DTYPES
    B, T, H, K = r.shape
    V = v.shape[3]
    f32, dev, nb = torch.float32, r.device, -(-T // 16)
    states = torch.empty((B, H, nb + 1, K, V), dtype=f32, device=dev)
    adj = torch.empty_like(states)
    du_part = torch.empty((B, nb, H, K), dtype=f32, device=dev)
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw = torch.empty((B, T, H, K), dtype=f32, device=dev)
    du = torch.empty((H, K), dtype=f32, device=dev)
    w, u = w.float().contiguous(), u.float().contiguous()
    _build.check(lib.repro_rwkv6_scan_backward(
        _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), None, dy.data_ptr(), None,
        states.data_ptr(), adj.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(), du.data_ptr(),
        None, B, T, H, K, V, *_build.outer(r), *_build.outer(k),
        *_build.outer(v), *_build.outer(w), *_build.outer(dy),
        torch.cuda.current_stream().cuda_stream), "rwkv6_scan_backward")
    return dr, dk, dv, dw, du


def ssd_backward_slice(lib) -> int:
    """The head slice a build of K4's backward reports through its
    geometry entry point, or 0 for a build whose gradient pass is a CTA
    a (block, head) (its geometry reports only the block length and the
    walk width)."""
    import ctypes
    out = (ctypes.c_int * 3)(0, 0, 0)
    lib.repro_mamba2_ssd_backward_geometry(out)
    return out[2]


def ssd_backward_per_head(lib, x, dt, A, Bm, Cm, D, dy):
    """``(dx, ddt, dA, dB, dC, dD)`` from a build of K4's backward whose
    gradient pass is a CTA a (block, head) (``ssd_backward_slice`` 0),
    for ``--ab``: its entry point takes the arguments the wrapper passes,
    but its scratch holds each head's share of dB and dC, (B, T, H, N)
    floats each.  y's cotangent only, no initial state; x, B, C and dy
    contiguous."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba2_ssd import _DTYPES
    Bn, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    f32, dev, nb = torch.float32, x.device, -(-T // 64)
    states = torch.empty((Bn, H, nb + 1, P, N), dtype=f32, device=dev)
    adj = torch.empty_like(states)
    decay = torch.empty((Bn, H, nb), dtype=f32, device=dev)
    dB_part = torch.empty((Bn, T, H, N), dtype=f32, device=dev)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty((Bn, H, nb), dtype=f32, device=dev)
    dD_part = torch.empty_like(dA_part)
    dx = torch.empty_like(x)
    ddt = torch.empty((Bn, T, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dD = torch.empty((H,), dtype=f32, device=dev)
    _build.check(lib.repro_mamba2_ssd_backward(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), None, dy.data_ptr(),
        None, states.data_ptr(), adj.data_ptr(), decay.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dB_part.data_ptr(),
        dC_part.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dA_part.data_ptr(), dD_part.data_ptr(), dA.data_ptr(),
        dD.data_ptr(), None, Bn, T, H, P, G, N, *_build.outer(x),
        *_build.outer(Bm), *_build.outer(Cm), *_build.outer(dy),
        torch.cuda.current_stream().cuda_stream), "mamba2_ssd_backward")
    return dx, ddt, dA, dB, dC, dD


def phase_ab(old_csrc, names=None):
    """Old against new kernels in one process on one card: the kernels
    ``names`` (by default every kernel whose sources differ, see
    :func:`changed_kernels`) built from ``old_csrc`` (a directory holding
    an earlier commit's ``csrc`` files) and from the checkout, each held
    against its plain version and timed at the main paths' shapes through
    the same wrapper (the old library swapped under it), in turns: old,
    new, new, old.  ``scaled_dot_product_attention`` is timed beside K3
    as in phase 5.  A case the old build refuses (a head dim, window or
    route it lacks) is recorded as refused and timed on the new build
    alone."""
    from pathlib import Path
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import preprocess as pp
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.gaussian_blur import gaussian_blur_cuda
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    names = list(names) if names else changed_kernels(old_csrc)
    print(f"A/B: {names} of {old_csrc} against the checkout's", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    old = _build.build_all(names, csrc=Path(old_csrc))
    libs = {n: {"old": _build.open_library(n, old[n]), "new": _build.load(n)}
            for n in names}
    rng = np.random.default_rng(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def turns(name, fn, plain):
        """Each build's max |got - plain| over the outputs, then times."""
        want = plain()
        row = {"old": [], "new": []}

        def call(which, f=None):
            with _build.swapped(name, libs[name][which]):
                return fn() if f is None else f(fn)

        order = ("old", "new", "new", "old")
        for which in ("old", "new"):
            try:
                got = call(which)
                torch.cuda.synchronize()
            except (RuntimeError, ValueError) as e:
                if which == "new":
                    raise
                row["old_refused"] = f"{type(e).__name__}: {e}"
                order = ("new", "new")
                continue
            row[f"{which}_max_abs_err"] = [
                float((g.float() - w.float()).abs().max())
                for g, w in zip(got, want)]
        for which in order:
            row[which].append(call(which, lambda f: time_ms(f, flush)))
        return row

    def flash_rows():
        # qwen3's long prefill (D 128) and zamba2's past 1024 slots (D 80)
        for (B, Sq, H, D), (Sk, Hkv) in (((4, 4096, 16, 128), (4113, 8)),
                                         ((2, 1536, 32, 80), (1553, 32))):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
                    np.float32)).cuda().to(dtype)
                    for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
                row = {"kernel": "flash_attention", "shape": [B, Sq, H, D],
                       "kv": [Sk, Hkv], "dtype": str(dtype),
                       **turns("flash_attention",
                               lambda: flash_attention_cuda(q, k, v),
                               lambda: ref.flash_attention_chunked(q, k, v))}
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), flush)
                yield row

    def flash_backward_rows():
        # the training shapes: qwen3-0.6b's microbatch (float32, GQA 16/8,
        # D 128; and in bfloat16, phase 19b's train cell), minicpm-2b's
        # (bfloat16, MHA, D 64), zamba2-2.7b's shared attention (float32,
        # MHA, D 80) and phase 18's per-rank qwen3 step (float32, 8 q and
        # 4 kv heads), causal
        from repro_torch.kernels import flash_vjp
        from repro_torch.kernels.flash_attention import \
            flash_attention_backward_cuda
        for (B, S, H, Hkv, D), dtype in (((2, 4096, 16, 8, 128),
                                          torch.float32),
                                         ((1, 4096, 36, 36, 64),
                                          torch.bfloat16),
                                         ((2, 4096, 16, 8, 128),
                                          torch.bfloat16),
                                         ((1, 4096, 32, 32, 80),
                                          torch.float32),
                                         ((1, 2048, 8, 4, 128),
                                          torch.float32)):
            q, do, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)).cuda().to(dtype)
                for s in ((B, S, H, D), (B, S, H, D), (B, S, Hkv, D),
                          (B, S, Hkv, D)))
            out, lse = flash_attention_cuda(q, k, v)
            yield {"kernel": "flash_attention_backward", "shape": [B, S, H, D],
                   "kv": [S, Hkv], "dtype": str(dtype),
                   **turns("flash_attention_backward",
                           lambda: flash_attention_backward_cuda(
                               q, k, v, out, lse, do),
                           lambda: flash_vjp.flash_backward(
                               q, k, v, out, lse, do))}

    def ssd_rows():
        for T in (512, 3):
            x, dt, A, Bm, Cm, D, h0 = ssd_inputs(rng, 16, T, 80, 64, 1, 64,
                                                 torch.float32)
            yield {"kernel": "mamba2_ssd", "shape": [16, T, 80, 64],
                   "dtype": "torch.float32",
                   **turns("mamba2_ssd",
                           lambda: mamba2_ssd_cuda(x, dt, A, Bm, Cm, D, h0),
                           lambda: ref.mamba2_ssd_chunked(
                               x, dt, A, Bm, Cm, D, h0,
                               chunk=min(128, max(T, 8))))}

    def wkv_rows():
        for B, T, dtype in ((16, 512, torch.float32),
                            (16, 512, torch.bfloat16), (8, 3, torch.float32)):
            r, k, v, w, u, s0 = wkv_inputs(rng, B, T, 32, 64, dtype)
            yield {"kernel": "rwkv6_scan", "shape": [B, T, 32, 64],
                   "dtype": str(dtype),
                   **turns("rwkv6_scan",
                           lambda: rwkv6_scan_cuda(r, k, v, w, u, s0),
                           lambda: ref.rwkv6_chunked(r, k, v, w, u, s0))}

    def wkv_backward_rows():
        # rwkv6-1.6b's training microbatch, y's cotangent only, in
        # bfloat16 (its training dtype) and float32; a build without the
        # geometry entry point walked every step and its scratch holds
        # every 16-step boundary (wkv_backward_16step)
        from repro_torch.kernels.rwkv6_scan import rwkv6_scan_backward_cuda
        for dtype in (torch.bfloat16, torch.float32):
            r, k, v, w, u, _ = wkv_inputs(rng, 2, 4096, 32, 64, dtype)
            dy = torch.from_numpy(rng.standard_normal(
                (2, 4096, 32, 64)).astype(np.float32)).cuda().to(dtype)

            def kernel():
                lib = _build.load("rwkv6_scan_backward")
                if not hasattr(lib, "repro_rwkv6_scan_backward_geometry"):
                    return wkv_backward_16step(lib, r, k, v, w, u, dy)
                return rwkv6_scan_backward_cuda(r, k, v, w, u, None, dy,
                                                None)[:5]

            yield {"kernel": "rwkv6_scan_backward", "shape": [2, 4096, 32, 64],
                   "dtype": str(dtype),
                   **turns("rwkv6_scan_backward", kernel,
                           lambda: ref.rwkv6_chunked_backward(
                               r, k, v, w, u, None, dy, None)[:5])}

    def ssd_backward_rows():
        # zamba2-2.7b's training microbatch, y's cotangent only, in float32
        # (its training dtype) and bfloat16, and phase 16a's 1,536 steps
        # in float32 (240 items over the SMs); a build whose gradient pass
        # is a CTA a (block, head) keeps each head's dB and dC shares
        # (ssd_backward_per_head).  Each build's time by launch beside.
        from repro_torch.kernels.mamba2_ssd import mamba2_ssd_backward_cuda
        for T, dtype in ((4096, torch.float32), (4096, torch.bfloat16),
                         (1536, torch.float32)):
            x, dt, A, Bm, Cm, D, _ = ssd_inputs(rng, 1, T, 80, 64, 1, 64,
                                                dtype)
            dy = torch.from_numpy(rng.standard_normal(
                (1, T, 80, 64)).astype(np.float32)).cuda().to(dtype)

            def kernel():
                lib = _build.load("mamba2_ssd_backward")
                if not ssd_backward_slice(lib):
                    return ssd_backward_per_head(lib, x, dt, A, Bm, Cm, D, dy)
                return mamba2_ssd_backward_cuda(x, dt, A, Bm, Cm, D, None,
                                                dy, None)[:6]

            row = {"kernel": "mamba2_ssd_backward",
                   "shape": [1, T, 80, 64], "dtype": str(dtype),
                   **turns("mamba2_ssd_backward", kernel,
                           lambda: ref.mamba2_ssd_chunked_backward(
                               x, dt, A, Bm, Cm, D, None, dy, None)[:6])}
            row["launch_ms"] = {}
            for which in ("old", "new"):
                with _build.swapped("mamba2_ssd_backward",
                                    libs["mamba2_ssd_backward"][which]):
                    row["launch_ms"][which] = launch_split(kernel)
            yield row

    def blur_rows():
        for shape, ksize, sigma in (((32, 224, 224, 3), 9, 2.0),
                                    ((1, 224, 224, 3), 9, 2.0),
                                    ((1, 250, 250, 3), 5, 1.5),
                                    ((1, 1080, 1920, 3), 5, 1.5),
                                    ((1, 250, 250, 3), 99, 0.0),
                                    ((1, 224, 224, 64), 5, 1.5)):
            x = torch.from_numpy(rng.uniform(0, 1, shape)
                                 .astype(np.float32)).cuda()
            yield {"kernel": "gaussian_blur", "shape": list(shape),
                   "ksize": ksize,
                   **turns("gaussian_blur",
                           lambda: (gaussian_blur_cuda(x, ksize, sigma),),
                           lambda: (ref.gaussian_blur_ref(x, ksize, sigma),))}

    def preprocess_rows():
        for shape, kw in (((32, 250, 250, 3), K2_MAIN),
                          ((1, 250, 250, 3), K2_MAIN),
                          ((1, 1080, 1920, 3), K2_1080P),
                          ((1, 1080, 1920, 3), K2_WIDE)):
            x = torch.from_numpy(rng.uniform(0, 1, shape)
                                 .astype(np.float32)).cuda()
            yield {"kernel": "fused_resize_crop_normalize", "shape": list(shape),
                   "resize": [kw["resize_h"], kw["resize_w"]],
                   "method": kw["method"],
                   **turns("preprocess",
                           lambda: (pp.fused_resize_crop_normalize_cuda(
                               x, **kw),),
                           lambda: (pp.fused_resize_crop_normalize_ref(
                               x, **kw),))}

    cases = {"flash_attention": flash_rows,
             "flash_attention_backward": flash_backward_rows,
             "mamba2_ssd": ssd_rows,
             "mamba2_ssd_backward": ssd_backward_rows,
             "rwkv6_scan": wkv_rows,
             "rwkv6_scan_backward": wkv_backward_rows,
             "gaussian_blur": blur_rows,
             "preprocess": preprocess_rows}
    rows = []
    for name in names:
        if name not in cases:
            raise SmokeFailure(f"--ab has no cases for {name}")
        for row in cases[name]():
            print("  " + json.dumps(row), flush=True)
            rows.append(row)
    return rows


# ------------------------------------------------------------ phase 20
# benchmarks/admission_bench.py::run_static_hash: the default engine's
# response on a bit-exact workload (8 images of 28 px from
# default_rng(23)), recorded in benchmarks/admission_static_baseline.json
ADMISSION_SHA256 = \
    "f9acbed1c4ab5c567940180df17d50602bac3a1d022246822db92bb8c8095f25"
ADMISSION_PIPE = [
    {"type": "crop", "x": 2, "y": 2, "width": 20, "height": 20},
    {"type": "remote", "url": "http://svc/flip", "options": {"id": "flip"}},
    {"type": "rotate", "k": 3},
    {"type": "threshold", "value": 0.5},
]
# index permutations and a comparison at LFW size: bit-exact under any
# placement (tests/test_device_backend.py's EXACT_PIPE, cropped to 224)
EXACT_PIPE = [
    {"type": "crop", "x": 13, "y": 13, "width": 224, "height": 224},
    {"type": "rotate", "k": 1},
    {"type": "flip", "axis": "horizontal"},
    {"type": "threshold", "value": 0.5},
]
REMOTE_FLIP = {"flip": {"remote": 1e-6, "native": 10.0, "batcher": 10.0}}
KILL_PIPE = [EXACT_PIPE[0],
             {"type": "remote", "url": "u", "options": {"id": "flip"}},
             {"type": "rotate", "k": 1},
             {"type": "threshold", "value": 0.5}]
# tests/test_resilience.py's chaos storm at its first seed
STORM_SEED = 0
STORM_PIPE = [
    {"type": "resize", "width": 16, "height": 16},
    {"type": "remote", "url": "u", "options": {"id": "grayscale"}},
    {"type": "threshold", "value": 0.4},
]
# phase 4's fused chain, then a slow remote op that keeps queries in
# flight long enough to cancel them mid-pipeline
SESSION_PIPE = DEVICE_PIPE[:3] + [
    {"type": "remote", "url": "u", "options": {"id": "grayscale"}},
    {"type": "threshold", "value": 0.5}]
SESSION_PINNED = {**{o["type"]: DEVICE_PINNED[o["type"]]
                     for o in DEVICE_PIPE[:3]},
                  "grayscale": {"remote": 1e-6, "native": 10.0,
                                "batcher": 10.0, "device": 10.0}}
# the CUDA caching allocator's smallest segment
ALLOC_BLOCK = 2 << 20


def _engine_once(VDMSAsyncEngine, transport, load, query, **kw):
    """One engine: ``load(engine)``, one query, shut down; returns the
    response and the dispatch stats."""
    eng = VDMSAsyncEngine(transport=transport, **kw)
    try:
        load(eng)
        res = eng.execute(query, timeout=600)
        stats = eng.dispatch_stats()
    finally:
        eng.shutdown()
    return res, stats


def _kill_after_first_result(eng, load, query):
    """Run ``query`` on ``eng`` and kill remote server 0 once the first
    entity has come back; returns the response and the live servers.
    The engine is shut down and dropped on return."""
    try:
        load(eng)
        first = threading.Event()
        fut = eng.submit(query, on_entity=lambda e: first.set())
        check(first.wait(60), "20d: a first result before the kill")
        eng.pool.kill_server(0)
        return fut.result(timeout=600), eng.pool.live_count()
    finally:
        eng.shutdown()


def _storm_responses(eng, load, query, n):
    """``n`` concurrent submits of ``query`` on ``eng`` (its fault
    injector armed); returns the responses and the dispatch and
    admission stats."""
    try:
        load(eng)
        futs = [eng.submit(query) for _ in range(n)]
        return ([f.result(timeout=600) for f in futs], eng.dispatch_stats(),
                eng.admission_stats())
    finally:
        eng.shutdown()


def _cancelled_sessions(eng, faces, query, clients):
    """``clients`` threads each submit ``query`` over ``faces``; the odd
    ones cancel once their first entity is back, the even ones wait for
    the response.  Returns {client: ("cancel", cancel()) | ("done",
    response)}, the admission stats once the engine has drained, and
    what was left (remote requests in flight, Queue_1, the device inbox,
    sessions).  The engine is shut down and dropped on return, so the
    device memory its entities held is free."""
    try:
        ingest_faces(eng, faces, "lfw")
        outcomes = {}

        def client(i):
            first = threading.Event()
            fut = eng.submit(query, on_entity=lambda e: first.set())
            if i % 2:
                first.wait(60)
                outcomes[i] = ("cancel", fut.cancel())
            else:
                outcomes[i] = ("done", fut.result(timeout=600))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        deadline = time.monotonic() + 20
        while (eng.pool.inflight or eng.loop.queue1.qsize()
               or eng.device_backend.pending() or eng.active_sessions()
               or eng.admission_stats()["inflight"]) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        return outcomes, eng.admission_stats(), (
            len(eng.pool.inflight), eng.loop.queue1.qsize(),
            eng.device_backend.pending(), eng.active_sessions())
    finally:
        eng.shutdown()


def _leaked_threads(before, timeout=10.0) -> list:
    deadline = time.monotonic() + timeout
    while True:
        leaked = [t for t in set(threading.enumerate()) - before
                  if t.is_alive()]
        if not leaked or time.monotonic() > deadline:
            return leaked
        time.sleep(0.05)


def phase_engine_behaviours(VDMSAsyncEngine, TransportModel, faces,
                            launches, device="cuda", smi=""):
    """Phase 20: the behaviours the reference's own engine tests hold
    (tests/test_torch_{admission,dispatch,device_fusion,resilience,
    sessions}.py on the CPU), on the card with ``device`` and
    ``device_backend`` there: (a) the admission hash and the queue
    engine's identical arrays; (b) cost dispatch byte-identical to
    static over ``faces``; (c) phase 4's chain over ``faces`` fused and
    per op, held against the CPU engine, K2 only in the fused run;
    (d) a server killed after the first result, and the seeded fault
    storm; (e) 8 sessions, half cancelled mid-pipeline, leaking no
    thread, admission slot or device memory."""
    import torch
    from repro_torch.distributed.fault import FaultInjector
    print("phase 20: the engine's behaviours on the card", flush=True)
    on_card = device != "cpu"
    backend = "cuda" if on_card else "cpu"

    def card_bytes() -> tuple[int, int]:
        """Bytes the caching allocator holds for tensors, as PyTorch's
        own CUDA leak check reads them: after a collection, and again
        without the per-thread cuBLAS workspaces (each worker thread
        that runs a matmul on the card gets one, which PyTorch keeps
        after the thread ends).  Returns (raw, without workspaces)."""
        if not on_card:
            return 0, 0
        gc.collect()
        torch.cuda.synchronize()
        raw = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        return raw, torch.cuda.memory_allocated()

    _, mem0 = card_bytes()
    threads0 = set(threading.enumerate())
    walls = {}
    out = {}

    def load_faces(eng):
        ingest_faces(eng, faces, "lfw")

    # 20a: the admission hash
    t0 = time.monotonic()
    transport = TransportModel(network_latency_s=0.001, service_time_s=0.001)
    adm_q = find("adm", ADMISSION_PIPE)

    def load_adm(eng):
        fill(eng, 8, 28, "adm", seed=23)

    none_res, _ = _engine_once(VDMSAsyncEngine, transport, load_adm, adm_q,
                               device=device, num_remote_servers=2)
    queue_res, _ = _engine_once(VDMSAsyncEngine, transport, load_adm, adm_q,
                                device=device, num_remote_servers=2,
                                admission="queue", max_inflight_entities=4)
    digest = response_hash(none_res["entities"])
    print(f"  20a: admission_none_hash {digest}", flush=True)
    check(none_res["stats"]["failed"] == 0 and queue_res["stats"]["failed"]
          == 0, "20a: failed == 0")
    check(digest == ADMISSION_SHA256,
          "20a: admission hash equals the recorded f9acbed1…")
    check(response_hash(queue_res["entities"]) == digest,
          "20a: admission='queue' returns identical arrays")
    out["admission_sha256"] = digest
    walls["20a"] = time.monotonic() - t0

    # 20b: cost dispatch against static
    t0 = time.monotonic()
    transport = TransportModel(network_latency_s=0.002, service_time_s=0.001)
    q = find("lfw", EXACT_PIPE)
    sta, _ = _engine_once(VDMSAsyncEngine, transport, load_faces, q,
                          device=device, num_remote_servers=2)
    cost, cost_stats = _engine_once(VDMSAsyncEngine, transport, load_faces,
                                    q, device=device, num_remote_servers=2,
                                    dispatch="cost",
                                    cost_overrides=REMOTE_FLIP)
    print(f"  20b: placements {cost_stats['placements']}, handoffs "
          f"{cost_stats['handoffs']}", flush=True)
    check(sta["stats"]["failed"] == 0 and cost["stats"]["failed"] == 0,
          "20b: failed == 0")
    check(cost_stats["placements"]["remote"] == len(faces),
          f"20b: flip placed remote for all {len(faces)} entities")
    check(response_hash(cost["entities"]) == response_hash(sta["entities"]),
          "20b: dispatch='cost' byte-identical to static")
    out["placements"] = cost_stats["placements"]
    walls["20b"] = time.monotonic() - t0

    # 20c: the device backend, fused and per op, against the CPU engine
    t0 = time.monotonic()
    q = find("lfw", DEVICE_PIPE)
    dev_kw = dict(num_remote_servers=2, dispatch="cost",
                  device_batch_size=32, device_max_wait_ms=50.0,
                  cost_overrides=DEVICE_PINNED)
    host, _ = _engine_once(VDMSAsyncEngine, transport, load_faces, q,
                           device="cpu", device_backend="cpu", **dev_kw)
    out["fusion"] = {}
    for fuse in (True, False):
        before = {k: c.count for k, c in launches.items()}
        res, st = _engine_once(VDMSAsyncEngine, transport, load_faces, q,
                               device=device, device_backend=backend,
                               device_fuse_segments=fuse, **dev_kw)
        rose = {k: c.count - before[k] for k, c in launches.items()}
        d = st["device"]
        err = max_err(res["entities"], host["entities"])
        label = "fused" if fuse else "per op"
        row = {k: d[k] for k in ("groups_run", "fused_segments",
                                 "padding_waste_frac", "compiles")}
        row.update(launches=rose, max_abs_err_vs_cpu=err)
        out["fusion"][label] = row
        print(f"  20c {label}: {row}", flush=True)
        check(res["stats"]["failed"] == 0, f"20c {label}: failed == 0")
        check(err <= PIPE_TOL,
              f"20c {label} vs the CPU engine: {err:.3g} <= {PIPE_TOL}")
        check((d["fused_segments"] > 0) == fuse,
              f"20c {label}: fused_segments {d['fused_segments']}")
        if on_card:
            check((rose["fused_resize_crop_normalize"] > 0) == fuse,
                  f"20c {label}: K2 launched "
                  f"{rose['fused_resize_crop_normalize']} times")
            check(rose["gaussian_blur"] > 0,
                  f"20c {label}: K1 launched {rose['gaussian_blur']} times")
    walls["20c"] = time.monotonic() - t0

    # 20d: a server killed after the first result, then the fault storm
    t0 = time.monotonic()
    transport = TransportModel(network_latency_s=0.002, service_time_s=0.005)
    q = find("lfw", KILL_PIPE)
    clean, _ = _engine_once(VDMSAsyncEngine, transport, load_faces, q,
                            device=device, num_remote_servers=2)
    killed, live = _kill_after_first_result(
        VDMSAsyncEngine(device=device, num_remote_servers=2,
                        transport=transport), load_faces, q)
    print(f"  20d: kill_server(0) after the first result: failed "
          f"{killed['stats']['failed']}, live servers {live}", flush=True)
    check(killed["stats"]["failed"] == 0 and live == 1,
          "20d: one server killed mid-query, failed == 0")
    check(response_hash(killed["entities"]) == response_hash(clean["entities"]),
          "20d: the response equals the fault-free run's")
    fast = TransportModel(network_latency_s=0.001, service_time_s=0.002)
    storm_q = find("res", STORM_PIPE)

    def load_storm(eng):
        fill(eng, 6, 24, "res", seed=5)

    fault_free, _ = _engine_once(VDMSAsyncEngine, fast, load_storm, storm_q,
                                 device=device, num_remote_servers=3)
    fi = FaultInjector(seed=STORM_SEED, error_rate=0.15, crash_rate=0.05,
                       latency_rate=0.05, latency_s=0.01, die_rate=0.01,
                       death_budget=1)
    storm, ds, adm = _storm_responses(
        VDMSAsyncEngine(device=device, num_remote_servers=3,
                        transport=fast, admission="queue",
                        max_inflight_entities=8, max_retries=4,
                        retry_backoff_base_s=0.002, retry_backoff_max_s=0.02,
                        heartbeat_timeout_s=0.2, fallback="native",
                        fault_injector=fi), load_storm, storm_q, 5)
    retried = ds["pool"]["retried"]
    print(f"  20d: storm seed {STORM_SEED}: injected "
          f"{fi.stats()['injected']}, retried {retried}, fallbacks "
          f"{ds.get('fallbacks')}, peak inflight {adm['peak_inflight']}",
          flush=True)
    check(all(r["stats"]["failed"] == 0 for r in storm),
          "20d: the storm degrades, never fails")
    check(retried > 0, f"20d: the storm retried ({retried})")
    check(all(response_hash(r["entities"])
              == response_hash(fault_free["entities"]) for r in storm),
          "20d: every storm response equals the fault-free run's")
    check(adm["peak_inflight"] <= 8 and adm["inflight"] == 0,
          "20d: admission bounded and released")
    out["storm"] = {"injected": fi.stats()["injected"], "retried": retried}
    walls["20d"] = time.monotonic() - t0

    # 20e: 8 sessions from threads, half cancelled mid-pipeline
    t0 = time.monotonic()
    slow = TransportModel(network_latency_s=0.001, service_time_s=0.05)
    n = min(16, len(faces))
    outcomes, adm, drained = _cancelled_sessions(
        VDMSAsyncEngine(device=device, num_remote_servers=4, transport=slow,
                        dispatch="cost", device_backend=backend,
                        device_max_wait_ms=20.0, admission="queue",
                        max_inflight_entities=32,
                        cost_overrides=SESSION_PINNED),
        faces[:n], find("lfw", SESSION_PIPE), 8)
    done = [r for kind, r in outcomes.values() if kind == "done"]
    cancelled = [c for kind, c in outcomes.values() if kind == "cancel"]
    check(len(outcomes) == 8 and all(cancelled) and len(cancelled) == 4,
          "20e: 4 of 8 sessions cancelled mid-pipeline")
    check(all(r["stats"]["failed"] == 0 and r["stats"]["matched"] == n
              for r in done), "20e: the other 4 complete, failed == 0")
    err = max(max_err(r["entities"], done[0]["entities"]) for r in done)
    check(err <= PIPE_TOL, f"20e: survivors agree ({err:.3g})")
    check(drained == (0, 0, 0, 0),
          "20e: no remote, queue, device or session work left")
    check(adm["inflight"] == 0 and adm["pending"] == 0,
          "20e: admission inflight 0")
    leaked = _leaked_threads(threads0)
    check(not leaked, f"20e: threads back to the count before ({leaked})")
    raw, mem1 = card_bytes()
    print(f"  20e: memory_allocated {mem0} -> {mem1} bytes ({raw} with the "
          f"threads' cuBLAS workspaces)", flush=True)
    check(abs(mem1 - mem0) <= ALLOC_BLOCK,
          f"20e: device memory back to its level ({mem1 - mem0} bytes)")
    out["memory_delta_bytes"] = mem1 - mem0
    out["cublas_workspace_bytes"] = raw - mem1
    walls["20e"] = time.monotonic() - t0
    out["walls_s"] = walls
    print(f"  phase 20 walls (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f"; card: {smi}", flush=True)
    return out



# ------------------------------------------------------------ phase 21
# the real-size video run: 4 clips of 240x320x3 float32 frames, cut from
# the bench's 32 frames to 16 (59 MB on the card) to fit the phase's
# budget: the frame baseline's 20 ms a frame request dominates
BENCH_VIDEO = {"real": {"n_videos": 4, "frames": 16, "size": (240, 320)}}


def phase_benches(device="cuda", smi="", video=None, timing_gates=True,
                  report=True):
    """Phase 21: the reference's benches on the port, each run as its
    ``--check-baseline`` runs it (``benchmarks/torch_*.py``, smoke sizes)
    and failing on any gate: (a) dispatch — the three placement modes
    identical with qwen3-0.6b's model UDF at full width on the card,
    the device arm and the fused segment within ``rtol`` 1e-5 / ``atol``
    1e-6 of all-native and per-op, the static hash; (b) admission — the
    ``f9acbed1…`` hash, queue equal to none, in-flight bounded, shed
    p99 within 3× of uncontended; (c) resilience — the fault-off hash,
    completion 1.0, no failed entity, no leak, peak ≤ cap, p99 factor ≤
    25; (d) hot path — the cache and coalescing responses identical to
    their baselines; (e) front end — the wire hash, wire = in process,
    ``retry_after_s`` positive and finite, the cache served while
    saturated; (f) serving — batched tokens equal to sequential ones,
    the native pool's responses equal to one worker's; (g) the video
    suite at ``run.py --full``'s sizes, cputrace, and C1 and C2 at
    ``video``'s real size, every system within 1e-5 of the async
    engine.  ``timing_gates=False`` (CPU rehearsals) leaves out the two
    gates read off wall clocks; ``report`` writes each bench's payload
    to ``chiprun_out/torch_<bench>.json``."""
    from benchmarks import (torch_admission_bench, torch_dispatch_bench,
                            torch_frontend_bench, torch_hotpath,
                            torch_resilience_bench, torch_serving_bench,
                            torch_video_suite)
    print(f"phase 21: the reference's benches on the port; card: {smi}",
          flush=True)
    timing = {"timing": timing_gates}
    video_suite = functools.partial(
        torch_video_suite.run_suite, smoke=False,
        sizes=BENCH_VIDEO if video is None else video)
    benches = [  # (step, key, module, its run, its gates' options)
        ("a", "dispatch", torch_dispatch_bench, torch_dispatch_bench.run, {}),
        ("b", "admission", torch_admission_bench, torch_admission_bench.run,
         timing),
        ("c", "resilience", torch_resilience_bench,
         torch_resilience_bench.run, timing),
        ("d", "hotpath", torch_hotpath, torch_hotpath.run, {}),
        ("e", "frontend", torch_frontend_bench, torch_frontend_bench.run, {}),
        ("f", "serving", torch_serving_bench, torch_serving_bench.run_suite,
         {}),
        ("g", "video", torch_video_suite, video_suite, {"device": device}),
    ]
    walls, out = {}, {}
    for step, key, bench, run, gate_kw in benches:
        t0 = time.monotonic()
        rows = run(device=device, report=report)
        for line in bench.headline(rows):
            print(f"  21{step} {line}", flush=True)
        walls[key] = time.monotonic() - t0
        failures = bench.gates(rows, **gate_kw)
        check(not failures, f"21{step} {key}: "
              + ("; ".join(failures) or "every gate holds"))
        out[key] = rows
    out["walls_s"] = walls
    print("  phase 21 walls (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f"; card: {smi}", flush=True)
    return out


# ------------------------------------------------------------ phase 22
# the examples' sizes beyond their own defaults: train_lm's --full-100m
# run (then a rerun that resumes from its last checkpoint) and the
# scale-out curve at two kappas (phase 10 runs kappa 1-64)
EXAMPLES = {"quickstart": [], "serve": [],
            "train": {"args": ["--full-100m", "--batch", "8", "--seq", "128",
                               "--save-every", "5"],
                      "steps": 10, "resume_steps": 12},
            "scaleout": ["--kappas", "1", "4", "--images", "64",
                         "--clients", "4"]}


def load_example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(device="cuda", sizes=None) -> dict:
    """Phase 22a: the four examples (``examples/torch_*.py``), each
    through its ``main`` on ``device`` at its own sizes (``sizes`` maps
    an example to its arguments, ``EXAMPLES`` by default): the quickstart
    (0 failed, the thresholded output binary), serve_visual_queries at
    full width on the card (0 failed, every clip stamped, the warm wave
    all full cache hits), train_lm (finite losses, its checkpoints, and
    a rerun resuming from the last) and scaleout_bench (a row per
    kappa: ``run_kappa`` raises on a short or failed response)."""
    import tempfile
    sizes = {**EXAMPLES, **(sizes or {})}
    dev = ["--device", device]
    out, walls = {}, {}

    t0 = time.monotonic()
    q = load_example("torch_quickstart").main(dev + sizes["quickstart"])
    walls["quickstart"] = time.monotonic() - t0
    check(q["matched"] > 0 and q["failed"] == 0 and q["session_failed"] == 0
          and q["streamed"] == q["matched"],
          f"22a quickstart: {q['matched']} matched, 0 failed, each "
          "streamed")
    check(set(q["values"]) <= {0.0, 1.0}, "22a quickstart: the output "
          f"after the threshold is binary ({q['values']})")
    out["quickstart"] = {k: q[k] for k in ("matched", "failed", "duration_s",
                                           "streamed", "values")}

    t0 = time.monotonic()
    v = load_example("torch_serve_visual_queries").main(dev + sizes["serve"])
    walls["serve"] = time.monotonic() - t0
    per_session = len(v["entities"])
    check(v["failed"] == 0 and v["warm_failed"] == 0 and per_session > 0,
          f"22a serve_visual_queries: {v['clips']} clips, 0 failed")
    check(all(n > 0 for n in v["stamped_pixels"].values()),
          "22a serve_visual_queries: every clip stamped by the model "
          f"UDF (pixels {sorted(v['stamped_pixels'].values())})")
    check(v["warm_hits"] == v["warm_sessions"] * per_session,
          f"22a serve_visual_queries: the warm wave's {v['warm_hits']} full "
          f"cache hits = {v['warm_sessions']} sessions x {per_session}")
    out["serve"] = {k: v[k] for k in ("setup_s", "cold_s", "warm_s", "clips",
                                      "warm_hits", "stamped_pixels")}

    t0 = time.monotonic()
    train, tr = sizes["train"], load_example("torch_train_lm")
    with tempfile.TemporaryDirectory() as ckpt:
        args = dev + train["args"] + ["--ckpt-dir", ckpt]
        first = tr.main(args + ["--steps", str(train["steps"])])
        saved = sorted(os.listdir(ckpt))
        again = tr.main(args + ["--steps", str(train["resume_steps"])])
    walls["train"] = time.monotonic() - t0
    check(first["start_step"] == 0 and first["steps"] == train["steps"]
          and all(map(math.isfinite, first["losses"])),
          f"22a train_lm {first['arch']}: {first['steps']} steps, finite "
          f"losses ({first['losses'][0]:.4f} -> {first['final_loss']:.4f})")
    check(f"step_{train['steps']:08d}" in saved,
          f"22a train_lm: checkpoints written ({saved})")
    check(again["start_step"] == train["steps"]
          and again["steps"] == train["resume_steps"] - train["steps"]
          and all(map(math.isfinite, again["losses"])),
          f"22a train_lm: the rerun resumed from step {again['start_step']} "
          f"and took {again['steps']} finite steps")
    out["train"] = {"arch": first["arch"], "losses": first["losses"],
                    "step_s": first["step_s"], "checkpoints": saved,
                    "resumed_losses": again["losses"],
                    "resumed_step_s": again["step_s"]}

    t0 = time.monotonic()
    rows = load_example("torch_scaleout_bench").main(
        dev + sizes["scaleout"])["rows"]
    walls["scaleout"] = time.monotonic() - t0
    kappas = [int(r["name"].split("_k")[1]) for r in rows]
    check(len(rows) >= 2 and all(r["wall_s"] > 0 for r in rows),
          f"22a scaleout_bench: every query of kappa {kappas} completed")
    out["scaleout"] = rows
    out["walls_s"] = walls
    print("  22a walls (s): " + ", ".join(f"{k} {w:.3f}"
                                          for k, w in walls.items())
          + f"; quickstart {q['matched']} matched; serve cold "
          f"{v['cold_s']:.3f} s, warm {v['warm_s'] * 1e3:.3f} ms, "
          f"{v['warm_hits']} hits; train losses {first['losses'][0]:.4f} "
          f"-> {again['final_loss']:.4f}, median step "
          f"{statistics.median(first['step_s']) * 1e3:.3f} ms; kappa gains "
          + ", ".join(f"{k}: {r['gain']:.3f}" for k, r in zip(kappas, rows)),
          flush=True)
    return out


def phase_roofline(dryrun) -> dict:
    """Phase 22b: the roofline suite (``benchmarks/torch_{roofline,
    report}.py``) over phase 19's records: 19a's production-mesh records
    through ``build_table`` (each row's counted terms must equal its
    record's), the report's table and summary; and each 19b cell's
    analytic terms (``analytic_cell`` on its (1, 1) mesh) printed beside
    its counted terms and the card's median wall, with no limit."""
    import tempfile
    from benchmarks import torch_report, torch_roofline
    from repro_torch.configs import get_arch
    out = {"rows": [], "cells": []}
    with tempfile.TemporaryDirectory() as d:
        for rec in dryrun["production"]:
            path = os.path.join(d, f"{rec['arch']}__{rec['shape']}__"
                                f"{rec['mesh']}.json")
            with open(path, "w") as f:
                json.dump(rec, f)
        for rec in dryrun["production"]:
            rows = [r for r in torch_roofline.build_table(d, rec["mesh"])
                    if (r["arch"], r["shape"]) == (rec["arch"], rec["shape"])]
            label = f"22b {rec['arch']} {rec['shape']} on {rec['mesh']}"
            check(len(rows) == 1 and all(
                rows[0][f"counted_{k}_s"] == rec[f"{k}_term_s"]
                for k in TERMS) and rows[0]["counted_bottleneck"]
                == rec["bottleneck"],
                f"{label}: the roofline row's counted terms are the "
                "record's")
            r = rows[0]
            print(f"  {label}: counted " + " / ".join(
                f"{r[f'counted_{k}_s'] * 1e3:.6f}" for k in TERMS)
                + " ms, adjusted " + " / ".join(
                f"{r[f'adj_{k}_s'] * 1e3:.6f}" for k in TERMS)
                + f" ms -> {r['adj_bottleneck']}; roofline fraction "
                f"{r['roofline_fraction']:.6f}, useful ratio "
                f"{r['useful_ratio']:.6f}, {r['gib_per_dev']:.4f} GiB/dev",
                flush=True)
            out["rows"].append(r)
        out["summary"] = torch_report.summary(d)
        out["tables"] = {m: torch_report.table(d, m)
                         for m in sorted({r["mesh"]
                                          for r in dryrun["production"]})}
        out["run"] = torch_roofline.run(d)
    for line in out["summary"].splitlines():
        print(f"  22b {line}", flush=True)
    for cell in dryrun["cells"]:
        cfg = get_arch(cell["arch"], reduced=cell["reduced"])
        a = torch_roofline.analytic_cell(cfg, dryrun_shape(*cell["cell"]),
                                         dp=1, tp=1)
        bound = max(a[f"{k}_s"] for k in TERMS)
        counted = max(cell["terms_s"].values())
        row = {"arch": cell["arch"], "shape": cell["shape"],
               "analytic_s": {k: a[f"{k}_s"] for k in TERMS},
               "analytic_flops": a["flops"], "analytic_hbm_bytes": a["hbm_bytes"],
               "counted_s": cell["terms_s"], "counted_flops": cell["flops"],
               "counted_hbm_bytes": cell["hbm_bytes"], "wall_s": cell["wall_s"],
               "wall_over_analytic": cell["wall_s"] / bound,
               "wall_over_counted": cell["wall_s"] / counted}
        print(f"  22b {cell['arch']} {cell['shape']} on 1 x 1: analytic "
              + " / ".join(f"{a[f'{k}_s'] * 1e3:.6f}" for k in TERMS)
              + f" ms ({a['flops']:.6g} FLOPs, {a['hbm_bytes']:.6g} B); "
              "counted " + " / ".join(f"{cell['terms_s'][k] * 1e3:.6f}"
                                      for k in TERMS)
              + f" ms ({cell['flops']:.6g} FLOPs, {cell['hbm_bytes']:.6g} "
              f"B); wall {cell['wall_s'] * 1e3:.3f} ms = "
              f"{row['wall_over_analytic']:.3f} x the analytic bound, "
              f"{row['wall_over_counted']:.3f} x the counted one", flush=True)
        out["cells"].append(row)
    return out


# ------------------------------------------------------------ phase 23
F8_ARCH = "qwen1.5-32b"
# a float8 (e4m3) cache against a bfloat16 one, the decode logits: the
# JAX package's own bounds (tests/test_distributed.py::
# test_f8_kv_cache_decode_close_to_bf16)
F8_MAX_DIFF, F8_MIN_CORR = 0.2, 0.99
# At full width the float8 and bfloat16 decode logits lie 0.367 apart
# (max |d|, logits up to 7.4; correlation 0.9986; on an H100 80GB HBM3
# at 700 W): the reference's 0.2 was set on its reduced model, whose
# logits reach 0.6.  So the phase holds the card's float8 decode against
# the same weights' float8 decode on the host instead, at a 2 x 64-token
# prompt into 81 slots: the two round the same float32 keys and values
# to e4m3, and values that float32 sums in another order leave an ulp
# apart can round to neighbouring e4m3 steps, so the gap is a part of
# what float8 moves in all; the bound is half the reference's bound on
# that (0.2).  The correlation bound still holds and is kept.
F8_HOST_PROMPT, F8_HOST_TOL = 64, 0.1
# phase 23's run: 2 x 1,536 prompt tokens into 1,553 slots (past 1,024:
# K3 on every prefill layer), one decode step on each cache, then 15
# greedy steps on the float8 one; qwen1.5-32b cut to 2 of its 64 layers
F8_RUN = dict(batch=2, prompt=1536, greedy=15, layers=2)


def f8_decode(api, params, toks, slots, cache_dtype):
    """Prefill ``toks[:, :-1]`` into ``slots`` slots of a ``cache_dtype``
    cache and take one decode step on the last token: its logits."""
    from repro_torch.distributed.sharding import REPLICATED
    S = toks.shape[1] - 1
    _, cache = api.prefill(params, {"tokens": toks[:, :S]}, REPLICATED,
                           slots, cache_dtype=cache_dtype)
    d, _ = api.decode_step(params, toks[:, S:], cache, S, REPLICATED)
    return d.float()


def phase_f8_cache(launches, smi="", device="cuda", reduced=False, run=None):
    """Phase 23: qwen1.5-32b's float8 serving cache at its published
    widths (cut in depth to ``run["layers"]`` layers), drawn on the card
    from a seeded generator.  Prefill ``batch`` x ``prompt`` tokens into
    ``prompt + greedy + 2`` slots with a bfloat16 and then a float8 cache,
    take one decode step on each, then ``greedy`` greedy steps on the
    float8 one.  Checks: (a) each float8 cache tensor takes half the
    bytes of its bfloat16 counterpart; (b) the float8 decode logits
    against the bfloat16 ones correlated above ``F8_MIN_CORR`` (their
    max |d| is printed against ``F8_MAX_DIFF``, which full width does
    not meet), and the card's float8 decode within ``F8_HOST_TOL`` of the
    host's from the same weights at ``F8_HOST_PROMPT`` prompt tokens;
    (c) K3 launched in each prefill (counted on ``launches``; the route
    ``flash_vjp._wide`` picks for the mixed operands is printed); (d) the
    greedy tokens finite and below the vocabulary.  Prints the walls,
    tokens/s and peak memory beside ``smi``.  ``device``, ``reduced`` and
    ``run`` let a host without a card rehearse it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import REPLICATED
    from repro_torch.kernels.flash_vjp import _wide
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.serving.serve_step import sample_token
    run = dict(F8_RUN, **(run or {}))
    on_card = device == "cuda"
    cfg = get_arch(F8_ARCH, reduced=reduced)
    cfg = cfg.replace(num_layers=min(run["layers"], cfg.num_layers))
    B, S, G = run["batch"], run["prompt"], run["greedy"]
    slots = S + G + 2
    print(f"phase 23: {cfg.name}'s float8 cache, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads of {cfg.d_model // cfg.num_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.num_layers} layers; "
          f"{B} x {S} tokens into {slots} slots; card: {smi}", flush=True)
    check(cfg.serve_cache_dtype == "float8_e4m3fn",
          f"{F8_ARCH} serves with a float8 cache ({cfg.serve_cache_dtype})")
    api = get_model(cfg)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=device).manual_seed(23))
    if on_card:
        torch.cuda.synchronize()
    out = {"arch": cfg.name, "layers": cfg.num_layers, "slots": slots,
           "init_s": time.perf_counter() - t0,
           "params": sum(t.numel() for t in tree_leaves(params)),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params))}
    print(f"  {out['params']} parameters ({out['param_bytes'] / 1e9:.3f} GB) "
          f"drawn in {out['init_s']:.3f} s", flush=True)
    toks = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)).to(device)
    k3 = launches["flash_attention"]

    def synced():
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    caches, decodes = {}, {}
    with torch.no_grad():
        for label, dtype in (("bf16", torch.bfloat16),
                             ("f8", torch.float8_e4m3fn)):
            before, t0 = k3.count, synced()
            _, cache = api.prefill(params, {"tokens": toks[:, :S]},
                                   REPLICATED, slots, cache_dtype=dtype)
            t1 = synced()
            n = k3.count - before
            d, cache = api.decode_step(params, toks[:, S:S + 1], cache, S,
                                       REPLICATED)
            t2 = synced()
            route = _wide(d.new_empty(0), cache["k"], cache["v"])
            out[label] = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                          "prefill_tokens_per_s": B * S / (t1 - t0),
                          "k3_launches": n, "k3_operands": str(route),
                          "cache_bytes": sum(t.numel() * t.element_size()
                                             for t in cache.values()),
                          "cache_dtype": str(cache["k"].dtype)}
            print(f"  {label} cache: prefill {out[label]['prefill_s']:.6f} s "
                  f"({out[label]['prefill_tokens_per_s']:.1f} tokens/s), one "
                  f"decode step {out[label]['decode_s']:.6f} s; K3 launches "
                  f"{n}, its operands run in {route} (_wide of the queries' "
                  f"{d.dtype} and the cache's {cache['k'].dtype}); cache "
                  f"{out[label]['cache_bytes']} bytes; card: {smi}",
                  flush=True)
            check(cache["k"].dtype == dtype and cache["v"].dtype == dtype,
                  f"the {label} cache holds {dtype}")
            check(not on_card or n > 0,
                  f"(c) K3 launched in the {label} prefill past 1,024 slots "
                  f"({n})")
            caches[label], decodes[label] = cache, d.float()
        # (a) half the bytes
        for key in caches["bf16"]:
            a, b = caches["f8"][key], caches["bf16"][key]
            check(a.shape == b.shape and 2 * a.numel() * a.element_size()
                  == b.numel() * b.element_size(),
                  f"(a) the float8 cache's {key} takes half the bytes of "
                  f"the bfloat16 one ({a.numel() * a.element_size()} against "
                  f"{b.numel() * b.element_size()})")
        # (b) the float8 decode against the bfloat16 decode
        d8, d16 = decodes["f8"], decodes["bf16"]
        diff = float((d8 - d16).abs().max())
        corr = float(torch.corrcoef(torch.stack([d8.reshape(-1),
                                                 d16.reshape(-1)]))[0, 1])
        out["f8_vs_bf16"] = {"max_abs_diff": diff, "corr": corr,
                             "logit_absmax": float(d16.abs().max())}
        print(f"  float8 against bfloat16 decode logits: max |d| {diff:.6g}"
              f" (the reference's bound {F8_MAX_DIFF}: "
              f"{'met' if diff < F8_MAX_DIFF else 'not met'}), correlation "
              f"{corr:.6f} (> {F8_MIN_CORR}); logits up to "
              f"{out['f8_vs_bf16']['logit_absmax']:.4g}", flush=True)
        check(corr > F8_MIN_CORR, f"(b) float8 against bfloat16 decode "
              f"logits: correlation {corr:.6f} > {F8_MIN_CORR}")
        # the same weights on the host: its float8 decode against the
        # card's, a shorter prompt
        hp = min(F8_HOST_PROMPT, S)
        short = toks[:, :hp + 1]
        card = f8_decode(api, params, short, hp + 17,
                         torch.float8_e4m3fn).cpu()
        host_params = tree_map(lambda t: t.to("cpu", copy=True), params)
        t0 = time.perf_counter()
        host = f8_decode(api, host_params, short.cpu(), hp + 17,
                         torch.float8_e4m3fn)
        del host_params
        gap = float((card - host).abs().max())
        out["f8_card_vs_host"] = {"prompt": hp, "slots": hp + 17,
                                  "max_abs_diff": gap,
                                  "logit_absmax": float(host.abs().max()),
                                  "host_s": time.perf_counter() - t0}
        print(f"  float8 decode, card against host from the same weights, "
              f"{B} x {hp} tokens into {hp + 17} slots: "
              f"{out['f8_card_vs_host']}", flush=True)
        check(gap <= F8_HOST_TOL, f"(b) the card's float8 decode logits "
              f"within {F8_HOST_TOL} of the host's ({gap:.4g})")
        del caches["bf16"]
        # (d) greedy steps on the float8 cache
        cache, gen = caches["f8"], []
        tok = sample_token(decodes["f8"], None, 0.0, cfg.vocab_size)
        t0 = synced()
        for i in range(G):
            gen.append(tok)
            lg, cache = api.decode_step(params, tok, cache, S + 1 + i,
                                        REPLICATED)
            tok = sample_token(lg, None, 0.0, cfg.vocab_size)
        t1 = synced()
        gen = torch.cat(gen, dim=1).cpu()
        finite = bool(torch.isfinite(lg).all())
    out["greedy"] = {"steps": G, "decode_s": t1 - t0,
                     "tokens_per_s": B * G / (t1 - t0),
                     "tokens": gen.tolist()}
    print(f"  {G} greedy steps on the float8 cache: {t1 - t0:.6f} s, "
          f"{out['greedy']['tokens_per_s']:.3f} tokens/s; card: {smi}",
          flush=True)
    check(finite and gen.shape == (B, G) and bool((gen >= 0).all())
          and bool((gen < cfg.vocab_size).all()),
          f"(d) the greedy tokens: shape ({B}, {G}), finite logits, inside "
          f"the vocabulary of {cfg.vocab_size}")
    if on_card:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        print(f"  peak device memory {out['peak_memory_bytes'] / 2**30:.3f} "
              f"GiB; card: {smi}", flush=True)
    del params, caches, cache
    return out


def check_held(held, phase, counts) -> list:
    """Every K1 and K2 launch of an engine phase went through the held
    wrappers, and each kernel's output at each shape it was given there
    equals (K1) or is within ``K2_TOL`` of (K2) the plain version."""
    for kind, name in (("K1", "gaussian_blur"),
                       ("K2", "fused_resize_crop_normalize")):
        check(held.launches(kind) == counts[name],
              f"phase {phase}: {name}'s {counts[name]} launches all held "
              f"({held.launches(kind)})")
    return held.check(phase)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise SmokeFailure("nvidia-smi printed nothing")
    return out[0]


def ptxas_summary(log: str) -> dict:
    """The spills and the serialized ``wgmma`` that ``-Xptxas -v``
    reports over every kernel of one library: bytes of spill stores and
    loads summed, and the kernels whose products ptxas serialized
    (C7510-C7518, "wgmma.mma_async instructions are serialized")."""
    import re
    stores = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log))
    loads = sum(int(m) for m in re.findall(r"(\d+) bytes spill loads", log))
    serialized = len(set(re.findall(
        r"instructions are serialized.*?function '([^']+)'", log)))
    return {"spill_store_bytes": stores, "spill_load_bytes": loads,
            "wgmma_serialized": serialized}


def main() -> int:
    import torch
    if len(sys.argv) == 6 and sys.argv[1] == "--tp-rank":
        return tp_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                            sys.argv[5] == "reduced")
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) >= 3 and sys.argv[1] == "--ab":
        smi = nvidia_smi_line()
        rows = phase_ab(os.path.abspath(sys.argv[2]), sys.argv[3:])
        print(smi)
        print(json.dumps({"ab": rows}))
        return 0
    t_start = time.monotonic()
    from benchmarks import torch_suite
    from repro_torch.core.engine import VDMSAsyncEngine
    from repro_torch.core.remote import TransportModel
    from repro_torch.dataio.synthetic import synthetic_faces
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gaussian_blur as gb
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import preprocess as pp
    from repro_torch.kernels import rwkv6_scan as wkv

    print("phase 1: build and identify", flush=True)
    t0 = time.monotonic()
    paths = _build.build_all()
    build_s = time.monotonic() - t0
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text()
        report = [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"  built {name} -> {path.name}: " + " | ".join(report),
              flush=True)
        ptxas[name] = ptxas_summary(log)
        print(f"  {name}: {ptxas[name]['spill_store_bytes']} bytes of spill "
              f"stores, {ptxas[name]['spill_load_bytes']} of spill loads; "
              f"wgmma serialized in {ptxas[name]['wgmma_serialized']} "
              "kernels", flush=True)
    print(f"  build {build_s:.3f} s", flush=True)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"  card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {count} device(s)", flush=True)

    faces64 = synthetic_faces(64, 250, seed=0)
    faces256 = synthetic_faces(256, 250, seed=1)
    launches = {"gaussian_blur": gb.launches,
                "fused_resize_crop_normalize": pp.launches,
                "mamba2_ssd": ssd.launches,
                "mamba2_ssd_backward": ssd.backward_launches,
                "rwkv6_scan": wkv.launches,
                "rwkv6_scan_backward": wkv.backward_launches,
                "flash_attention": fa.launches,
                "flash_attention_backward": fa.backward_launches}
    engine_path = ("gaussian_blur", "fused_resize_crop_normalize")

    # ---- the engine's image path: counts zeroed just before, read just after
    for c in launches.values():
        c.reset()
    details = {"build_s": build_s, "card": smi, "ptxas": ptxas}
    details["static_hash"] = phase_static_hash(VDMSAsyncEngine, TransportModel)
    details["native"] = phase_native(VDMSAsyncEngine, TransportModel,
                                     faces64, launches)
    details["device"] = phase_device(VDMSAsyncEngine, TransportModel,
                                     faces256, launches)
    main_launches = {k: launches[k].count for k in engine_path}
    print(f"  engine-path launches: {main_launches}", flush=True)
    for name, n in main_launches.items():
        check(n > 0, f"{name} launched on the engine path ({n})")

    entries, rows = phase_kernels()
    details["kernels"] = rows

    # ---- the model paths, each with its kernel: counts zeroed just
    # before each, read just after it
    path_launches = dict(main_launches)
    model_paths = [
        ("model", 6, dict(arch=ARCH, kernel="mamba2_ssd",
                          beyond=(2, 1536, 16))),
        ("rwkv", 7, dict(arch=RWKV_ARCH, kernel="rwkv6_scan")),
        ("long_context", 8, dict(arch=LONG_ARCH, kernel="flash_attention",
                                 requests=4, prompt_len=4096, gen=16,
                                 consistency=(1, 2048, 4), n_images=0)),
        ("moe", 11, dict(arch=MOE_ARCH, kernel="flash_attention",
                         beyond=(2, 1536, 16), n_images=0,
                         check_cfg=no_drop_moe(MOE_ARCH))),
        ("encdec", 12, dict(arch=ENCDEC_ARCH, kernel="flash_attention",
                            requests=16, prompt_len=32, gen=16)),
        ("vit_stub", 13, dict(arch=VLM_ARCH, kernel="flash_attention",
                              requests=4, prompt_len=1024, gen=16,
                              consistency=(1, 1024, 4))),
        ("dense_8b", 14, dict(arch=DENSE_ARCH, kernel="flash_attention",
                              requests=2, prompt_len=1536, gen=16,
                              n_images=0, consistency=(1, 1100, 4))),
    ]
    for name in MODEL_KERNELS:
        path_launches[name] = 0
    for key, phase, kw in model_paths:
        for c in launches.values():
            c.reset()
        t0 = time.monotonic()
        details[key] = phase_model(launches, phase=phase, **kw)
        details[key]["phase_s"] = time.monotonic() - t0
        counts = {k: c.count for k, c in launches.items()}
        kernel = kw["kernel"]
        print(f"  phase {phase}: {details[key]['phase_s']:.3f} s; launches "
              f"{counts}", flush=True)
        check(counts[kernel] > 0,
              f"{kernel} launched on the {kw['arch']} path ({counts[kernel]})")
        for name in MODEL_KERNELS:
            path_launches[name] += counts[name]
        gc.collect()
        torch.cuda.empty_cache()

    # ---- training (K3 forward, and again under remat, beneath the
    # recomputing backward): counts zeroed just before, read just after
    for c in launches.values():
        c.reset()
    t0 = time.monotonic()
    details["training"] = phase_training(launches)
    details["training"]["phase_s"] = time.monotonic() - t0
    counts = {k: c.count for k, c in launches.items()}
    print(f"  phase 15: {details['training']['phase_s']:.3f} s; launches "
          f"{counts}", flush=True)
    for name in ("flash_attention", "flash_attention_backward"):
        check(counts[name] > 0, f"{name} launched on the training path "
              f"({counts[name]})")
        path_launches[name] += counts[name]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- training the hybrid and rwkv families (K4 and K5 under their
    # Functions, K3 at zamba2's shared attention): counts zeroed just
    # before, read just after
    for c in launches.values():
        c.reset()
    t0 = time.monotonic()
    details["scan_training"] = phase_scan_training(launches)
    details["scan_training"]["phase_s"] = time.monotonic() - t0
    counts = {k: c.count for k, c in launches.items()}
    print(f"  phase 16: {details['scan_training']['phase_s']:.3f} s; "
          f"launches {counts}", flush=True)
    for name in MODEL_KERNELS:
        check(counts[name] > 0, f"{name} launched on the scan families' "
              f"training path ({counts[name]})")
        path_launches[name] += counts[name]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the distribution substrate on one card
    t0 = time.monotonic()
    details["distribution"] = phase_distribution()
    details["distribution"]["phase_s"] = time.monotonic() - t0
    print(f"  phase 17: {details['distribution']['phase_s']:.3f} s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- tensor and expert parallelism, two ranks sharing the card: the
    # ranks' counts start at 0 in their processes and are read there at
    # the end of each run (the parent's model_par=1 runs are the
    # comparison and count in none)
    t0 = time.monotonic()
    details["tensor_parallel"] = phase_tensor_parallel()
    details["tensor_parallel"]["phase_s"] = time.monotonic() - t0
    print(f"  phase 18: {details['tensor_parallel']['phase_s']:.3f} s",
          flush=True)
    for name, n in details["tensor_parallel"]["launches"].items():
        path_launches[name] += n
    n = details["tensor_parallel"]["launches"]["flash_attention_backward"]
    check(n > 0, f"flash_attention_backward launched in phase 18 ({n})")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the dry run against the card: phase 19b's steps are main-path
    # runs (K3 in the train step, K5 in the prefill), the counts zeroed
    # just before each and read just after it
    t0 = time.monotonic()
    details["dryrun"] = phase_dryrun(launches)
    details["dryrun"]["phase_s"] = time.monotonic() - t0
    print(f"  phase 19: {details['dryrun']['phase_s']:.3f} s", flush=True)
    for row in details["dryrun"]["cells"]:
        for name in MODEL_KERNELS:
            path_launches[name] += row["launches"][name]
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the scale-out path (K2 then K1 behind every shard), then the
    # baselines (K1 in IQ3's remote servers): counts zeroed just before
    # each phase, read just after it
    phase4 = details["device"].pop("response")
    scaleout = [
        (9, "scaleout", engine_path, lambda: {
            "hash": phase_wire_hash(),
            **phase_cluster_chain(faces256, phase4, launches)}),
        (10, "baselines", ("gaussian_blur",), phase_baselines),
    ]
    for phase, key, need, run in scaleout:
        for c in launches.values():
            c.reset()
        t0 = time.monotonic()
        with HeldCalls() as held:
            details[key] = run()
        details[key]["phase_s"] = time.monotonic() - t0
        counts = {k: launches[k].count for k in engine_path}
        details[key]["held"] = check_held(held, phase, counts)
        print(f"  phase {phase}: {details[key]['phase_s']:.3f} s; launches "
              f"{counts}", flush=True)
        for name in need:
            check(counts[name] > 0,
                  f"{name} launched in phase {phase} ({counts[name]})")
        for name in engine_path:
            path_launches[name] += counts[name]
        details[key]["launches"] = counts
    print("  report: " + torch_suite.write_report(details["baselines"],
                                                  "cuda"), flush=True)

    # ---- the engine's behaviours (admission, dispatch, fusion, faults,
    # sessions): K1 and K2 on the device backend, counts zeroed just
    # before, read just after
    for c in launches.values():
        c.reset()
    t0 = time.monotonic()
    details["behaviours"] = phase_engine_behaviours(
        VDMSAsyncEngine, TransportModel, faces64, launches, smi=smi)
    details["behaviours"]["phase_s"] = time.monotonic() - t0
    counts = {k: launches[k].count for k in engine_path}
    print(f"  phase 20: {details['behaviours']['phase_s']:.3f} s; launches "
          f"{counts}", flush=True)
    for name in engine_path:
        check(counts[name] > 0, f"{name} launched in phase 20 ({counts[name]})")
        path_launches[name] += counts[name]
    details["behaviours"]["launches"] = counts

    # ---- the reference's benches: K1 and K2 behind the device backend,
    # K1 in the video suite and the native pool; counts zeroed just
    # before, read just after
    for c in launches.values():
        c.reset()
    t0 = time.monotonic()
    with HeldCalls() as held:
        details["benches"] = phase_benches(smi=smi)
    details["benches"]["phase_s"] = time.monotonic() - t0
    counts = {k: launches[k].count for k in engine_path}
    details["benches"]["held"] = check_held(held, 21, counts)
    print(f"  phase 21: {details['benches']['phase_s']:.3f} s; launches "
          f"{counts}", flush=True)
    for name in engine_path:
        check(counts[name] > 0, f"{name} launched in phase 21 ({counts[name]})")
        path_launches[name] += counts[name]
    details["benches"]["launches"] = counts

    # ---- the examples and the roofline suite: no kernel lies on their
    # paths (the quickstart has no blur, qwen3's prompts stay below 1,024
    # slots, train_lm runs at 128 tokens, the roofline is arithmetic);
    # the launches they make are counted, zeroed just before, read just
    # after
    for c in launches.values():
        c.reset()
    t0 = time.monotonic()
    print(f"phase 22: the examples and the roofline suite; card: {smi}",
          flush=True)
    with HeldCalls() as held:
        details["examples"] = phase_examples()
    details["examples"]["held"] = check_held(
        held, 22, {k: launches[k].count for k in engine_path})
    details["examples"]["roofline"] = phase_roofline(details["dryrun"])
    details["examples"]["phase_s"] = time.monotonic() - t0
    counts = {k: c.count for k, c in launches.items()}
    print(f"  phase 22: {details['examples']['phase_s']:.3f} s; launches "
          f"{counts}", flush=True)
    for name, n in counts.items():
        path_launches[name] += n
    details["examples"]["launches"] = counts
    gc.collect()
    torch.cuda.empty_cache()

    # ---- qwen1.5-32b's float8 serving cache at full width (K3 on every
    # prefill layer): counts zeroed just before, read just after
    for c in launches.values():
        c.reset()
    t0 = time.monotonic()
    details["f8_cache"] = phase_f8_cache(launches, smi=smi)
    details["f8_cache"]["phase_s"] = time.monotonic() - t0
    counts = {k: c.count for k, c in launches.items()}
    print(f"  phase 23: {details['f8_cache']['phase_s']:.3f} s; launches "
          f"{counts}", flush=True)
    check(counts["flash_attention"] > 0, "flash_attention launched in phase "
          f"23 ({counts['flash_attention']})")
    for name, n in counts.items():
        path_launches[name] += n
    details["f8_cache"]["launches"] = counts
    kernels = kernels_line(entries, path_launches)
    details["seconds"] = time.monotonic() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1, default=str)
    print(f"total {details['seconds']:.3f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
