"""User-defined operations (paper section 4.1).

UDFs plug into the engine with *no engine code changes*: register a
callable under a name; queries reference it with
``{"type": "udf", "port": ..., "options": {"id": "<name>", ...}}``.
In-process transport models the paper's message queue: the UDF executor
(repro_torch.core.remote.UDFProcess) pulls requests off a queue.Queue — the
same decoupling as the paper's separate-process design, minus the wire.

UDFs receive and return torch tensors on the engine's device.

Model UDFs: ``register_model_udf`` wraps an assigned-architecture LM
(via the serving layer) as a pipeline operation — the realistic
"run ML inference inside the query" case the paper motivates.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable

import torch

from repro_torch.core import spans

_REGISTRY: dict[str, Callable] = {}
_BATCHED: dict[str, Callable] = {}
_DEVICE: dict[str, Callable] = {}
_SERVED: dict[str, collections.deque] = {}
_LOCK = threading.Lock()
SERVED_KEPT = 1024     # calls a model UDF's device route keeps a report of


def register_udf(name: str, fn: Callable) -> None:
    """fn(img_or_frames, **options) -> transformed array."""
    with _LOCK:
        _REGISTRY[name] = fn


def register_batched_udf(name: str, fn: Callable) -> None:
    """Group-execution variant of a UDF: ``fn(list_of_images, **options)
    -> list_of_images``.  Registering one makes the op eligible for the
    batcher backend (repro_torch.serving.batcher.UDFBatcherBackend), which the
    cost router can then pick when amortizing a group beats per-entity
    execution.  MUST be result-equivalent to the per-entity UDF of the
    same name — the router treats backends as interchangeable."""
    with _LOCK:
        _BATCHED[name] = fn


def get_batched_udf(name: str) -> Callable:
    with _LOCK:
        return _BATCHED[name]


def has_batched_udf(name: str) -> bool:
    with _LOCK:
        return name in _BATCHED


def register_device_udf(name: str, fn: Callable) -> None:
    """Device-execution variant of a UDF: ``fn(list_of_images, **options)
    -> list_of_images``, where ``fn`` runs its math on the accelerator
    (the function owns its own device placement — typically one batched
    call over the whole micro-batch).  Registering
    one makes the op eligible for the device backend
    (:class:`repro_torch.query.device_backend.DeviceBackend`), which the cost
    router can then pick when device compute + transfer beats the other
    backends.  MUST be result-equivalent to the per-entity UDF of the
    same name — the router treats backends as interchangeable.  Native
    table ops (crop/resize/...) need no registration: the device backend
    runs them over the stacked batch directly."""
    with _LOCK:
        _DEVICE[name] = fn


def get_device_udf(name: str) -> Callable:
    with _LOCK:
        return _DEVICE[name]


def has_device_udf(name: str) -> bool:
    with _LOCK:
        return name in _DEVICE


def get_udf(name: str) -> Callable:
    from repro_torch.core.pipeline import BUILTIN_UDFS
    with _LOCK:
        if name in _REGISTRY:
            return _REGISTRY[name]
    if name in BUILTIN_UDFS:
        return BUILTIN_UDFS[name]
    raise KeyError(f"UDF {name!r} not registered")


def list_udfs() -> list[str]:
    from repro_torch.core.pipeline import BUILTIN_UDFS
    with _LOCK:
        return sorted(set(_REGISTRY) | set(BUILTIN_UDFS))


def unregister_udf(name: str) -> None:
    """Drop ``name`` from the per-entity, batched and device registries,
    and with it what its functions hold (a model UDF's parameters on the
    card).  Unknown names are ignored."""
    with _LOCK:
        for registry in (_REGISTRY, _BATCHED, _DEVICE, _SERVED):
            registry.pop(name, None)


def served_calls(name: str) -> list[dict]:
    """The last :data:`SERVED_KEPT` calls the device route of model UDF
    ``name`` served, oldest first: per call ``rows``, ``prompt`` (the
    (rows, S) prompt tokens the prefill was fed), ``tokens`` (the
    (rows, steps) greedy tokens, one column a step) and ``passes``
    (``(rows, new tokens, cached positions, positions whose logits are
    taken)`` per model pass), the tensors on the model's device.  Logits
    are not kept."""
    with _LOCK:
        calls = list(_SERVED.get(name, ()))
    return [dict(c, tokens=torch.cat(c["tokens"], 1)) for c in calls]


def patch_embeds(img: torch.Tensor, cfg) -> torch.Tensor:
    """A ``vit_stub`` model's (P, d_model) patch embeddings of an (H, W,
    3) image: the JAX package's ``jax.image.resize(img, (P, 8, 3),
    "linear")`` (antialiased when it shrinks), flattened to (P, 24),
    tiled across ``d_model`` and scaled by 0.02."""
    from repro_torch.visual.ops import resize_hw
    P = cfg.num_patches
    pe = resize_hw(img, P, 8, "linear").reshape(P, -1)
    pe = pe.repeat(1, cfg.d_model // pe.shape[-1] + 1)[:, :cfg.d_model]
    return pe * 0.02


def prompt_tokens(img: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The model UDF's prompt, (C,) int32 on the image's device: the JAX
    package's ``feats_of`` — truncate ``img*255`` to int32, take the
    float32 mean over H and W, clip to the vocabulary, truncate.  The sum
    is taken in int64 (exact) and divided in float32, which is the
    float32 mean exactly wherever the float32 sum is exact (sums below
    2^24: any image up to 256x256)."""
    q = (img * 255).to(torch.int32)
    total = q.to(torch.int64).sum(dim=(0, 1)).to(torch.float32)
    mean = total / float(q.shape[0] * q.shape[1])
    return torch.clamp(mean, 0, vocab_size - 1).to(torch.int32)


def register_model_udf(name: str, arch: str = "qwen3-0.6b", *,
                       steps: int = 4, reduced: bool = True,
                       labels=("WALK", "RUN", "JUMP", "SIT"),
                       device="cuda", params=None) -> None:
    """Register an assigned-architecture LM as a classification UDF.

    The image is hashed into a short token prompt; the LM decodes a few
    tokens and the argmax bucket picks a label stamped onto the image.
    The model runs on ``device`` (the CUDA card unless the caller asks
    for the CPU) with ``params`` (a tree on that device, e.g. from
    :func:`repro_torch.interop.params_from_jax`), or, when ``params`` is
    None, the port's own seeded init.  Three routes are registered, all
    stamping the same label (greedy decoding): per entity, grouped
    behind a :class:`~repro_torch.serving.batcher.GroupBatcher` (the
    batcher backend), and one prefill + decode over the whole
    micro-batch (the device backend).  A ``vit_stub`` model registers
    the per-entity route alone (its prompt carries :func:`patch_embeds`
    of the image).  An encoder-decoder's grouped and device routes feed
    zero frames; its per-entity route feeds none, and raises
    ``KeyError('frames')``, as the JAX package's does.  An image on the
    card given to a model on the CPU raises: nothing moves the card's
    work to the CPU.
    """
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.boundary import resolve_device
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.models import get_model
    from repro_torch.models.lm import tree_leaves
    from repro_torch.serving.batcher import GroupBatcher
    from repro_torch.serving.serve_step import (greedy_generate,
                                                make_serve_fns, sample_token)
    from repro_torch.visual.font import draw_text

    dev = resolve_device(device)
    cfg = get_arch(arch, reduced=reduced)
    model = get_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    elif any(leaf.device != dev for leaf in tree_leaves(params)):
        raise ValueError(f"params must lie on the model's device {dev}")
    sh = ShardingCtx(mesh=None)
    lock = threading.Lock()

    def feats_of(img):
        if img.is_cuda and dev.type != "cuda":
            raise ValueError("the model UDF got an image on the card and "
                             "serves its model on the CPU; register it "
                             "with device='cuda'")
        return prompt_tokens(img, cfg.vocab_size)

    def label_of(tok) -> str:
        return labels[int(tok) % len(labels)]

    def udf(img, **_):
        prompt = {"tokens": feats_of(img)[None, :].to(dev)}
        if cfg.frontend == "vit_stub":
            prompt["patch_embeds"] = patch_embeds(img.to(dev), cfg)[None]
        with lock:  # model params shared across engine threads
            toks = greedy_generate(model, params, prompt, steps=steps, sh=sh)
        return draw_text(img, label_of(toks[0, -1]), 4, 4)

    register_udf(name, udf)
    if cfg.frontend == "vit_stub":
        # the per-entity prompt carries image-derived patch embeddings,
        # which a group's prefill does not: no grouped or device route
        return

    # Grouped serving path: the same model behind a GroupBatcher, so the
    # dispatch router can amortize prefill+decode over a group instead of
    # paying full inference per entity.  Greedy decoding (temperature 0)
    # makes batched == sequential token-for-token, so the label — the
    # argmax bucket of the LAST decoded token — is identical to the
    # per-entity UDF.  An encoder-decoder's group gets zero frames.
    batcher = GroupBatcher(model, params, group_size=8,
                           max_new_default=steps, sh=sh, temperature=0.0)

    def batched(imgs, **_):
        with lock:
            reqs = [batcher.submit(feats_of(img).cpu().numpy(),
                                   max_new=steps) for img in imgs]
            batcher.run_until_idle()
        return [draw_text(img, label_of(r.result(30)[-1]), 4, 4)
                for img, r in zip(imgs, reqs)]

    register_batched_udf(name, batched)

    # Device-backend path: the same model as ONE prefill + decode over
    # the whole micro-batch, built on the serving layer's serve_step fns.
    # Greedy decoding again keeps the result token-for-token identical
    # to the per-entity UDF.  Each call is recorded in the spans of the
    # engine whose device backend runs it (udf.*) and reported by
    # served_calls(name).
    prefill_fn, serve_step = make_serve_fns(model, sh)
    served = collections.deque(maxlen=SERVED_KEPT)

    def device_batched(imgs, **_):
        rec = spans.current()
        rows = len(imgs)
        with rec.span("udf.call"):
            with lock:
                with rec.span("udf.prompts"):
                    toks = torch.stack([feats_of(img).to(dev)
                                        for img in imgs])
                batch = {"tokens": toks}
                if cfg.is_encoder_decoder:
                    batch["frames"] = torch.zeros(
                        (rows, cfg.encoder_seq_len, cfg.d_model),
                        dtype=torch.float32, device=dev)
                prompt_len = toks.shape[1]
                passes = [(rows, prompt_len, 0, 1)]
                with rec.span("udf.prefill"):
                    logits, cache = prefill_fn(params, batch,
                                               prompt_len + steps + 1)
                    tok = sample_token(logits, None, 0.0, cfg.vocab_size)
                greedy = [tok]
                for i in range(steps - 1):
                    with rec.span("udf.decode"):
                        logits, cache = serve_step(params, tok, cache,
                                                   prompt_len + i)
                        tok = sample_token(logits, None, 0.0,
                                           cfg.vocab_size)
                    passes.append((rows, 1, prompt_len + i, 1))
                    greedy.append(tok)
                with rec.span("udf.sync"):
                    last = tok[:, 0].cpu().numpy()
                served.append({"rows": rows, "prompt": toks,
                               "tokens": greedy, "passes": passes})
            with rec.span("udf.stamp"):
                out = [draw_text(img, label_of(t), 4, 4)
                       for img, t in zip(imgs, np.asarray(last))]
        rec.count("udf.rows", rows)
        rec.count("udf.prefill_tokens", rows * prompt_len)
        rec.count("udf.decode_tokens", rows * (steps - 1))
        return out

    register_device_udf(name, device_batched)
    with _LOCK:
        _SERVED[name] = served
