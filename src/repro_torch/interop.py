"""State carried across from the JAX package.

An engine's state is its data: metadata rows and blobs.
:func:`engine_state` reads them from an engine of the JAX package (its
``meta.find``/``store.get`` layout) as ``(eid, kind, array,
properties)`` records, and :func:`ingest_reference_state` ingests such
records into a port engine keeping their eids, so the two engines
answer one query over the same data.

A model's state is its parameters: :func:`params_from_jax` turns the JAX
package's parameter tree (an LM's or an encoder-decoder's) (as numpy arrays) into the port's, so both
packages compute the same function in the parity tests, and
:func:`train_state_from_jax` does the same for a train state.  Given a
mesh (and rules), either gives this rank's shards of the tree, as its
specs name them.
"""
from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

KINDS = ("image", "video")


def engine_state(engine, kinds=KINDS) -> Iterator[tuple]:
    """``(eid, kind, np.ndarray, properties)`` for every entity of
    ``kinds`` in the JAX package's ``engine``, in eid order per kind."""
    for kind in kinds:
        for eid in engine.meta.find(kind):
            yield (eid, kind, np.asarray(engine.store.get(eid)),
                   engine.meta.get(eid))


def ingest_reference_state(engine, entities: Iterable[tuple]) -> list[str]:
    """Ingest ``(eid, kind, array, properties)`` records into the port
    ``engine`` under their own eids; returns the eids."""
    return [engine.add_entity(kind, np.asarray(data), dict(props), eid=eid)
            for eid, kind, data, props in entities]


def params_from_jax(tree, cfg, device="cuda", mesh=None, rules=None) -> dict:
    """The JAX package's parameter tree of a model of ``cfg`` — nested
    dicts whose leaves convert with ``np.asarray``, per-layer leaves
    stacked as its ``init_lm`` and ``init_encdec`` stack them (``blocks``
    (L, ...), dense, moe, vlm and rwkv, a MoE's experts (L, E, ...);
    hybrid ``mamba`` (n_app, group, ...) and ``shared``
    (num_shared_blocks, ...); encoder-decoder ``enc_blocks``
    (num_encoder_layers, ...) and ``dec_blocks`` (L, ...)) — as the
    port's parameters on ``device`` (the CUDA card unless the caller
    asks for the CPU).  The port keeps the same layout, so leaves carry
    over one for one; the top-level keys and the stacked axes are
    checked against ``cfg``.  With a ``mesh`` (a ``sharding.Mesh`` with
    its ``DeviceMesh``), this rank's shards under ``rules`` (default:
    the default rules)."""
    import torch

    from repro_torch.core.boundary import resolve_device
    from repro_torch.models.lm import (family_kind, hybrid_shape,
                                      tree_leaves, tree_map)

    kind = "encdec" if cfg.is_encoder_decoder else family_kind(cfg)
    if kind == "encdec":
        want = {"embed", "enc_blocks", "enc_norm", "enc_norm_b",
                "dec_blocks", "dec_norm", "dec_norm_b"}
    else:
        want = {"embed", "final_norm"}
        if not cfg.tie_embeddings:
            want.add("lm_head")
    if kind == "tblock":
        want.add("blocks")
    elif kind == "rwkv":
        want |= {"blocks", "final_norm_b", "ln0_s", "ln0_b"}
    elif kind == "hybrid":
        want |= {"mamba", "shared"}
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: expected top-level keys "
                         f"{sorted(want)}, got {sorted(tree)}")
    dev = resolve_device(device)
    out = tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)
    if tuple(out["embed"].shape) != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed is {tuple(out['embed'].shape)}")
    if kind in ("tblock", "rwkv"):
        lead = {"blocks": (cfg.num_layers,)}
    elif kind == "encdec":
        lead = {"enc_blocks": (cfg.num_encoder_layers,),
                "dec_blocks": (cfg.num_layers,)}
    else:
        lead = {"mamba": hybrid_shape(cfg),
                "shared": (cfg.num_shared_blocks,)}
    for key, axes in lead.items():
        for leaf in tree_leaves(out[key]):
            if tuple(leaf.shape[:len(axes)]) != axes:
                raise ValueError(f"{cfg.name}: a {key!r} leaf of shape "
                                 f"{tuple(leaf.shape)} is not stacked as "
                                 f"{axes}")
    if kind == "tblock" and cfg.is_moe:
        experts = out["blocks"].get("moe")
        if experts is None:
            raise ValueError(f"{cfg.name}: the blocks hold no 'moe' experts")
        for name in ("w_gate", "w_up", "w_down"):
            shape = tuple(experts[name].shape[:2])
            if shape != (cfg.num_layers, cfg.num_experts):
                raise ValueError(f"{cfg.name}: moe {name!r} is stacked as "
                                 f"{shape}, not (layers, experts) "
                                 f"{(cfg.num_layers, cfg.num_experts)}")
    if mesh is None:
        return out
    from repro_torch.distributed.sharding import (Layout, ShardingCtx,
                                                  default_rules)
    from repro_torch.models import get_model
    sh = ShardingCtx(mesh=mesh, rules=default_rules() if rules is None
                     else rules)
    return Layout(sh, out, get_model(cfg).param_axes()).local(out)


def train_state_from_jax(state, cfg, device="cuda", mesh=None,
                         rules=None) -> dict:
    """The JAX package's train state (``params``, the AdamW moments ``m``
    and ``v``, which mirror the params' tree, and the int32 ``step``), as
    numpy-convertible leaves, as the port's train state on ``device``
    (this rank's shards with a ``mesh``, as :func:`params_from_jax`)."""
    import torch

    from repro_torch.core.boundary import resolve_device

    out = {k: params_from_jax(state[k], cfg, device, mesh, rules)
           for k in ("params", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=resolve_device(device))
    return out
