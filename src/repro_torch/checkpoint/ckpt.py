"""Checkpoints with atomic manifests (the fault-tolerance substrate), in
the JAX package's on-disk layout, so a checkpoint written by either
package restores in the other.

Layout:  <dir>/step_<N>/{manifest.json, shard_0.npz}
- every leaf is saved as a flat array under its tree path (``/`` in the
  path becomes ``__`` in the npz key);
- the manifest (written LAST, inside ``step_<N>.tmp``, which one
  ``os.rename`` then publishes) records tree paths, shapes, dtypes — a
  checkpoint without a manifest is invisible, so a crash mid-save can
  never be restored from;
- restore validates the structure against a template tree and puts each
  leaf on the template leaf's device.

Leaves go through numpy, so a dtype numpy cannot hold (bfloat16) is
refused; the launchers' train states are float32 with an int32 step.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch


def _flatten(tree) -> dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = node
    walk("", tree)
    return flat


def _unflatten(flat: dict[str, Any]) -> dict:
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _to_numpy(path: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {path!r} is bfloat16, which numpy (and so "
                "the npz layout both packages read) cannot hold; save "
                "float32 masters")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomic save; returns the checkpoint path."""
    flat = {k: _to_numpy(k, v) for k, v in _flatten(tree).items()}
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    np.savez(os.path.join(tmp, "shard_0.npz"),
             **{k.replace("/", "__"): v for k, v in flat.items()})
    for k, v in flat.items():
        manifest["leaves"][k] = {"shape": list(v.shape), "dtype": str(v.dtype),
                                 "shard": 0}
    # manifest written inside tmp, then atomic rename publishes the ckpt
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _published(ckpt_dir: str) -> list[int]:
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, n, "manifest.json")))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _published(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, template, step: int | None = None):
    """Restore into the structure of ``template`` -> (tree, step); each
    leaf lands on the device of the template's leaf at its path."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        flat = {k: data[k.replace("/", "__")] for k in manifest["leaves"]}

    # structural check against the template
    t_flat = _flatten(template)
    missing = set(t_flat) - set(flat)
    extra = set(flat) - set(t_flat)
    if missing or extra:
        raise ValueError(f"checkpoint/template mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    for k, v in flat.items():
        dev = t_flat[k].device if isinstance(t_flat[k], torch.Tensor) else "cpu"
        flat[k] = torch.from_numpy(v).to(dev)
    return _unflatten(flat), step


def _gc(ckpt_dir: str, keep: int):
    for s in _published(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
