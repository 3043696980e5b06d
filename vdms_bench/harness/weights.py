"""A model's parameters drawn from the seed on the device, in the type
they are served in, in one large draw: every drawn leaf is a view of
one flat buffer filled by a single ``normal_`` call (cut at 3 standard
deviations), then scaled by its own deviation.  The tree is laid out as
the reference module's ``layout(cfg)`` says; the program and the
reference are given the same tree (the reference a fresh draw from the
same seed, after the program's is freed)."""
from __future__ import annotations

import numpy as np
import torch

from harness.seeds import stream

ALIGN = 64  # elements: each leaf starts 256-byte aligned


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def make(layout: list, seed: int, device, dtype=torch.float32) -> dict:
    device = torch.device(device)
    drawn = [(path, shape, init[1]) for path, shape, init in layout
             if init[0] == "normal"]
    total = sum(_aligned(int(np.prod(shape))) for _, shape, _ in drawn)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, "weights"))
    flat.normal_(generator=g).clamp_(-3.0, 3.0)
    flat = flat.to(dtype)
    tree: dict = {}
    off = 0
    leaves = {}
    for path, shape, std in drawn:
        n = int(np.prod(shape))
        leaves[path] = flat[off:off + n].view(shape).mul_(std)
        off += _aligned(n)
    for path, shape, init in layout:
        if init[0] == "normal":
            continue
        if init[0] == "ones":
            leaf = torch.ones(shape, dtype=dtype, device=device)
        elif init[0] == "zeros":
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        elif init[0] == "values":
            v = torch.tensor(np.asarray(init[1], dtype=np.float64),
                             dtype=torch.float32, device=device)
            leaf = v.expand(shape).to(dtype).contiguous()
        else:
            raise ValueError(f"unknown init {init!r}")
        leaves[path] = leaf
    for path, shape, _ in layout:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaves[path]
    return tree

