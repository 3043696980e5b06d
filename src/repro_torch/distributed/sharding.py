"""Logical-axis sharding context, single-device form.

The model code calls ``sh(x, *logical_axes)`` at every point where the
JAX package constrains an activation's sharding.  Meshes arrive with the
training/distribution slice of the port; until then the only context is
``ShardingCtx(mesh=None)``, under which ``sh`` is the identity.  Asking
for a mesh raises instead of quietly running unsharded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass
class ShardingCtx:
    """Carried through model apply functions.  ``mesh=None`` means one
    device and no constraints, the only form ported so far."""
    mesh: Any = None
    rules: Mapping[str, Any] | None = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "ShardingCtx with a mesh is not ported yet: meshes come with "
                "the training/distribution slice; pass mesh=None")

    def __call__(self, x, *axes):
        return x


REPLICATED = ShardingCtx(mesh=None)
