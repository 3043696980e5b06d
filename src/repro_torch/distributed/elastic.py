"""Elastic topology changes: continue after the worker pool grows or
shrinks (node failure shrinks it; recovery/scale-up grows it).

Two layers share this module:

- **Device meshes** (training/serving): :func:`remesh_tree` re-lays a
  tree of tensors onto a new mesh by re-deriving every leaf's placements
  from the same logical axes under the new mesh (divisibility-demoted
  where the new axis sizes require) and ``distribute_tensor``-ing it.
  A tree of DTensors (a sharded state, as :meth:`sharding.Layout.dtensors`
  makes of local shards) is first gathered whole, so a state moves from
  one mesh to another, e.g. from (1, 2) to (2, 1).  With the atomic
  checkpoints this is the restart path: resume(ckpt) -> remesh to the
  surviving topology -> continue.

- **Engine shards** (query path): :func:`migration_moves` is the pure
  planning half of a cluster rebalance — given each key's owner list
  under the old and new consistent-hash ring, it yields the minimal
  copy/drop set per moved key.  ``repro_torch.cluster.ShardedEngine``
  executes the plan through its ordinary Add/remove paths; the
  remote-pool analogue is ``RemoteServerPool.scale_to``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Iterator, Sequence


def remesh_tree(tree: Any, axes_tree: Any, new_mesh, rules):
    """Re-shard ``tree`` (same structure as ``axes_tree``; full tensors
    or DTensors on another mesh) onto ``new_mesh``: each leaf becomes a
    DTensor with the placements its logical axes give there.  A
    one-rank mesh without a ``DeviceMesh`` (no process group) leaves
    the tree as it is.  Every rank of the old mesh calls it (the leaves
    are gathered there); where ``new_mesh`` covers fewer ranks
    (:func:`repro_torch.launch.mesh.make_mesh`), a rank outside it is
    left holding empty local shards."""
    if new_mesh.device_mesh is None:
        if new_mesh.size != 1:
            raise ValueError(f"a mesh of {new_mesh.size} ranks needs its "
                             "DeviceMesh (a process group of that size)")
        return tree
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.distributed.sharding import (map_with_axes,
                                                  tree_to_shardings)
    tree = map_with_axes(lambda leaf, _: leaf.full_tensor()
                         if isinstance(leaf, DTensor) else leaf,
                         tree, axes_tree)
    shardings = tree_to_shardings(tree, axes_tree, new_mesh, rules)
    return map_with_axes(lambda leaf, pl: distribute_tensor(
        leaf, new_mesh.device_mesh, pl), tree, shardings)


def shrink_batch_for_mesh(global_batch: int, mesh) -> int:
    """Largest batch <= global_batch divisible by the mesh's DP extent —
    keeps per-rank shapes static after losing nodes."""
    dp = mesh.batch_extent
    return max((global_batch // dp) * dp, dp)


# ------------------------------------------------- shard-set rebalance
@dataclasses.dataclass(frozen=True)
class Move:
    """One key's rebalance delta.  ``copy_to`` shards need a fresh copy
    (read from any surviving old holder), ``drop_from`` shards shed
    theirs, and a primary change means surviving copies must re-tag
    their owner property."""
    key: str
    copy_to: tuple
    drop_from: tuple
    old_primary: Any
    new_primary: Any

    @property
    def primary_changed(self) -> bool:
        return self.old_primary != self.new_primary


def migration_moves(keys: Iterable[str],
                    old_owners: Callable[[str], Sequence],
                    new_owners: Callable[[str], Sequence]) -> Iterator[Move]:
    """Plan the minimal data movement for a shard join/leave.

    ``old_owners`` / ``new_owners`` map a key to its ordered owner list
    (primary first) under the pre- and post-rebalance topology.  Only
    keys whose owner list changed produce a :class:`Move`; the
    consistent-hash ring guarantees that set is the minimal range
    adjacent to the changed shard, and this function never moves more
    than the delta."""
    for key in keys:
        old = list(old_owners(key))
        new = list(new_owners(key))
        if old == new:
            continue
        yield Move(key=key,
                   copy_to=tuple(s for s in new if s not in old),
                   drop_from=tuple(s for s in old if s not in new),
                   old_primary=old[0] if old else None,
                   new_primary=new[0] if new else None)
