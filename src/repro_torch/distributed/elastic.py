"""Elastic topology changes for the engine shards of the query path.

:func:`migration_moves` is the pure planning half of a cluster
rebalance — given each key's owner list under the old and new
consistent-hash ring, it yields the minimal copy/drop set per moved
key.  ``repro_torch.cluster.ShardedEngine`` executes the plan through
its ordinary Add/remove paths; the remote-pool analogue is
``RemoteServerPool.scale_to``.

The device-mesh half of the reference module (re-laying a sharded
parameter tree onto a new mesh, shrinking a batch to a mesh's data
extent) needs a mesh, and comes with the distribution slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Iterator, Sequence


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
