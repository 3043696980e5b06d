"""Sharded multi-engine cluster: consistent-hash entity partitioning
with replicated failover behind the single-engine session API.

- :class:`~repro_torch.cluster.ring.HashRing` — stable consistent-hash ring
  (virtual nodes, distinct-shard replica walks, minimal-movement
  rebalance deltas).
- :class:`~repro_torch.cluster.engine.ShardedEngine` — N ``VDMSAsyncEngine``
  shards behind ``submit()``/``execute()``; ``replica_factor=1`` (the
  default) is byte-identical to a plain engine at ``num_shards=1``.
- :class:`~repro_torch.cluster.gather.ClusterFuture` /
  :class:`~repro_torch.cluster.gather.ClusterQuery` — the scatter/gather
  state machine with streaming merge and replica failover.
"""
from repro_torch.cluster.engine import ShardedEngine
from repro_torch.cluster.gather import ClusterFuture, ClusterQuery
from repro_torch.cluster.ring import HashRing, RingDelta

__all__ = ["ShardedEngine", "ClusterFuture", "ClusterQuery",
           "HashRing", "RingDelta"]
