"""Distributed substrate: logical-axis sharding rules over a torch
DeviceMesh, gradient compression, fault tolerance (error taxonomy,
fault injection, heartbeats, the train supervisor) and elastic
re-meshing and rebalance planning.

The paper's "ecosystem of kappa remote servers" maps onto the mesh's
data-parallel axis; tensor parallelism within one "server" maps onto the
model axis (not ported: a mesh runs data parallelism only).
"""
from repro_torch.distributed.sharding import (  # noqa: F401
    LogicalRules,
    default_rules,
    logical_to_spec,
    tree_to_shardings,
    constrain,
)
