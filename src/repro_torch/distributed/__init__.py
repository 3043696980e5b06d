"""Distributed substrate: logical-axis sharding rules over a torch
DeviceMesh, gradient compression, fault tolerance (error taxonomy,
fault injection, heartbeats, the train supervisor) and elastic
re-meshing and rebalance planning.

The paper's "ecosystem of kappa remote servers" maps onto the mesh's
data-parallel axis; tensor and expert parallelism within one "server"
map onto the model axis.
"""
from repro_torch.distributed.sharding import (  # noqa: F401
    LogicalRules,
    default_rules,
    logical_to_spec,
    tree_to_shardings,
)
