"""Distributed substrate: so far the query path's fault-tolerance layer
(error taxonomy, fault injection, heartbeats), the cluster's rebalance
planner (``elastic.migration_moves``) and the single-device sharding
context the model code is written against."""
