"""Distributed substrate: so far the query path's fault-tolerance layer
(error taxonomy, fault injection, heartbeats)."""
