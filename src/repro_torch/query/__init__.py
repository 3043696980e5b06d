"""Query layer: VDMS-style JSON language, metadata store, the per-query
planner that compiles commands into phased execution plans, and the
cost-model multi-backend dispatch router the planner consults."""
from repro_torch.query.dispatch import (  # noqa: F401
    Backend, BackendRouter, NativeBackend, OpCostTracker, RemoteBackend,
    StaticRouter)
from repro_torch.query.language import Command, parse_query  # noqa: F401
from repro_torch.query.metadata import MetadataStore  # noqa: F401
from repro_torch.query.planner import CommandPlan, QueryPlan, QueryPlanner  # noqa: F401
