"""The paper's contribution: VDMS-Async — an event-driven, asynchronous
visual-query execution engine with user-defined and remote operations.

Faithful structure (paper section 5): Thread_1 (repro_torch.core.engine) plans
queries and enqueues entity pointers on Queue_1; the event loop
(repro_torch.core.event_loop) runs a native-worker pool (the paper's Thread_2,
generalized to N workers with per-query fair scheduling) and Thread_3
(remote/UDF dispatch + response callbacks) over Queue_1/Queue_2 with the
Entity Response Dictionary updated after every operation.  The client API
is futures-based (repro_torch.core.session): ``submit()`` returns a
QueryFuture; ``execute()`` is the blocking wrapper.  The paper's
baseline executors are not ported yet.
"""
from repro_torch.core.entity import Entity, ERD  # noqa: F401
from repro_torch.core.pipeline import Operation, make_op, parse_operations  # noqa: F401
from repro_torch.core.session import QueryFuture, QuerySession  # noqa: F401
