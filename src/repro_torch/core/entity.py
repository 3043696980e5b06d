"""Entities (VCL-object equivalents) and the Entity Response Dictionary."""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional



@dataclasses.dataclass
class Entity:
    """An image or video flowing through an operation pipeline.

    Only *pointers* to entities travel through the queues (paper section 5.1.1);
    the pixel payload lives on the object / in the store.
    """
    eid: str
    kind: str                     # "image" | "video"
    data: Any                     # (H,W,3) array or (T,H,W,3) for video
    metadata: dict = dataclasses.field(default_factory=dict)
    ops: list = dataclasses.field(default_factory=list)   # [Operation]
    op_index: int = 0             # next op to execute
    query_id: str = ""            # owning query session (fair-queue lane)
    cmd_index: int = 0            # which command of the query fanned it out
    failed: Optional[str] = None
    # result-cache plumbing (set by the planner only when the engine cache
    # is enabled and the query opted in; all None/False otherwise):
    cacheable: bool = False       # event loop may record this entity
    cache_hit: Optional[str] = None          # "full" | "prefix" | None
    cache_sigs: Optional[list] = None        # prefix signatures, shared
                                             # across the command's fan-out
    cache_epoch: int = 0          # eid write epoch at blob-read time; a
                                  # put against a newer epoch is refused
    # multi-backend dispatch (set by the planner only when the engine
    # runs with dispatch != "static"; None reproduces the static rule
    # "native if op.is_native else remote" exactly):
    route: Optional[list] = None  # backend name per op, parallel to ops
    # admission ledger: set once when the engine releases this entity's
    # in-flight slot, so the error path's second on_entity_done call
    # for the same entity can never double-release capacity
    admission_released: bool = False
    # admission v2 (stamped by admit_phase only when tenant quotas /
    # cost-aware admission are configured; defaults keep the v1 ledger
    # exact): the owning query's tenant lane and the unit charge this
    # entity holds against the admission budget
    tenant: str = ""
    admission_cost: float = 1.0
    # fault tolerance (set only when the relevant knobs are on):
    # deadline is the query's monotonic retry budget — remote retries
    # never outlive it; fallback_ops holds op indices the event loop
    # re-routed to the native backend after a final-attempt failure
    # (each op falls back at most once — a native failure is terminal)
    deadline: Optional[float] = None
    fallback_ops: Optional[set] = None

    def current_op(self):
        return self.ops[self.op_index] if self.op_index < len(self.ops) else None

    def done(self) -> bool:
        return self.failed is not None or self.op_index >= len(self.ops)


class ERD:
    """Entity Response Dictionary: latest state of every entity, updated
    after *every* operation so a failure never loses completed work
    (paper section 5.2).  Thread_2 and Thread_3 touch disjoint entities at any
    moment; the lock guards the dict structure itself."""

    def __init__(self):
        self._lock = threading.Lock()
        self._d: dict[str, dict] = {}

    def update(self, entity: Entity, stage: str):
        with self._lock:
            self._d[entity.eid] = {
                "data": entity.data,
                "op_index": entity.op_index,
                "stage": stage,
                "ts": time.monotonic(),
                "failed": entity.failed,
            }

    def get(self, eid: str) -> dict | None:
        with self._lock:
            return self._d.get(eid)

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return dict(self._d)

    def __len__(self):
        with self._lock:
            return len(self._d)
