"""Grouped-UDF execution as a first-class *dispatch backend* behind the
common ``repro_torch.query.dispatch.Backend`` protocol: ops with a
registered batched variant (``register_batched_udf``) become routable,
the router's cost model amortizes the op estimate over the group size,
and group results hand back to the engine through the existing Thread_3
reply path (a ``("batched", entity, result, err)`` message on Queue_2).

The model-serving ``GroupBatcher`` of the JAX package arrives with the
model layer.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from repro_torch.query.dispatch import OFFLOAD_STOP, OffloadInboxMixin


class UDFBatcherBackend(OffloadInboxMixin):
    """Grouped-UDF execution as a dispatch backend (``Backend`` protocol
    from repro_torch.query.dispatch).  Inbox lifecycle — the gated ``submit``,
    poison-pill ``shutdown``, post-join drain — comes from
    :class:`repro_torch.query.dispatch.OffloadInboxMixin`, shared with the
    device backend.

    One worker thread pulls entities off an inbox, collects a group (up
    to ``group_size``, held at most ``max_wait_s`` from the first
    member), partitions it by op signature, runs each partition's
    *batched* UDF once, and replies per entity into the event loop's
    Queue_2 — the same Thread_3 path remote replies take, so handoff,
    cache snapshots, cancellation, and re-enqueue all behave identically
    to a remote segment.

    Cost estimate (see repro_torch.query.dispatch): ``wait/2 + op_est/G +
    backlog`` — half the batching window (expected wait), the tracked
    per-op estimate amortized over the group size (the win this backend
    buys; a "batched" EWMA sample replaces the amortization guess once
    groups have actually run), plus the backlog ledger of recent
    placements (the batcher worker is single-threaded)."""

    name = "batcher"

    def __init__(self, *, group_size: int = 8, max_wait_s: float = 0.002,
                 tracker=None, clock=time.monotonic):
        from repro_torch.query.dispatch import LoadLedger, OpCostTracker
        self.group_size = max(1, group_size)
        self.max_wait_s = max(0.0, max_wait_s)
        self.tracker = tracker or OpCostTracker()
        self._clock = clock
        self.ledger = LoadLedger(lambda: 1.0, clock=clock)
        self._init_inbox()
        self._reply_to: Optional[queue.Queue] = None
        self._is_cancelled = lambda qid: False
        self.groups_run = 0
        self.entities_run = 0
        self.errors = 0
        self.cancelled_dropped = 0

    # -------------------------------------------------- engine plumbing
    def bind(self, reply_to: queue.Queue, is_cancelled) -> None:
        """Attach to the event loop (its Queue_2 + cancellation
        predicate) and start the worker.  Separate from __init__ because
        the engine builds the backend before the loop exists."""
        self._reply_to = reply_to
        self._is_cancelled = is_cancelled
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="udf-batcher-backend")
        self._thread.start()

    # --------------------------------------------------- Backend protocol
    def can_run(self, op) -> bool:
        from repro_torch.core.udf import has_batched_udf
        return has_batched_udf(op.name)

    def _amortized_estimate(self, op) -> float:
        """Per-entity cost of running ``op`` through a group: the
        observed batched EWMA once groups have run, else the native
        estimate divided by the group size (single source of truth for
        both the router estimate and the placement-feedback ledger)."""
        if self.tracker.known(op, kind="batched"):
            return self.tracker.estimate(op, kind="batched")
        return self.tracker.estimate(op) / self.group_size

    def estimate(self, op, payload_bytes: int) -> float:
        return self.max_wait_s / 2.0 + self._amortized_estimate(op) \
            + self.ledger.backlog_s()

    def queue_depth(self) -> int:
        return self.inbox.qsize()

    def note_placed(self, op) -> None:
        self.ledger.add(self._amortized_estimate(op))

    def stats(self) -> dict:
        return {"groups_run": self.groups_run,
                "entities_run": self.entities_run,
                "errors": self.errors,
                "cancelled_dropped": self.cancelled_dropped,
                "pending": self.pending()}

    # ------------------------------------------------------- worker loop
    def _run(self):
        from repro_torch.query.dispatch import collect_microbatch
        while True:
            first = self.inbox.get()
            if first is OFFLOAD_STOP:
                self._drain_after_stop()
                return
            group, stop = collect_microbatch(
                self.inbox, first, size=self.group_size,
                max_wait_s=self.max_wait_s, clock=self._clock,
                stop=OFFLOAD_STOP)
            self._run_groups(group)
            if stop:
                self._drain_after_stop()
                return

    def _run_groups(self, group):
        # partition by op: entities collected in one window may carry
        # different ops; only same-op entities share a batched call
        by_op: dict = {}
        for ent in group:
            by_op.setdefault(ent.current_op(), []).append(ent)
        for op, ents in by_op.items():
            self._run_batch(op, ents)

    def _run_batch(self, op, ents):
        live = []
        for ent in ents:
            if self._is_cancelled(ent.query_id):
                self.cancelled_dropped += 1
            else:
                live.append(ent)
        if not live:
            return
        from repro_torch.core.udf import get_batched_udf
        t0 = self._clock()
        try:
            self._maybe_fault()
            results = get_batched_udf(op.name)([e.data for e in live],
                                               **op.kwargs)
            if len(results) != len(live):
                # contract violation in a user batched UDF: surface it as
                # a per-entity failure — a short result list must never
                # strand unanswered entities (their sessions would hang)
                raise ValueError(
                    f"batched UDF {op.name!r} returned {len(results)} "
                    f"results for {len(live)} inputs")
        except Exception as e:  # noqa: BLE001 — report, don't kill worker
            self.errors += 1
            for ent in live:
                self._reply_to.put(("batched", ent, None, e))
            return
        self.tracker.observe(op, (self._clock() - t0) / len(live),
                             kind="batched")
        self.groups_run += 1
        self.entities_run += len(live)
        for ent, res in zip(live, results):
            self._reply_to.put(("batched", ent, res, None))
