"""The asynchronous event loop (paper section 5.1.2).

Threads, two queues, four event types:

- Q1-Enqueue:     an entity lands on Queue_1 (from Thread_1 or Thread_3).
- R-UDF:          a native worker hits a non-native op -> entity moves to
                  Queue_2.
- Q2-Enqueue:     Thread_3 picks the entity up and dispatches it to a
                  remote server / UDF process (non-blocking).
- R-UDF-Response: a server reply triggers Thread_3's callback: update the
                  ERD, re-enqueue the entity on Queue_1.

Native ops execute locally on a pool of ``num_native_workers`` worker
threads (the paper's single Thread_2 generalized — ``num_native_workers=1``
reproduces the paper-faithful baseline exactly); Thread_3 only dispatches
and handles callbacks, so no thread ever idle-waits on remote compute —
the paper's core claim.  The ERD is updated after every operation.

Queue_1 is a *fair* per-query scheduler: each query session owns a FIFO
lane and workers round-robin across lanes, so a 500-entity query cannot
starve a 1-entity query that arrives behind it.  ``fair_scheduling=False``
restores the paper's single global FIFO.

Cancellation: the engine installs an ``is_cancelled(query_id)`` predicate.
Workers drop entities of cancelled queries between ops, and Thread_3
drops their responses instead of re-enqueueing, so a cancelled or
timed-out query drains instead of orphaning work.

Beyond-paper knobs, default OFF:
- ``fuse_native``:   run maximal native-op runs in one worker call;
- ``batch_remote``:  coalesce up to N same-op entities per remote request,
                     amortizing per-request network latency (per-buffer:
                     whatever happens to sit in Thread_3's buffer at flush
                     time);
- ``coalesce_window_s``: cross-session request coalescing.  Instead of
  flushing Thread_3's buffer wholesale, pending remote work is grouped by
  op signature (which pins the endpoint, so a group maps to one batched
  request on one server); each group is held open for the window from its
  first member's arrival — or until ``coalesce_max_batch`` — then
  dispatched as ONE batched request whose transport cost is the amortized
  ``TransportModel.cost_batch``.  Entities from *different* query sessions
  share a batch; replies fan back out per entity, and a cancelled query's
  members are dropped from shared batches (at flush time for buffered
  work, per-entity at reply time for in-flight work) without disturbing
  the other sessions in the batch.
- a :class:`~repro_torch.core.result_cache.ResultCache` (``result_cache``):
  workers record each cacheable entity's final result, plus an
  intermediate snapshot after every remote/UDF op — the expensive resume
  points for prefix hits.
- multi-backend dispatch (``batcher_backend`` + ``device_backend`` +
  ``cost_tracker``, wired by the engine when ``dispatch != "static"``):
  entities may carry a ``route`` — a backend name per op.  Native
  workers execute only ops routed ``native`` (including UDF/remote-
  tagged ops the router placed locally, which get a cache snapshot like
  any expensive resume point) and hand everything else to Thread_3;
  Thread_3 sends ``remote``-routed ops down the existing
  dispatch/coalescing path, ``batcher``-routed ops to the
  :class:`~repro_torch.serving.batcher.UDFBatcherBackend`, and
  ``device``-routed ops to the
  :class:`~repro_torch.query.device_backend.DeviceBackend`.  Both offload
  backends reply with ``("batched" | "device", entity, result, err)``
  messages on Queue_2 — the same reply path remote responses ride, so
  cache snapshots after device/batcher segments, cancellation, and
  re-enqueue are uniform across all non-native backends.  Device
  replies append a 5th field, the ops advanced: with segment fusion a
  whole run of consecutive device-routed ops completes as ONE reply,
  and the cache snapshot lands at the segment boundary (prefix resume
  is coarser by the fused run length — intermediates never left the
  device).
  ``route=None`` (every static-dispatch entity) reproduces the paper's
  placement rule exactly.  The ``cost_tracker`` is calibrated online:
  native workers record per-op execution seconds.

Determinism hooks for tests: ``flush_coalesced()`` force-dispatches all
open coalescing groups (so tests need not wait out wall-clock windows),
``pending_coalesced()`` counts currently-buffered entities, and
``clock`` injects a time source for the window deadlines.

Note the scheduling knobs are NOT paper-faithful by default: the engine
defaults to a cpu-bounded worker pool and fair per-query lanes.  The
exact paper baseline is ``num_native_workers=1, fair_scheduling=False``
(one Thread_2, one global FIFO) — benchmarks that reproduce paper
figures pin it explicitly.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, Optional

from repro_torch.core.entity import ERD, Entity
from repro_torch.core.pipeline import run_native_chain, run_op
from repro_torch.core.remote import RemoteServerPool, Request
from repro_torch.distributed.fault import PermanentError

_STOP = object()


class BusyMeter:
    """Accumulates (start, stop) busy intervals for utilization traces.

    Memory-bounded: only the most recent ``window`` intervals are kept
    verbatim; older ones are folded into an aggregate counter so sustained
    serving traffic cannot grow the meter without bound.
    ``busy_seconds(since)`` is exact while ``since`` falls inside the
    retained window (the common case — benchmarks measure over recent
    marks); for a ``since`` older than the window it adds the full evicted
    aggregate, a documented over-approximation.
    """

    def __init__(self, window: int = 4096):
        self.window = window
        self.intervals: collections.deque[tuple[float, float]] = \
            collections.deque()         # guarded-by: _lock
        self._t0: float | None = None   # owner thread only
        self._lock = threading.Lock()   # owner thread writes, readers poll
        self.total_busy_s = 0.0         # guarded-by: _lock
        self.total_intervals = 0        # guarded-by: _lock
        self._evicted_busy_s = 0.0      # guarded-by: _lock
        self._evicted_until = 0.0       # guarded-by: _lock

    def start(self):
        self._t0 = time.monotonic()

    def stop(self):
        if self._t0 is None:
            return
        a, b = self._t0, time.monotonic()
        self._t0 = None
        with self._lock:
            self.intervals.append((a, b))
            self.total_busy_s += b - a
            self.total_intervals += 1
            while len(self.intervals) > self.window:
                ea, eb = self.intervals.popleft()
                self._evicted_busy_s += eb - ea
                self._evicted_until = max(self._evicted_until, eb)

    def busy_seconds(self, since: float = 0.0) -> float:
        with self._lock:
            recent = sum(b - max(a, since)
                         for a, b in self.intervals if b >= since)
            if since <= 0.0 or since < self._evicted_until:
                recent += self._evicted_busy_s
            return recent


class MeterGroup:
    """Read-side aggregate over the per-worker meters of the native pool."""

    def __init__(self, meters: list[BusyMeter]):
        self.meters = list(meters)

    def busy_seconds(self, since: float = 0.0) -> float:
        return sum(m.busy_seconds(since) for m in self.meters)

    def utilization(self, *, workers: int, window_s: float = 0.25) -> float:
        """Busy fraction of a ``workers``-wide pool over the trailing
        ``window_s``, in [0, 1] — the shared overload signal read by
        both the dispatch cost model (NativeBackend) and the admission
        controller."""
        now = time.monotonic()
        busy = self.busy_seconds(since=now - window_s)
        return min(1.0, busy / (window_s * max(1, workers)))

    @property
    def total_intervals(self) -> int:
        return sum(m.total_intervals for m in self.meters)


class FairQueue:
    """Queue_1 with per-query fair scheduling.

    Each query_id owns a FIFO lane; ``get`` round-robins across lanes so
    concurrent queries share the native pool no matter how lopsided their
    fan-outs are.  ``fair=False`` degrades to one global FIFO (the paper's
    Queue_1).  ``close`` lets getters drain remaining items, then return
    ``None`` so workers can exit and be joined.

    Per-query lane counters (``depths()``) are maintained *inside the
    same critical section* as the pop/put/discard that changes them —
    lane accounting done by callers after ``get`` returned would race
    ``discard`` on a cancelled query and skew the counts, and the
    round-robin rotation consults the counter to decide whether a lane
    stays in rotation, so a skewed counter starves later queries.  The
    counters double as the admission controller's Queue_1 depth signal.
    """

    def __init__(self, fair: bool = True):
        self.fair = fair
        self._cv = threading.Condition()
        self._lanes: dict[str, collections.deque] = {}  # guarded-by: _cv
        self._rr: collections.deque[str] = \
            collections.deque()             # lane rotation  # guarded-by: _cv
        self._fifo: collections.deque = collections.deque()  # guarded-by: _cv
        self._counts: dict[str, int] = {}   # per-query live  # guarded-by: _cv
        self._closed = False                # guarded-by: _cv

    def put(self, ent: Entity):
        self.put_many((ent,))

    def put_many(self, ents):
        """Enqueue a batch under one lock acquisition.  Submitting threads
        use this for whole-phase launches: workers only wake once the
        batch is fully queued, so a large fan-out cannot GIL-starve the
        submitting client while it is still enqueueing (keeps ``submit``
        O(ms) even for huge queries)."""
        with self._cv:
            for ent in ents:
                qid = ent.query_id
                self._counts[qid] = self._counts.get(qid, 0) + 1
                if not self.fair:
                    self._fifo.append(ent)
                else:
                    lane = self._lanes.get(qid)
                    if lane is None:
                        lane = self._lanes[qid] = collections.deque()
                        self._rr.append(qid)
                    lane.append(ent)
            self._cv.notify_all()

    def get(self, timeout: float | None = None):
        """Next entity, or None once closed and drained."""
        with self._cv:
            while True:
                if not self.fair and self._fifo:
                    ent = self._fifo.popleft()
                    self._dec_locked(ent.query_id)
                    return ent
                if self.fair and self._rr:
                    qid = self._rr.popleft()
                    lane = self._lanes[qid]
                    ent = lane.popleft()
                    # counter update atomic with the pop: rotation below
                    # trusts it, and discard() may run the instant the
                    # lock is released
                    remaining = self._dec_locked(qid)
                    if remaining:
                        self._rr.append(qid)   # rotate: next lane goes first
                    else:
                        del self._lanes[qid]
                    return ent
                if self._closed:
                    return None
                if not self._cv.wait(timeout):
                    return None

    def _dec_locked(self, qid: str) -> int:
        n = self._counts.get(qid, 0) - 1
        if n <= 0:
            self._counts.pop(qid, None)
            return 0
        self._counts[qid] = n
        return n

    def discard(self, query_id: str) -> int:
        """Drop every queued entity of a cancelled query — lane, counter,
        and rotation entry removed in one critical section. Returns
        count."""
        with self._cv:
            if not self.fair:
                kept = [e for e in self._fifo if e.query_id != query_id]
                n = len(self._fifo) - len(kept)
                self._fifo = collections.deque(kept)
                self._counts.pop(query_id, None)
                return n
            lane = self._lanes.pop(query_id, None)
            self._counts.pop(query_id, None)
            if lane is None:
                return 0
            try:
                self._rr.remove(query_id)
            except ValueError:
                pass
            return len(lane)

    def qsize(self) -> int:
        with self._cv:
            return len(self._fifo) + sum(len(v) for v in self._lanes.values())

    def depths(self) -> dict[str, int]:
        """Live per-query lane depths (a copy) — consistent with
        ``qsize`` because both read under the queue lock."""
        with self._cv:
            return dict(self._counts)

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class EventLoop:
    def __init__(self, pool: RemoteServerPool, erd: ERD, *,
                 fuse_native: bool = False,
                 batch_remote: int = 1,
                 num_native_workers: int = 1,
                 fair_scheduling: bool = True,
                 on_entity_done: Optional[Callable[[Entity], None]] = None,
                 is_cancelled: Optional[Callable[[str], bool]] = None,
                 straggler_check_s: float = 0.1,
                 coalesce_window_s: float = 0.0,
                 coalesce_max_batch: int = 64,
                 result_cache=None,
                 batcher_backend=None,
                 device_backend=None,
                 cost_tracker=None,
                 health=None,
                 fallback_native: bool = False,
                 clock=time.monotonic):
        self.pool = pool
        self.erd = erd
        # fault-tolerance wiring (engine-provided, both default off):
        # ``health`` is the HealthRegistry fed per-attempt outcomes;
        # ``fallback_native`` enables the final-attempt re-route of a
        # failing op to the native backend instead of failing the entity
        self.health = health
        self.fallback_native = fallback_native
        self.fallbacks = 0
        # stub pools in tests implement only the original surface
        self._pool_tick = getattr(pool, "tick", None)
        self._pool_next_due = getattr(pool, "next_retry_due", None)
        self.fuse_native = fuse_native
        self.batch_remote = max(1, batch_remote)
        self.coalesce_window_s = max(0.0, coalesce_window_s)
        self.coalesce_max_batch = max(2, coalesce_max_batch)
        self.result_cache = result_cache
        self.batcher_backend = batcher_backend
        self.device_backend = device_backend
        self.cost_tracker = cost_tracker
        self._clock = clock
        # open coalescing groups (mutated only by Thread_3); the buffered
        # counter is read cross-thread by pending_coalesced()
        self._groups: dict[Any, list[Entity]] = {}
        self._deadlines: dict[Any, float] = {}
        self._buffered = 0
        self.coalesced_batches = 0
        self.coalesced_entities = 0
        self.num_native_workers = max(1, num_native_workers)
        self.on_entity_done = on_entity_done or (lambda e: None)
        self.is_cancelled = is_cancelled or (lambda qid: False)
        self.queue1 = FairQueue(fair=fair_scheduling)  # native work
        self.queue2: queue.Queue = queue.Queue()   # Thread_3 inbox: dispatch + responses
        self._meters = [BusyMeter() for _ in range(self.num_native_workers)]
        self.t2_meter = MeterGroup(self._meters)
        self.t3_meter = BusyMeter()
        self.straggler_check_s = straggler_check_s
        self.workers = [
            threading.Thread(target=self._native_worker, args=(m,), daemon=True,
                             name=f"eventloop-native-{i}")
            for i, m in enumerate(self._meters)]
        self.thread3 = threading.Thread(target=self._thread3, daemon=True,
                                        name="eventloop-remote")
        for w in self.workers:
            w.start()
        self.thread3.start()

    # ------------------------------------------------------------ events
    def enqueue(self, entity: Entity):
        """Q1-Enqueue (from Thread_1 or a Thread_3 callback)."""
        self.queue1.put(entity)

    def enqueue_many(self, entities):
        """Bulk Q1-Enqueue for a whole phase launch."""
        self.queue1.put_many(entities)

    def discard_query(self, query_id: str) -> int:
        """Drop a cancelled query's queued native work."""
        return self.queue1.discard(query_id)

    # -------------------------------------------------- native worker pool
    def _native_worker(self, meter: BusyMeter):
        while True:
            ent = self.queue1.get()
            if ent is None:        # queue closed and drained
                return
            if self.is_cancelled(ent.query_id):
                continue
            meter.start()
            try:
                self._run_native(ent)
            except Exception as e:  # noqa: BLE001
                if self.health is not None:
                    self.health.record_failure("native")
                ent.failed = f"{type(e).__name__}: {e}"
                self.erd.update(ent, "native-error")
                try:
                    self.on_entity_done(ent)
                except Exception:  # noqa: BLE001 — a completion callback
                    pass           # that raises must not kill the worker
            finally:
                meter.stop()

    def _backend_for(self, ent: Entity) -> str:
        """Backend of the entity's current op: the native fallback set
        first (ops a failed backend handed back run locally exactly
        once), then its route when the router placed it, else the
        paper's static rule (native iff tagged native) — so route=None
        entities behave byte-identically."""
        if ent.fallback_ops is not None and ent.op_index in ent.fallback_ops:
            return "native"
        if ent.route is not None and ent.op_index < len(ent.route):
            return ent.route[ent.op_index]
        return "native" if ent.current_op().is_native else "remote"

    def _run_native(self, ent: Entity):
        while not ent.done():
            if self.is_cancelled(ent.query_id):
                return             # dropped mid-pipeline; ERD keeps last state
            op = ent.current_op()
            if self._backend_for(ent) != "native":
                # R-UDF / routed handoff: release to Queue_2 and move on
                self.queue2.put(("dispatch", ent))
                return
            if self.fuse_native and op.is_native:
                # collect the maximal run of native-table ops that also
                # STAY on this backend (for routed entities the run stops
                # at the first op placed elsewhere; route=None fuses
                # exactly the paper-static run)
                run = []
                j = ent.op_index
                route = ent.route
                while j < len(ent.ops) and ent.ops[j].is_native \
                        and (route is None or route[j] == "native"):
                    run.append(ent.ops[j])
                    j += 1
                t0 = time.monotonic() if self.cost_tracker is not None else 0.0
                ent.data = run_native_chain(run, ent.data)
                if self.cost_tracker is not None:
                    # keep calibration alive under fusion: attribute the
                    # chain wall evenly across its ops (rough, but far
                    # better than leaving them at the cold default), and
                    # the observed output size to the op that produced it
                    per_op = (time.monotonic() - t0) / len(run)
                    for k, fused_op in enumerate(run):
                        self.cost_tracker.observe(
                            fused_op, per_op,
                            out_bytes=(getattr(ent.data, "nbytes", None)
                                       if k == len(run) - 1 else None))
                ent.op_index = j
                self.erd.update(ent, f"native:{run[-1].name}")
            else:
                t0 = time.monotonic() if self.cost_tracker is not None else 0.0
                ent.data = run_op(op, ent.data)
                if hasattr(ent.data, "block_until_ready"):
                    ent.data.block_until_ready()
                if self.cost_tracker is not None:
                    self.cost_tracker.observe(
                        op, time.monotonic() - t0,
                        out_bytes=getattr(ent.data, "nbytes", None))
                ent.op_index += 1
                self.erd.update(ent, f"native:{op.name}")
                if not op.is_native and not ent.done():
                    # a UDF/remote-tagged op the router placed locally is
                    # an expensive resume point, same as a remote reply
                    self._record_cache(ent)
        self._record_cache(ent)
        if self.health is not None:
            self.health.record_success("native")
        self.on_entity_done(ent)

    def _record_cache(self, ent: Entity):
        """Record a cacheable entity's pipeline state under the signature
        of the ops completed so far.  Called at pipeline completion and
        after every remote/UDF reply (the expensive resume points —
        intermediate native states are cheap to recompute and are not
        snapshotted)."""
        rc = self.result_cache
        if rc is None or not ent.cacheable or ent.failed or not ent.op_index:
            return
        sigs = ent.cache_sigs
        if sigs:
            rc.put(ent.eid, sigs[ent.op_index - 1], ent.data,
                   epoch=ent.cache_epoch)

    # ------------------------------------------------ coalescing controls
    def pending_coalesced(self) -> int:
        """Entities currently buffered in open coalescing groups (the
        deterministic signal tests poll instead of sleeping out the
        wall-clock window)."""
        return self._buffered

    def flush_coalesced(self):
        """Force-dispatch every open coalescing group now, regardless of
        window deadlines (injectable-flush test hook; also useful for
        graceful drains)."""
        self.queue2.put(("flush_coalesce",))

    def _flush_groups(self, ops):
        for op in ops:
            group = self._groups.pop(op)
            self._deadlines.pop(op, None)
            self._buffered -= len(group)
            self._dispatch_group(group)

    # ------------------------------------------------------- Thread_3 loop
    def _thread3(self):
        pending: list[Entity] = []  # dispatch batching buffer (window off)
        # coalescing-window state lives on self (_groups/_deadlines): one
        # open group per op signature, deadline set by its FIRST member's
        # arrival (self._clock-based so tests can inject a time source)
        coalesce = self.coalesce_window_s > 0.0
        last_straggler = time.monotonic()
        while True:
            timeout = self.straggler_check_s
            if self._deadlines:
                timeout = min(timeout, max(0.0, min(self._deadlines.values())
                                           - self._clock()))
            if self._pool_next_due is not None:
                # a scheduled retry backoff must not oversleep behind the
                # straggler cadence
                due = self._pool_next_due()
                if due is not None:
                    timeout = min(timeout,
                                  max(0.0, due - time.monotonic()))
            try:
                msg = self.queue2.get(timeout=timeout)
            except queue.Empty:
                msg = None
            now = time.monotonic()
            if self._pool_next_due is not None:
                due = self._pool_next_due()
                if due is not None and due <= now:
                    self.pool.flush_due_retries()
            if now - last_straggler > self.straggler_check_s:
                # tick() adds elapsed-backoff + heartbeat maintenance on
                # pools that grew it; test stubs keep the original surface
                (self._pool_tick or self.pool.reissue_stragglers)()
                last_straggler = now
            if msg is _STOP:
                return
            if msg is not None:
                self.t3_meter.start()
                kind = msg[0]
                if kind == "dispatch":
                    ent = msg[1]
                    backend = self._backend_for(ent)
                    if backend == "batcher" \
                            and self.batcher_backend is not None:
                        self._submit_offload(self.batcher_backend, ent)
                    elif backend == "device" \
                            and self.device_backend is not None:
                        self._submit_offload(self.device_backend, ent)
                    elif coalesce:
                        op = ent.current_op()
                        group = self._groups.get(op)
                        if group is None:
                            group = self._groups[op] = []
                            self._deadlines[op] = (self._clock()
                                                   + self.coalesce_window_s)
                        group.append(ent)
                        self._buffered += 1
                        if len(group) >= self.coalesce_max_batch:
                            self._flush_groups([op])
                    else:
                        pending.append(ent)
                        if len(pending) >= self.batch_remote:
                            self._flush(pending)
                            pending = []
                elif kind in ("batched", "device"):
                    # offload-backend group reply (batcher or device):
                    # same handoff semantics as a remote response.
                    # Device replies carry a 5th field — the number of
                    # ops the reply advances (a fused device segment is
                    # ONE reply covering the whole op run); batcher
                    # replies stay 4-tuples advancing one op.
                    _, ent, result, err = msg[:4]
                    self._handle_offload(
                        ent, result, err,
                        "batcher" if kind == "batched" else "device",
                        advance=msg[4] if len(msg) > 4 else 1)
                elif kind == "flush_coalesce":
                    self._flush_groups(list(self._groups))
                else:
                    # R-UDF-Response callback
                    tag, req, payload = msg
                    self._handle_response(tag, req, payload)
                    if pending:
                        self._flush(pending)
                        pending = []
                self.t3_meter.stop()
            elif pending:
                self.t3_meter.start()
                self._flush(pending)
                pending = []
                self.t3_meter.stop()
            if self._deadlines:
                now = self._clock()
                expired = [op for op, dl in self._deadlines.items()
                           if dl <= now]
                if expired:
                    self.t3_meter.start()
                    self._flush_groups(expired)
                    self.t3_meter.stop()

    def _dispatch_group(self, group: list[Entity]):
        """Dispatch one coalesced group as a single batched request.
        Members of queries cancelled while buffered are dropped here —
        only *their* slots leave the shared batch."""
        group = [e for e in group if not self.is_cancelled(e.query_id)]
        if not group:
            return
        if len(group) == 1:
            self._dispatch_remote(group[0], group[0].current_op())
            return
        self.coalesced_batches += 1
        self.coalesced_entities += len(group)
        self._dispatch_remote(group, group[0].current_op())

    def _flush(self, entities: list[Entity]):
        """Q2-Enqueue handling: dispatch entities' current ops (grouped
        into one batched request per op when batch_remote > 1).  Entities
        of queries cancelled while they sat in the buffer are dropped."""
        entities = [e for e in entities if not self.is_cancelled(e.query_id)]
        if self.batch_remote > 1:
            groups: dict[Any, list[Entity]] = {}
            for e in entities:
                groups.setdefault(e.current_op(), []).append(e)
            for op, group in groups.items():
                payload = group if len(group) > 1 else group[0]
                self._dispatch_remote(payload, op)
        else:
            for e in entities:
                self._dispatch_remote(e, e.current_op())

    def _dispatch_remote(self, payload, op):
        """``pool.dispatch`` with Thread_3 protected from a pool-level
        raise (every remote server dead): fail — or fall back to native
        — per entity instead of killing the dispatch thread (every
        later query would hang on a dead Thread_3)."""
        try:
            self.pool.dispatch(payload, op, self.queue2)
        except RuntimeError as e:
            ents = payload if isinstance(payload, list) else [payload]
            for ent in ents:
                if self.is_cancelled(ent.query_id):
                    continue
                if self._try_fallback(ent, 1, "remote", e):
                    continue
                self._fail_segment(
                    ent, f"remote op {op.name} failed: {e}",
                    "remote-error")

    def _submit_offload(self, backend, ent: Entity):
        """Hand a routed entity to an offload backend (batcher/device).
        A backend that began shutdown *refuses* late work
        (``submit`` raises) — fail the entity deterministically instead
        of letting it vanish into a dead inbox (its session would hang)
        or letting the raise kill Thread_3."""
        try:
            backend.submit(ent)
        except RuntimeError as e:
            self._fail_segment(
                ent, f"{backend.name} op {ent.current_op().name} "
                     f"rejected: {e}", f"{backend.name}-shutdown")

    # --------------------------------------------- shared segment tails
    # one copy of the per-entity reply invariants, used by BOTH the
    # remote and batcher handlers — the dispatch design promises their
    # segments hand off identically, so they must share this code

    def _fail_segment(self, ent: Entity, msg: str, stage: str):
        ent.failed = msg
        self.erd.update(ent, stage)
        self.on_entity_done(ent)

    def _try_fallback(self, ent: Entity, n_ops: int, source: str,
                      err) -> bool:
        """Final-attempt graceful degradation: re-route the failing
        op(s) to the native backend — which can run every op — instead
        of failing the entity, so an injected or real fault degrades
        the query to *slower*, never to *failed*.  Off unless the
        engine enables ``fallback="native"``.  Guards: never applied
        twice to the same op (a native failure is terminal, so fallback
        cannot loop), and never for a
        :class:`~repro_torch.distributed.fault.PermanentError` (deterministic
        failures — including an exhausted deadline — would fail
        natively too, or arrive after the client is gone)."""
        if not self.fallback_native or isinstance(err, PermanentError):
            return False
        i = ent.op_index
        if ent.fallback_ops is not None and i in ent.fallback_ops:
            return False
        if ent.fallback_ops is None:
            ent.fallback_ops = set()
        # a fused device segment fails as one unit: its whole op run
        # falls back together (advance = run length)
        ent.fallback_ops.update(
            range(i, min(len(ent.ops), i + max(1, n_ops))))
        self.fallbacks += 1
        self.erd.update(ent, f"{source}-fallback")
        self.enqueue(ent)      # Q1-Enqueue: native workers pick it up
        return True

    def _advance_segment(self, ent: Entity, result, source: str,
                         advance: int = 1):
        """State half of a segment completion: install the result,
        advance the op index, update the ERD, and record the cache
        snapshot.  Deliberately split from :meth:`_finish_segment` — in
        a coalesced-batch fan-out every member's snapshot must be
        recorded BEFORE any member's client callback runs, so a
        callback that raises (or hangs) can never skip the remaining
        snapshots of its own group.

        ``advance > 1`` is a fused device segment completing as one
        unit: the op index jumps past the whole run and the cache
        snapshot lands at the segment BOUNDARY (intermediates never
        left the device, so there is nothing to snapshot mid-segment —
        prefix resume is coarser by exactly the fused run length)."""
        ops = ent.ops[ent.op_index:ent.op_index + advance]
        ent.data = result
        ent.op_index += advance
        stage = "+".join(op.name for op in ops)
        self.erd.update(ent, f"{source}:{stage}")
        self._record_cache(ent)

    def _finish_segment(self, ent: Entity):
        """Callback half of a segment completion: hand a finished entity
        to its session (which runs client callbacks) or re-enqueue it
        for its next op."""
        if ent.done():
            self.on_entity_done(ent)
        else:
            self.enqueue(ent)      # Q1-Enqueue from Thread_3

    def _complete_segment(self, ent: Entity, result, source: str,
                          advance: int = 1):
        self._advance_segment(ent, result, source, advance)
        self._finish_segment(ent)

    def _handle_offload(self, ent: Entity, result, err, source: str,
                        advance: int = 1):
        """Reply tail for an offload-backend group member (``source`` is
        ``"batcher"`` or ``"device"``; ERD stages and failure messages
        name the backend that actually ran the op).  ``advance`` is the
        number of ops the reply covers (> 1 for a fused device
        segment)."""
        if self.is_cancelled(ent.query_id):
            return                 # cancelled while in the group: drop
        if err is not None:
            if self.health is not None:
                self.health.record_failure(source)
            if self._try_fallback(ent, advance, source, err):
                return
            word = "batched" if source == "batcher" else source
            self._fail_segment(
                ent, f"{word} op {ent.current_op().name} failed: {err}",
                f"{source}-error")
            return
        if self.health is not None:
            self.health.record_success(source)
        self._complete_segment(ent, result, source, advance)

    def _handle_response(self, tag: str, req: Request, payload):
        status, result = self.pool.handle_response(tag, req, payload)
        if self.health is not None and status in ("done", "requeued",
                                                  "failed"):
            if status == "done":
                self.health.record_success("remote")
            else:
                self.health.record_failure("remote")
        if status in ("dropped", "requeued"):
            return
        ents = req.entity if isinstance(req.entity, list) else [req.entity]
        results = result if isinstance(req.entity, list) else [result]
        # two passes over a (possibly coalesced) batch: first record
        # every member's state + cache snapshot, then fire completions.
        # Completion callbacks reach client code (on_entity / done
        # callbacks), and a client callback that raises mid-fan-out must
        # not skip the snapshots — or the completions — of the members
        # behind it in the same group.
        live: list[Entity] = []
        for ent, res in zip(ents, results if status == "done"
                            else [None] * len(ents)):
            if self.is_cancelled(ent.query_id):
                continue           # cancelled while in flight: drop silently
            if status == "failed":
                if self._try_fallback(ent, 1, "remote", payload):
                    continue       # re-enqueued for native; not failed
                ent.failed = (f"remote op {ent.current_op().name} "
                              f"failed: {payload}")
                self.erd.update(ent, "remote-error")
            else:
                self._advance_segment(ent, res, "remote")
            live.append(ent)
        for ent in live:
            try:
                if ent.failed:
                    self.on_entity_done(ent)
                else:
                    self._finish_segment(ent)
            except Exception:  # noqa: BLE001 — a raising client callback
                pass           # must not strand the rest of the group
    # ---------------------------------------------------------- shutdown
    def shutdown(self, timeout: float = 5.0):
        """Stop and *join* all loop threads (daemon threads abandoned
        mid-work race with interpreter teardown when tests spin up many
        engines)."""
        self.queue1.close()
        self.queue2.put(_STOP)
        for w in self.workers:
            w.join(timeout)
        self.thread3.join(timeout)
