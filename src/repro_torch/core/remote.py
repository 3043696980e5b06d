"""Remote operation execution (paper section 4.2 + 5.3): an ecosystem of
kappa remote servers with plug-and-play endpoints.

Each ``RemoteServer`` is a worker thread with its own request queue —
the stand-in for a Flask endpoint on another machine.  The transport and
capacity model is explicit and calibrated (ARCHITECTURE.md): a request
costs ``network_latency + payload_bytes/bandwidth + op_service_time``,
realized with real op execution plus a GIL-releasing sleep for the
network/remote-compute component, so overlap measured by the benchmarks
is genuine host-side overlap.

Production features beyond the paper's prototype:
- least-loaded dispatch (in addition to the paper's implicit round-robin);
- straggler mitigation: requests outstanding > ``straggler_factor`` x
  a moving latency estimate are re-issued to another server, first
  response wins (duplicates discarded by request id);
- fault tolerance (ARCHITECTURE.md "Fault tolerance"): a killed
  server's in-flight requests are re-queued; failures are classified by
  the :mod:`repro_torch.distributed.fault` taxonomy (``PermanentError`` skips
  retries, everything else is presumed transient); retries are capped
  by ``max_retries``, go to a *different* server than the one that just
  failed, back off exponentially with full jitter when
  ``retry_backoff_base_s > 0`` (default 0: instant resubmit, the
  pre-fault-layer behavior), and never outlive a request's ``deadline``;
  silent server death is detected by missed heartbeats when
  ``heartbeat_timeout_s > 0`` (stranded in-flight work is re-queued to
  live peers); elastic scale in/out at runtime.  A
  :class:`~repro_torch.distributed.fault.FaultInjector` hooks each server's
  service loop for deterministic chaos testing.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import queue
import random
import threading
import time
from typing import Any, Callable, Optional


from repro_torch.core.pipeline import Operation, run_op
from repro_torch.distributed.fault import (DeadlineExceeded,
                                           FaultInjector, HeartbeatMonitor,
                                           NoLiveServersError,
                                           PermanentError, TransientError)


@dataclasses.dataclass
class TransportModel:
    """Calibrated cost model for the simulated network + remote compute."""
    network_latency_s: float = 0.002      # per request round trip
    bandwidth_bytes_s: float = 1e9        # payload both ways
    service_time_s: float = 0.0           # extra remote compute per entity
    execute_ops: bool = True              # actually run the op (correctness)

    def cost(self, payload_bytes: int) -> float:
        return self.network_latency_s + 2 * payload_bytes / self.bandwidth_bytes_s \
            + self.service_time_s

    def cost_batch(self, payloads: list[int]) -> float:
        """One request carrying N entities: latency paid once (this is the
        win batched dispatch buys — see ARCHITECTURE.md "coalescing")."""
        return self.network_latency_s + 2 * sum(payloads) / self.bandwidth_bytes_s \
            + self.service_time_s * len(payloads)


@dataclasses.dataclass
class Request:
    rid: int
    entity: Any          # Entity (pointer semantics, paper section 5.1.1)
    op: Operation
    reply_to: queue.Queue
    issued_at: float = 0.0
    attempt: int = 0
    reissues: int = 0
    last_sid: int = -1   # server of the most recent submission (retry
                         # and heartbeat-requeue exclude it)
    deadline: Optional[float] = None   # monotonic; retries never outlive it


def _batch_size(req: Request) -> int:
    return len(req.entity) if isinstance(req.entity, list) else 1


class RemoteServer:
    def __init__(self, sid: int, transport: TransportModel, *,
                 fault_injector: Optional[FaultInjector] = None,
                 beat: Optional[Callable[[int], None]] = None,
                 beat_interval_s: float = 0.0):
        self.sid = sid
        self.transport = transport
        self.inbox: queue.Queue = queue.Queue()
        self.alive = True
        self.busy = False
        self.processed = 0
        self.transport_busy_s = 0.0   # accumulated cost_batch time
        self._pending = 0             # queued + in-service ENTITIES
        self._pending_lock = threading.Lock()
        self._fi = fault_injector
        self._beat = beat
        self._beat_interval = beat_interval_s
        self._hung = False            # injected silent death: no replies,
                                      # no beats — heartbeat-detect only
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"remote-server-{sid}")
        self._thread.start()

    def submit(self, req: Request):
        with self._pending_lock:
            self._pending += _batch_size(req)
        self.inbox.put(req)

    def _finished(self, req: Request):
        with self._pending_lock:
            self._pending -= _batch_size(req)

    def pending_load(self) -> int:
        # entities, not requests: a k-entity coalesced batch is k units of
        # pending work, so least_loaded dispatch stays balanced when
        # batched and per-entity requests mix
        with self._pending_lock:
            return self._pending

    def kill(self, join_timeout: float | None = 5.0):
        self.alive = False
        self.inbox.put(None)  # wake
        # Join so the worker is not abandoned mid-request (daemon threads
        # racing interpreter teardown). The thread exits promptly: it
        # finishes at most one in-service request, then drains its inbox.
        if join_timeout and self._thread is not threading.current_thread():
            self._thread.join(join_timeout)

    def join(self, timeout: float | None = None):
        self._thread.join(timeout)

    def _inject(self, req: Request) -> bool:
        """Consult the fault injector for this request.  Returns True
        when the request was consumed by a fault (reply already sent, or
        deliberately withheld); a latency spike instead lands in
        ``_fault_latency_s`` and the request proceeds."""
        self._fault_latency_s = 0.0
        if self._fi is None:
            return False
        fault = self._fi.decide(f"remote:{self.sid}")
        if fault is None:
            return False
        if fault.kind == "latency":
            self._fault_latency_s = fault.latency_s
            return False
        self._finished(req)
        if fault.kind == "hang":
            # silent death: stop replying AND stop beating — this
            # request (and everything routed here until the heartbeat
            # monitor notices) is recovered by the pool's requeue
            self._hung = True
        elif fault.kind == "die":
            # death mid-batch: the rest of the inbox drains through the
            # not-alive branch below, each re-queued by the retry path
            self.alive = False
            req.reply_to.put(("server_died", req, None))
        elif fault.kind == "crash":
            # crash-before-reply: the work is lost but the server
            # survives; the caller sees the same signal a death does
            req.reply_to.put(("server_died", req, None))
        else:   # "error"
            req.reply_to.put(("error", req, TransientError(
                f"injected error at remote server {self.sid}")))
        return True

    def _run(self):
        self._fault_latency_s = 0.0
        while True:
            if self._beat is not None and not self._hung:
                self._beat(self.sid)
            if self._beat_interval > 0.0:
                try:
                    req = self.inbox.get(timeout=self._beat_interval)
                except queue.Empty:
                    continue
            else:
                req = self.inbox.get()
            if req is None:
                if not self.alive:
                    # drain: fail everything left so the pool re-queues
                    # it (a HUNG server stays silent even here — its
                    # stranded work is the heartbeat monitor's to find)
                    while True:
                        try:
                            r = self.inbox.get_nowait()
                        except queue.Empty:
                            break
                        if r is not None:
                            self._finished(r)
                            if not self._hung:
                                r.reply_to.put(("server_died", r, None))
                    return
                continue
            if self._hung:
                self._finished(req)   # swallowed without a reply
                continue
            if not self.alive:
                self._finished(req)
                req.reply_to.put(("server_died", req, None))
                continue
            if self._inject(req):
                continue
            self.busy = True
            try:
                # single path for per-entity and batched requests: the
                # transport cost of a request is ALWAYS cost_batch over
                # its payloads (cost_batch([p]) == cost(p)), never a
                # per-payload cost() sum — one request pays the network
                # latency once, which is the amortization batching buys
                batched = isinstance(req.entity, list)
                ents = req.entity if batched else [req.entity]
                datas = [e.data for e in ents]
                dt = self.transport.cost_batch(
                    [getattr(d, "nbytes", 0) for d in datas]) \
                    + self._fault_latency_s
                self.transport_busy_s += dt
                # network + remote-capacity cost (GIL-releasing)
                time.sleep(dt)
                results = [run_op(req.op, d) if self.transport.execute_ops
                           else d for d in datas]
                for r in results:
                    if r is not None and hasattr(r, "block_until_ready"):
                        r.block_until_ready()
                self.processed += len(results)
                req.reply_to.put(("ok", req,
                                  results if batched else results[0]))
            except Exception as e:  # noqa: BLE001 — report, don't kill worker
                req.reply_to.put(("error", req, e))
            finally:
                self._finished(req)
                self.busy = False


class RemoteServerPool:
    """kappa servers + dispatch policy + retry/straggler/health logic."""

    def __init__(self, num_servers: int = 1,
                 transport: TransportModel | None = None,
                 policy: str = "round_robin",
                 max_retries: int = 3,
                 straggler_factor: float = 4.0,
                 retry_backoff_base_s: float = 0.0,
                 retry_backoff_max_s: float = 1.0,
                 heartbeat_timeout_s: float = 0.0,
                 fault_injector: Optional[FaultInjector] = None):
        self.transport = transport or TransportModel()
        self.policy = policy
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.retry_backoff_base_s = max(0.0, retry_backoff_base_s)
        self.retry_backoff_max_s = max(self.retry_backoff_base_s,
                                       retry_backoff_max_s)
        self.heartbeat_timeout_s = max(0.0, heartbeat_timeout_s)
        self.fault_injector = fault_injector
        self.monitor: Optional[HeartbeatMonitor] = None
        if self.heartbeat_timeout_s > 0.0:
            self.monitor = HeartbeatMonitor(
                [], timeout_s=self.heartbeat_timeout_s,
                on_failure=self._beat_missed)
        self.servers: list[RemoteServer] = [
            self._spawn_server(i) for i in range(num_servers)]
        self._rr = itertools.count()
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self.inflight: dict[int, Request] = {}          # guarded-by: _lock
        self._retry_heap: list[tuple[float, int]] = []  # guarded-by: _lock
        self._jitter = random.Random(0x5EED)  # backoff jitter (full jitter)
        self.dispatched = 0         # guarded-by: _lock
        self.duplicates_dropped = 0  # guarded-by: _lock
        self.reissued = 0           # guarded-by: _lock
        self.retried = 0            # guarded-by: _lock
        self.retries_delayed = 0    # guarded-by: _lock
        self.cancelled_dropped = 0  # guarded-by: _lock
        self.deadline_exhausted = 0  # guarded-by: _lock
        self.beat_deaths = 0        # guarded-by: _lock
        self.beat_requeued = 0      # guarded-by: _lock
        self._cancelled_rids: set[int] = set()          # guarded-by: _lock
        self._lat_est = self.transport.cost(1 << 20)  # moving latency estimate
        self._lat_samples = 0

    # ------------------------------------------------------------ servers
    def _spawn_server(self, sid: int) -> RemoteServer:
        beat = None
        interval = 0.0
        if self.monitor is not None:
            self.monitor.register(f"server-{sid}")
            beat = self._beat
            # servers must beat several times per timeout window, but a
            # too-tight poll loop would burn cpu on idle servers
            interval = max(1e-3, self.heartbeat_timeout_s / 4.0)
        return RemoteServer(sid, self.transport,
                            fault_injector=self.fault_injector,
                            beat=beat, beat_interval_s=interval)

    def _beat(self, sid: int):
        self.monitor.beat(f"server-{sid}")

    def _beat_missed(self, worker: str):
        """HeartbeatMonitor callback: a server went silent (no error
        reply, no death signal — e.g. an injected hang).  Mark it dead
        and re-queue its in-flight requests to live peers; if a reply
        does straggle in later, first-response-wins duplicate
        suppression drops it."""
        sid = int(worker.rsplit("-", 1)[1])
        server = self.servers[sid]
        if not server.alive:
            return          # already dead through the explicit path
        server.alive = False
        server.inbox.put(None)   # wake it so its queue drains
        with self._lock:
            self.beat_deaths += 1
            stranded = [r for r in self.inflight.values()
                        if r.last_sid == sid]
        for r in stranded:
            try:
                s = self._pick(exclude=sid)
            except NoLiveServersError:
                # nothing to requeue onto; the retry/straggler paths (or
                # the event loop's dispatch guard) surface the outage
                break
            r.issued_at = time.monotonic()
            r.last_sid = s.sid
            with self._lock:
                self.beat_requeued += 1
            s.submit(r)

    # ---------------------------------------------------------- dispatch
    def _pick(self, exclude: int | None = None) -> RemoteServer:
        """A live server, skipping ``exclude`` (the server that just
        failed a request) unless it is the only one left."""
        live = [s for s in self.servers if s.alive]
        if not live:
            raise NoLiveServersError("no live remote servers")
        if exclude is not None and len(live) > 1:
            live = [s for s in live if s.sid != exclude] or live
        if self.policy == "least_loaded":
            return min(live, key=lambda s: s.pending_load())
        return live[next(self._rr) % len(live)]

    def dispatch(self, entity, op: Operation, reply_to: queue.Queue) -> int:
        ents = entity if isinstance(entity, list) else [entity]
        # batch deadline: the LOOSEST member budget (a retry is still
        # worth making while any member could use the result); None if
        # any member is unbounded
        deadlines = [getattr(e, "deadline", None) for e in ents]
        deadline = (None if any(d is None for d in deadlines)
                    else max(deadlines))
        # pick BEFORE registering so a pool-level raise (every server
        # dead) cannot leak a forever-inflight request
        server = self._pick()
        req = Request(rid=next(self._rid), entity=entity, op=op,
                      reply_to=reply_to, issued_at=time.monotonic(),
                      last_sid=server.sid, deadline=deadline)
        with self._lock:
            self.inflight[req.rid] = req
            self.dispatched += 1
        server.submit(req)
        return req.rid

    # --------------------------------------------------------- responses
    def handle_response(self, tag: str, req: Request, payload):
        """Called by the event loop with a server reply.  Returns
        ("done", result) | ("dropped", None) | ("requeued", None) |
        ("failed", exc_or_payload)."""
        with self._lock:
            live = req.rid in self.inflight
            if live:
                del self.inflight[req.rid]
            elif req.rid in self._cancelled_rids:
                # late reply for a cancelled query's request: not a
                # straggler duplicate — keep the two stats separate
                self._cancelled_rids.discard(req.rid)
                return ("dropped", None)
            else:
                self.duplicates_dropped += 1
        if not live:
            return ("dropped", None)
        if tag == "ok":
            # amortized PER-ENTITY latency: a k-entity batch legitimately
            # takes ~cost_batch longer, and must neither inflate the
            # estimate for per-entity requests nor look like a straggler
            dt = (time.monotonic() - req.issued_at) / _batch_size(req)
            self._lat_est = 0.9 * self._lat_est + 0.1 * dt
            self._lat_samples += 1
            return ("done", payload)
        # failure path: classify, then retry on ANOTHER server with
        # bounded exponential backoff + full jitter.  Only an explicit
        # PermanentError skips retries — untyped exceptions stay
        # retryable, the pre-taxonomy behavior.
        if isinstance(payload, PermanentError):
            return ("failed", payload)
        if req.attempt + 1 >= self.max_retries:
            return ("failed", payload)
        delay = 0.0
        if self.retry_backoff_base_s > 0.0:
            cap = min(self.retry_backoff_max_s,
                      self.retry_backoff_base_s * (2.0 ** req.attempt))
            delay = self._jitter.uniform(0.0, cap)
        now = time.monotonic()
        if req.deadline is not None and now + delay >= req.deadline:
            with self._lock:
                self.deadline_exhausted += 1
            return ("failed", DeadlineExceeded(
                f"retry budget exhausted after {req.attempt + 1} "
                f"attempt(s): {payload}"))
        req.attempt += 1
        failed_sid = req.last_sid
        if delay <= 0.0:
            req.issued_at = now
            with self._lock:
                self.retried += 1
                self.inflight[req.rid] = req
            try:
                server = self._pick(exclude=failed_sid)
            except NoLiveServersError as e:
                with self._lock:
                    self.inflight.pop(req.rid, None)
                return ("failed", e)
            req.last_sid = server.sid
            server.submit(req)
        else:
            with self._lock:
                self.retried += 1
                self.retries_delayed += 1
                self.inflight[req.rid] = req
                heapq.heappush(self._retry_heap, (now + delay, req.rid))
        return ("requeued", None)

    # ------------------------------------------------------ delayed retry
    def next_retry_due(self) -> Optional[float]:
        """Monotonic time of the earliest scheduled retry (None when the
        heap is empty) — folded into Thread_3's poll timeout so a backoff
        never oversleeps."""
        with self._lock:
            return self._retry_heap[0][0] if self._retry_heap else None

    def flush_due_retries(self):
        """Resubmit every scheduled retry whose backoff has elapsed.
        Requests whose query was cancelled meanwhile left ``inflight``
        via ``drop_query`` and are skipped (and their cancelled-rid
        bookkeeping is settled — no late reply is coming)."""
        now = time.monotonic()
        due: list[Request] = []
        with self._lock:
            while self._retry_heap and self._retry_heap[0][0] <= now:
                _, rid = heapq.heappop(self._retry_heap)
                req = self.inflight.get(rid)
                if req is None:
                    self._cancelled_rids.discard(rid)
                    continue
                due.append(req)
        for req in due:
            try:
                server = self._pick(exclude=req.last_sid)
            except NoLiveServersError as e:
                # route the outage through the normal reply path so the
                # event loop fails (or falls back) the entities exactly
                # like any other terminal error
                req.reply_to.put(("error", req, e))
                continue
            req.issued_at = time.monotonic()
            req.last_sid = server.sid
            server.submit(req)

    # ------------------------------------------------------- cancellation
    def drop_query(self, query_id: str) -> int:
        """Forget in-flight requests belonging to a cancelled/timed-out
        query.  The server replies still arrive, but ``handle_response``
        no longer finds their rid and drops them — exactly the duplicate-
        suppression path — so nothing is orphaned in ``inflight``.
        Batched requests mixing several queries are kept; the event loop
        filters their per-entity results instead."""

        def _belongs(ent) -> bool:
            if isinstance(ent, list):
                return all(e.query_id == query_id for e in ent)
            return ent.query_id == query_id

        with self._lock:
            doomed = [rid for rid, r in self.inflight.items()
                      if _belongs(r.entity)]
            for rid in doomed:
                del self.inflight[rid]
                self._cancelled_rids.add(rid)
            self.cancelled_dropped += len(doomed)
            if len(self._cancelled_rids) > 100_000:  # lost-reply backstop
                self._cancelled_rids.clear()
        return len(doomed)

    # --------------------------------------------------------- stragglers
    def reissue_stragglers(self):
        """Re-send requests outstanding > straggler_factor x the latency
        estimate.  Guarded: the estimate must have warmed up (first calls
        include jit compilation), and each request is re-issued at most
        once — duplicates are resolved first-response-wins."""
        if self._lat_samples < 8:
            return
        now = time.monotonic()
        # expected wall of a k-entity request = fixed per-request latency
        # + k x amortized per-entity cost; scaling ONLY the per-entity
        # term keeps single requests from looking like stragglers when
        # batched traffic has driven the amortized estimate far below the
        # fixed network latency
        fixed = self.transport.network_latency_s
        with self._lock:
            slow = [r for r in self.inflight.values()
                    if r.reissues == 0
                    and now - r.issued_at > self.straggler_factor
                    * (fixed + max(self._lat_est, 1e-4) * _batch_size(r))]
        for r in slow:
            # re-check membership UNDER the lock at reissue time: the
            # query may have been cancelled (drop_query) since the
            # snapshot above, and resubmitting a forgotten request
            # would race its own cancellation bookkeeping
            with self._lock:
                if r.rid not in self.inflight or r.reissues > 0:
                    continue
                r.reissues += 1
                self.reissued += 1
            try:
                s = self._pick(exclude=r.last_sid)
            except NoLiveServersError:
                return
            r.last_sid = s.sid
            s.submit(r)

    def tick(self):
        """Thread_3's periodic pool maintenance: straggler reissue,
        elapsed-backoff retry flush, and heartbeat liveness check."""
        self.reissue_stragglers()
        self.flush_due_retries()
        if self.monitor is not None:
            self.monitor.check()

    # ------------------------------------------------------------ elastic
    def scale_to(self, n: int):
        """Elastic scale out/in (future-work item (c) of the paper)."""
        while len([s for s in self.servers if s.alive]) < n:
            self.servers.append(self._spawn_server(len(self.servers)))
        live = [s for s in self.servers if s.alive]
        for s in live[n:]:
            # signal only: elastic scale-in must not block the caller
            # through sequential drains (threads are joined at shutdown)
            s.kill(join_timeout=None)

    def kill_server(self, sid: int):
        self.servers[sid].kill()

    def live_count(self) -> int:
        return sum(s.alive for s in self.servers)

    def pending_entities(self) -> int:
        """Entities queued + in service across live servers (the remote
        queue-wait signal the dispatch cost model reads)."""
        return sum(s.pending_load() for s in self.servers if s.alive)

    def latency_estimate(self) -> float:
        """Amortized per-entity latency moving estimate (also feeds the
        dispatch cost model's remote queue-wait term)."""
        return self._lat_est

    def backlog_estimate_s(self) -> float:
        """Projected seconds of remote work outstanding right now —
        pending entities weighted by the amortized per-entity latency
        estimate, spread over the live servers.  The remote term of the
        admission controller's load score."""
        live = max(1, self.live_count())
        return self.pending_entities() * self._lat_est / live

    # -------------------------------------------------------------- health
    def health_stats(self) -> dict:
        """Liveness + retry/failover counters, surfaced through
        ``engine.dispatch_stats()["pool"]``."""
        now = time.monotonic()
        beats = (self.monitor.last_beats()
                 if self.monitor is not None else {})
        with self._lock:
            retries_pending = len(self._retry_heap)
            counters = {"beat_deaths": self.beat_deaths,
                        "beat_requeued": self.beat_requeued,
                        "retried": self.retried,
                        "retries_delayed": self.retries_delayed,
                        "retries_pending": retries_pending,
                        "deadline_exhausted": self.deadline_exhausted,
                        "reissued": self.reissued}
        servers = []
        for s in self.servers:
            row = {"sid": s.sid, "alive": s.alive, "pending": s.pending_load(),
                   "processed": s.processed}
            last = beats.get(f"server-{s.sid}")
            if last is not None:
                row["beat_age_s"] = now - last
            servers.append(row)
        return {"live": self.live_count(),
                "heartbeat": self.monitor is not None,
                **counters,
                "servers": servers}

    def shutdown(self, timeout: float = 5.0):
        for s in self.servers:
            s.kill(join_timeout=None)   # signal everyone first ...
        for s in self.servers:
            s.join(timeout)             # ... then join (parallel drain)
