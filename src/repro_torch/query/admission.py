"""Admission control + overload shedding (ROADMAP: "Admission control
on top of sessions").

The engine accepts every ``submit()`` unconditionally by default — the
paper's event-driven pipeline scales linearly with remote servers only
while its queues stay bounded, and under heavy fan-in Queue_1/Queue_2
and the coalescing/device micro-batch buffers grow without limit until
latency collapses (the synchronous-saturation failure mode VDMS-Async
was designed to escape, reproduced by ``benchmarks/admission_bench.py``'s
unbounded arm).  This module bounds the engine instead:

- an :class:`AdmissionController` tracks the number of **in-flight
  entities** (launched onto the event loop but not yet completed,
  failed, or cancelled) against a hard cap ``max_inflight_entities``;
- ``admission="shed"`` rejects a query whose phase fan-out does not fit
  under the cap with a typed :class:`OverloadError` carrying a
  ``retry_after_s`` estimate — nothing of the query is launched;
- ``admission="queue"`` accepts the query and parks entities that do
  not fit in a **priority-ordered pending lane** (``submit(...,
  priority=)``; higher first, FIFO within a priority), bounded by
  ``admission_queue_cap``.  The lane drains as in-flight entities
  complete — the drain runs on the event-loop threads that deliver
  completions, so no extra thread polls for capacity;
- Add barrier phases **reserve** their capacity atomically *before*
  expansion runs (``reserve``), because expansion is where the Add's
  ingest side effect happens: a check-only gate would let two queries
  racing the same last slot both pass, both ingest, and then have one
  rejected post-ingest;
- cancellation / timeout / engine shutdown drop a query's pending
  admissions exactly the way they drop its queued and in-flight work:
  ``drop_query`` forgets the pending entities, the in-flight count and
  any unconsumed reservation in one atomic step, so the cap's ledger
  can never be skewed by a cancel racing a completion.

The **load score** combines the overload signals the rest of the stack
already exposes — the admission ledger itself (in-flight fraction), the
native pool's BusyMeter utilization, Queue_1 depth, the remote pool's
pending depth weighted by its amortized latency estimate
(:meth:`repro_torch.core.remote.RemoteServerPool.backlog_estimate_s`), and the
batcher/device micro-batch queue depths — into one number (≥ 1.0 means
saturated).  The *admission decision* is exact on the in-flight ledger
(that is the invariant benchmarks assert); the score feeds the
``retry_after_s`` estimate, the saturation fast path that rejects
before a phase is even expanded, and ``engine.admission_stats()``.

``admission="none"`` (the default) builds none of this: ``submit()``
behaves byte-identically to the unbounded engine (hash-checked in CI
via ``benchmarks/admission_bench.py``).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Any, Callable, Optional

POLICIES = ("none", "queue", "shed")


class OverloadError(RuntimeError):
    """A query was rejected by admission control.

    Attributes:
      ``retry_after_s`` — estimated seconds until the requested capacity
      is likely to be available (deficit entities / recent completion
      rate, clamped to [1e-3, 60]); ``load`` — the load-score component
      snapshot at rejection time (see
      :meth:`AdmissionController.load_score`); ``tenant`` — set when the
      rejection came from a per-tenant quota rather than the global cap
      (the serving front-end surfaces it in the 429 frame so a client
      can tell "the engine is full" from "YOUR share is full").
    """

    def __init__(self, msg: str, *, retry_after_s: float = 1.0,
                 load: dict | None = None, tenant: str | None = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.load = load or {}
        self.tenant = tenant


class AdmissionController:
    """Bounds concurrent in-flight entities and sheds/queues overflow.

    One lock guards the whole ledger — the global in-flight count, the
    per-query counts, and the pending lane — so every transition
    (admit, complete, drop, drain) is atomic: a cancel racing a
    completion can neither double-release nor leak capacity.

    Lifecycle: the engine constructs the controller before any loop
    thread exists (knob validation must not leak threads), then
    ``bind``\\ s it to the live signal sources and the launch callable.
    """

    def __init__(self, *, max_inflight: int, policy: str,
                 queue_cap: int = 1024,
                 tenant_weights: dict | None = None,
                 tenant_default_weight: float = 1.0,
                 cost_aware: bool = False,
                 cost_cap_s: float = 0.0,
                 clock=time.monotonic):
        if policy not in ("queue", "shed"):
            raise ValueError(
                f"admission policy must be 'queue' or 'shed' once "
                f"enabled, got {policy!r}")
        if max_inflight <= 0:
            raise ValueError(
                f"max_inflight_entities must be > 0 when admission is "
                f"enabled, got {max_inflight}")
        if queue_cap < 0:
            raise ValueError(
                f"admission_queue_cap must be >= 0, got {queue_cap}")
        if tenant_weights is not None:
            if not tenant_weights:
                raise ValueError(
                    "tenant_weights must name at least one tenant when "
                    "given (an empty quota table would be silently inert)")
            for t, w in tenant_weights.items():
                if not isinstance(t, str) or not t:
                    raise ValueError(
                        f"tenant names must be non-empty strings, got {t!r}")
                if not isinstance(w, (int, float)) or w <= 0:
                    raise ValueError(
                        f"tenant weight for {t!r} must be > 0, got {w!r}")
        if tenant_default_weight <= 0:
            raise ValueError(
                f"tenant_default_weight must be > 0, got "
                f"{tenant_default_weight!r}")
        if cost_aware and cost_cap_s <= 0:
            raise ValueError(
                f"cost-aware admission needs cost_cap_s > 0 (the "
                f"work-seconds budget it charges against), got "
                f"{cost_cap_s!r}")
        if cost_cap_s > 0 and not cost_aware:
            raise ValueError(
                "cost_cap_s requires cost_aware (a work-seconds budget "
                "nothing charges against would be silently inert)")
        self.max_inflight = max_inflight
        self.policy = policy
        self.queue_cap = queue_cap
        # ---- admission v2 (both default-off; see class docstring) ----
        # per-tenant weighted quotas: tenant t's share of the admission
        # budget is weight(t) / (sum of configured weights [+ t's weight
        # when it is an unlisted tenant]); the empty tenant "" (plain
        # in-process submits) is exempt, so default-path behavior is
        # untouched.  cost-aware admission charges each entity its
        # estimated work-seconds (ops x OpCostTracker.mean_cost_estimate)
        # against cost_cap_s instead of counting raw entities; the
        # entity-count ledger stays authoritative for leak invariants.
        self.tenant_weights = (dict(tenant_weights)
                               if tenant_weights is not None else None)
        self.tenant_default_weight = tenant_default_weight
        self.cost_aware = cost_aware
        self.cost_cap_s = cost_cap_s
        self._tenant_used: dict[str, float] = {}      # guarded-by: _lock
        self._tenant_reserved: dict[str, float] = {}  # guarded-by: _lock
        self._tenant_by_query: dict[str, str] = {}    # guarded-by: _lock
        self._units_by_query: dict[str, float] = {}   # guarded-by: _lock
        self._inflight_cost = 0.0                     # guarded-by: _lock
        self._pending_cost = 0.0                      # guarded-by: _lock
        self._pending_cost_by_query: dict[str, float] = {}  # guarded-by: _lock
        self._reserved_cost_total = 0.0               # guarded-by: _lock
        self._reserved_cost_by_query: dict[str, float] = {}  # guarded-by: _lock
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight = 0                            # guarded-by: _lock
        self._inflight_by_query: dict[str, int] = {}  # guarded-by: _lock
        # pending lane: heap of (-priority, seq, entity); seq keeps FIFO
        # order within a priority.  _pending_by_query is the liveness
        # ledger — a heap entry whose query has no pending count is a
        # tombstone left by drop_query and is skipped at pop time.
        self._heap: list[tuple[int, int, Any]] = []   # guarded-by: _lock
        self._seq = itertools.count()
        self._pending_total = 0                       # guarded-by: _lock
        self._pending_by_query: dict[str, int] = {}   # guarded-by: _lock
        # pre-ingest reservations (see reserve()): under "shed" a
        # reservation holds in-flight slots, under "queue" it holds
        # pending-lane budget, so a query told "admitted" before its
        # Add barrier wrote can never be rejected afterwards
        self._reserved_total = 0                      # guarded-by: _lock
        self._reserved_by_query: dict[str, int] = {}  # guarded-by: _lock
        self._closed = False                          # guarded-by: _lock
        # completion-rate EWMA (entities/second across the whole engine)
        # — the primary input to the retry-after estimate
        self._rate = 0.0                              # guarded-by: _lock
        self._last_done: float | None = None          # guarded-by: _lock
        # lifetime counters
        self.admitted = 0                             # guarded-by: _lock
        self.queued = 0                               # guarded-by: _lock
        self.shed = 0                                 # guarded-by: _lock
        self.completed = 0                            # guarded-by: _lock
        self.dropped = 0                              # guarded-by: _lock
        self.peak_inflight = 0                        # guarded-by: _lock
        # live signal sources (bound after the loop exists)
        self._loop = None
        self._pool = None
        self._offload: list = []
        self._tracker = None
        self._launch: Optional[Callable[[list], None]] = None

    # ---------------------------------------------------- engine plumbing
    def bind(self, *, loop, pool, launch, offload_backends=(),
             tracker=None) -> None:
        """Attach the live overload-signal sources and the launch
        callable the drain uses (``engine._launch_now``)."""
        self._loop = loop
        self._pool = pool
        self._offload = [b for b in offload_backends if b is not None]
        self._tracker = tracker
        self._launch = launch

    # -------------------------------------------------------- load signal
    def utilization(self) -> float:
        """Native-pool busy fraction over the recent window, in [0, 1]
        (the same BusyMeter signal the dispatch cost model reads)."""
        if self._loop is None:
            return 0.0
        return self._loop.t2_meter.utilization(
            workers=self._loop.num_native_workers)

    def load_score(self) -> dict:
        """Single load score plus its components.  ``score >= 1.0``
        reads as saturated: the in-flight ledger is full, or the queues
        behind it hold more than a capful of work."""
        with self._lock:
            inflight = self._inflight
            pending = self._pending_total
        return self._compose_load(inflight, pending)

    def _compose_load(self, inflight: int, pending: int) -> dict:
        """Assemble the load snapshot from already-read ledger values —
        takes no controller lock, so it is safe both from
        :meth:`load_score` and from inside ``_overload_locked`` (which
        already holds ``_lock``)."""
        cap = float(self.max_inflight)
        util = self.utilization()
        q1 = self._loop.queue1.qsize() if self._loop is not None else 0
        remote_backlog_s = (self._pool.backlog_estimate_s()
                            if self._pool is not None else 0.0)
        offload_depth = sum(b.queue_depth() for b in self._offload)
        # per-entity service estimate turns the remote backlog (seconds)
        # into entity units so every component shares the cap's scale
        per_entity = self._service_estimate()
        score = (inflight / cap
                 + 0.5 * util
                 + 0.25 * (q1 + pending + offload_depth
                           + remote_backlog_s / per_entity) / cap)
        return {"score": score, "inflight_frac": inflight / cap,
                "native_util": util, "queue1_depth": q1,
                "pending_admissions": pending,
                "remote_backlog_s": remote_backlog_s,
                "offload_depth": offload_depth,
                "per_entity_est_s": per_entity}

    def _service_estimate(self) -> float:
        """Per-entity service-time estimate (seconds), best signal
        first: the observed engine-wide completion rate, else the cost
        tracker's mean per-op estimate, else the remote pool's
        amortized latency estimate, else 1 ms.  Lock-free by design
        (the single float read of ``_rate`` is GIL-atomic and the
        estimate is heuristic), so it is safe with or without
        ``_lock`` held."""
        if self._rate > 0.0:  # analysis: ok(guarded-by) — GIL-atomic heuristic read
            return 1.0 / self._rate  # analysis: ok(guarded-by) — GIL-atomic heuristic read
        if self._tracker is not None:
            est = self._tracker.mean_cost_estimate()
            if est is not None:
                return est
        if self._pool is not None:
            return max(1e-4, self._pool.latency_estimate())
        return 1e-3

    def _overload_locked(self, msg: str, deficit: int,
                         tenant: str | None = None) -> OverloadError:
        retry = min(60.0, max(1e-3, deficit * self._service_estimate()))
        return OverloadError(f"{msg} (retry_after_s={retry:.3g})",
                             retry_after_s=retry,
                             load=self._compose_load(self._inflight,
                                                     self._pending_total),
                             tenant=tenant)

    def _overload_seconds_locked(self, msg: str, deficit_s: float,
                                 tenant: str | None = None) -> OverloadError:
        """Overload whose deficit is already in work-seconds (cost-aware
        admission / tenant quotas under it): the retry estimate IS the
        deficit, no per-entity conversion needed."""
        retry = min(60.0, max(1e-3, deficit_s))
        return OverloadError(f"{msg} (retry_after_s={retry:.3g})",
                             retry_after_s=retry,
                             load=self._compose_load(self._inflight,
                                                     self._pending_total),
                             tenant=tenant)

    # ------------------------------------------------- admission v2 units
    def unit_charge(self, n_ops: int = 1) -> float:
        """The admission charge for one entity, in this controller's
        units: ``1.0`` (one entity) normally, or the entity's estimated
        work-seconds — ops x the cost tracker's calibrated mean per-op
        estimate (1 ms until anything is observed) — under cost-aware
        admission."""
        if not self.cost_aware:
            return 1.0
        est = None
        if self._tracker is not None:
            est = self._tracker.mean_cost_estimate()
        if est is None:
            est = 1e-3
        return max(1, n_ops) * est

    def _tenant_cap_locked(self, tenant: str) -> float:
        """Tenant ``tenant``'s weighted fair share of the admission
        budget, in units.  Unlisted tenants weigh
        ``tenant_default_weight`` (their weight joins the denominator,
        so a configured tenant's share is computed against a stable
        total plus at most one stranger)."""
        w = self.tenant_weights.get(tenant)
        total = sum(self.tenant_weights.values())
        if w is None:
            w = self.tenant_default_weight
            total += w
        budget = self.cost_cap_s if self.cost_aware else float(
            self.max_inflight)
        return budget * w / total

    def _check_tenant_locked(self, qid: str, tenant: str, units: float,
                             *, shed_now: bool) -> bool:
        """Per-tenant quota gate.  Returns True when the work fits under
        the tenant's share right now; raises (``shed_now``) or returns
        False (park in the pending lane, drained as the tenant frees its
        own share).  A tenant holding nothing is always allowed its
        first phase, so one entity's charge exceeding a small share can
        never starve the tenant outright."""
        if self.tenant_weights is None or not tenant:
            return True
        used = (self._tenant_used.get(tenant, 0.0)
                + self._tenant_reserved.get(tenant, 0.0))
        cap = self._tenant_cap_locked(tenant)
        if used <= 0.0 or used + units <= cap + 1e-12:
            return True
        if shed_now:
            self.shed += 1
            raise self._overload_seconds_locked(
                f"tenant quota exceeded: tenant {tenant!r} of query "
                f"{qid or '<estimate>'} holds {used:.4g} of its "
                f"{cap:.4g}-unit share and asked for {units:.4g} more",
                (used + units - cap) * (self._service_estimate()
                                        if not self.cost_aware else 1.0),
                tenant=tenant)
        return False

    def _never_fits_locked(self, qid: str, n: int) -> OverloadError:
        """A first phase larger than the whole cap can NEVER be admitted
        under ``"shed"``, no matter how much capacity frees up —
        ``retry_after_s`` is ``inf`` so a retry-after-honoring client
        does not loop forever on an impossible query (``"queue"`` runs
        it by parking the overflow)."""
        return OverloadError(
            f"admission shed: query {qid or '<estimate>'} needs {n} "
            f"in-flight entities but max_inflight_entities="
            f"{self.max_inflight}; it can never be admitted under "
            f"admission='shed' — use admission='queue' or raise the cap",
            retry_after_s=float("inf"),
            load=self._compose_load(self._inflight, self._pending_total))

    # ---------------------------------------------------------- admission
    def saturated(self) -> bool:
        """Cheap pre-expand fast path: the in-flight ledger is full.
        Used by the session to fail a shed query *before* expansion
        (and before an Add phase's ingest side effects)."""
        # analysis: ok(guarded-by) — advisory fast path; admit() re-checks under _lock
        return self._inflight >= self.max_inflight

    def _avail_locked(self) -> int:
        """In-flight slots free right now.  Under ``"shed"`` reserved
        slots (pre-claimed by Add phases before their ingest) are
        already spoken for."""
        avail = self.max_inflight - self._inflight
        if self.policy == "shed":
            avail -= self._reserved_total
        return avail

    def _check_locked(self, qid: str, n: int, *, first_phase: bool,
                      tenant: str = "", units: float | None = None) -> None:
        """THE shed/queue decision, in exactly one place —
        :meth:`precheck` (advisory, on an estimate), :meth:`reserve`
        (claiming, pre-ingest) and :meth:`admit_phase` (authoritative,
        post-expand) all call it.  Raises :class:`OverloadError` iff
        ``n`` more entities cannot be accepted now.  ``units`` is the
        phase's admission charge (== ``n`` unless cost-aware); the
        entity-count decision below is byte-identical to v1 — the
        cost budget and tenant quota are additional gates layered on
        top, both inert unless configured."""
        if units is None:
            units = float(n)
        avail = self._avail_locked()
        if self.policy == "shed" and first_phase:
            if n > self.max_inflight:
                self.shed += 1
                raise self._never_fits_locked(qid, n)
            # pending continuation work has first claim on free slots
            effective = max(0, avail - self._pending_total)
            if n > effective:
                self.shed += 1
                raise self._overload_locked(
                    f"admission shed: query {qid or '<estimate>'} needs "
                    f"{n} entities, {effective} in-flight slots free "
                    f"(max_inflight_entities={self.max_inflight})",
                    n - effective)
            if self.cost_aware:
                if units > self.cost_cap_s:
                    self.shed += 1
                    raise OverloadError(
                        f"admission shed: query {qid or '<estimate>'} "
                        f"charges {units:.4g} estimated work-seconds but "
                        f"cost_cap_s={self.cost_cap_s}; it can never be "
                        f"admitted under admission='shed'",
                        retry_after_s=float("inf"),
                        load=self._compose_load(self._inflight,
                                                self._pending_total))
                free_s = max(0.0, self.cost_cap_s - self._inflight_cost
                             - self._reserved_cost_total
                             - self._pending_cost)
                if units > free_s:
                    self.shed += 1
                    raise self._overload_seconds_locked(
                        f"admission shed: query {qid or '<estimate>'} "
                        f"charges {units:.4g} work-seconds, {free_s:.4g} "
                        f"free (cost_cap_s={self.cost_cap_s})",
                        units - free_s)
            self._check_tenant_locked(qid, tenant, units, shed_now=True)
        else:
            # under "queue" a reservation holds pending-lane budget
            reserved = self._reserved_total if self.policy == "queue" else 0
            will_wait = self._pending_total + reserved + n - max(0, avail)
            if will_wait > self.queue_cap:
                self.shed += 1
                raise self._overload_locked(
                    f"admission queue full: query {qid or '<estimate>'} "
                    f"would leave {will_wait} entities pending, over "
                    f"admission_queue_cap={self.queue_cap}",
                    will_wait - self.queue_cap)

    def _v2(self) -> bool:
        """True when any admission-v2 feature (tenant quotas or
        cost-aware charging) is configured; the unit ledgers below are
        maintained only then, so the v1 path does zero extra work."""
        return self.cost_aware or self.tenant_weights is not None

    def precheck(self, n_estimate: int, *, first_phase: bool,
                 tenant: str = "", n_ops: int = 1) -> None:
        """Advisory check on an *estimated* fan-out, run before a Find
        expansion when :meth:`saturated`.  Raises
        :class:`OverloadError` when the phase certainly cannot be
        admitted; the post-expand :meth:`admit_phase` remains the
        authority (the estimate and the expansion race completions)."""
        if n_estimate <= 0:
            return
        with self._lock:
            if self._closed:
                raise self._overload_locked("engine is shutting down", 0)
            units = n_estimate * self.unit_charge(n_ops)
            self._check_locked("", n_estimate, first_phase=first_phase,
                               tenant=tenant, units=units)

    def reserve(self, qid: str, n: int, *, first_phase: bool,
                tenant: str = "", n_ops: int = 1) -> None:
        """Atomically decide AND claim admission for ``n`` entities
        *before* their side-effectful expansion runs (an Add barrier
        ingests during expand).  After a successful reserve,
        :meth:`admit_phase` for the same query consumes the claim and
        cannot raise for up to ``n`` entities — so two queries racing
        the same last slot can never both pass a check-only gate, then
        both ingest, then have one rejected post-ingest.  Dropped by
        :meth:`drop_query` / :meth:`shutdown` if the query dies before
        launching."""
        if n <= 0:
            return
        with self._lock:
            if self._closed:
                raise self._overload_locked("engine is shutting down", 0)
            units = n * self.unit_charge(n_ops)
            self._check_locked(qid, n, first_phase=first_phase,
                               tenant=tenant, units=units)
            self._reserved_total += n
            self._reserved_by_query[qid] = \
                self._reserved_by_query.get(qid, 0) + n
            if self._v2():
                self._reserved_cost_total += units
                self._reserved_cost_by_query[qid] = \
                    self._reserved_cost_by_query.get(qid, 0.0) + units
                if tenant:
                    self._tenant_by_query[qid] = tenant
                    self._tenant_reserved[tenant] = \
                        self._tenant_reserved.get(tenant, 0.0) + units

    def _release_reservation_locked(self, qid: str) -> int:
        r = self._reserved_by_query.pop(qid, 0)
        self._reserved_total -= r
        if self._v2():
            u = self._reserved_cost_by_query.pop(qid, 0.0)
            self._reserved_cost_total = max(
                0.0, self._reserved_cost_total - u)
            t = self._tenant_by_query.get(qid, "")
            if t and u > 0.0:
                left = self._tenant_reserved.get(t, 0.0) - u
                if left <= 1e-12:
                    self._tenant_reserved.pop(t, None)
                else:
                    self._tenant_reserved[t] = left
        return r

    def admit_phase(self, qid: str, ents: list, priority: int,
                    *, first_phase: bool, tenant: str = "",
                    n_ops: int = 1) -> list:
        """Admit one phase launch of ``len(ents)`` entities.  Returns
        the entities to launch *now*; the rest wait in the pending lane
        (``admission="queue"``, or any continuation phase — a query
        already running is never shed mid-flight).  Raises
        :class:`OverloadError` atomically — when it raises, nothing of
        the phase was admitted or queued (and the phase held no
        reservation, so nothing was ingested either)."""
        n = len(ents)
        with self._lock:
            if n == 0:
                self._release_reservation_locked(qid)
                return []
            if self._closed:
                self._release_reservation_locked(qid)
                raise self._overload_locked("engine is shutting down", 0)
            per = self.unit_charge(n_ops)
            if self._v2():
                # stamp each entity with its tenant and unit charge, so
                # the drain / note_done / drop paths release exactly
                # what was charged even if the cost estimate has
                # drifted by then (setattr: admission's own _E test
                # stubs and plain Entities both take it)
                for e in ents:
                    setattr(e, "tenant", tenant)
                    setattr(e, "admission_cost", per)
                if tenant:
                    self._tenant_by_query[qid] = tenant
            reserved = self._release_reservation_locked(qid)
            if self.policy == "shed" and reserved >= n:
                # pre-claimed slots go straight to in-flight, bypassing
                # the lane: the decision was made at reserve time
                # (pre-ingest) and pending work that arrived since does
                # not get to veto it.  inflight + reserved never
                # exceeded the cap, so the bound holds through the swap.
                self._inflight += n
                self._inflight_by_query[qid] = \
                    self._inflight_by_query.get(qid, 0) + n
                self.admitted += n
                if self._v2():
                    self._charge_inflight_locked(qid, tenant, n * per)
                return [*ents, *self._drain_locked()]
            if reserved < n:
                # the unreserved remainder must pass the normal check
                # (raises atomically: the reservation was already
                # refunded above, nothing is half-claimed)
                self._check_locked(qid, n - reserved,
                                   first_phase=first_phase, tenant=tenant,
                                   units=(n - reserved) * per)
            # every entity enters the lane, then the drain pops in
            # global priority order — new work can never jump ahead of
            # equal-or-higher-priority work already waiting
            for e in ents:
                heapq.heappush(self._heap, (-priority, next(self._seq), e))
            self._pending_total += n
            self._pending_by_query[qid] = \
                self._pending_by_query.get(qid, 0) + n
            self.queued += n
            if self._v2():
                self._pending_cost += n * per
                self._pending_cost_by_query[qid] = \
                    self._pending_cost_by_query.get(qid, 0.0) + n * per
            return self._drain_locked()

    def _charge_inflight_locked(self, qid: str, tenant: str,
                                units: float) -> None:
        """Move ``units`` of admission charge onto the in-flight unit
        ledgers (cost budget + tenant usage)."""
        self._inflight_cost += units
        self._units_by_query[qid] = \
            self._units_by_query.get(qid, 0.0) + units
        if tenant:
            self._tenant_used[tenant] = \
                self._tenant_used.get(tenant, 0.0) + units

    def _drain_locked(self) -> list:
        """Pop pending entities into the in-flight ledger while slots
        are free.  Tombstoned entries (queries dropped while pending)
        are skipped without touching the totals — drop_query already
        discounted them.  Under admission v2 an entry whose tenant is
        over its share, or whose charge does not fit the cost budget,
        is *skipped and re-pushed* — a later entry from another tenant
        (or a cheaper one) may still fit, and the blocked entry keeps
        its priority/FIFO position for the next drain."""
        out = []
        skipped: list[tuple[int, int, Any]] = []
        v2 = self._v2()
        while self._heap and self._inflight < self.max_inflight:
            item = heapq.heappop(self._heap)
            ent = item[2]
            qid = ent.query_id
            live = self._pending_by_query.get(qid, 0)
            if live <= 0:
                continue            # tombstone from drop_query
            if v2:
                c = getattr(ent, "admission_cost", 1.0)
                t = getattr(ent, "tenant", "")
                if (self.cost_aware and self._inflight_cost > 0.0
                        and self._inflight_cost + self._reserved_cost_total
                        + c > self.cost_cap_s + 1e-12):
                    skipped.append(item)
                    continue
                if not self._check_tenant_locked(qid, t, c, shed_now=False):
                    skipped.append(item)
                    continue
            if live == 1:
                del self._pending_by_query[qid]
            else:
                self._pending_by_query[qid] = live - 1
            self._pending_total -= 1
            self._inflight += 1
            self._inflight_by_query[qid] = \
                self._inflight_by_query.get(qid, 0) + 1
            self.admitted += 1
            if v2:
                self._pending_cost = max(0.0, self._pending_cost - c)
                left = self._pending_cost_by_query.get(qid, 0.0) - c
                if left <= 1e-12:
                    self._pending_cost_by_query.pop(qid, None)
                else:
                    self._pending_cost_by_query[qid] = left
                self._charge_inflight_locked(qid, t, c)
            out.append(ent)
        for item in skipped:
            heapq.heappush(self._heap, item)
        self.peak_inflight = max(self.peak_inflight, self._inflight)
        return out

    # --------------------------------------------------------- completion
    def note_done(self, ent) -> list:
        """One of a query's in-flight entities completed (or failed) its
        pipeline; ``ent`` is the Entity itself (so admission v2 can
        release its stamped unit charge) or, for callers that only have
        it, the query id string.  Releases its slot and returns any
        pending entities the freed capacity now admits — the caller (an
        event-loop thread) launches them.  A no-op for queries the
        controller no longer tracks (completion racing a cancel:
        ``drop_query`` already released the slot)."""
        qid = ent if isinstance(ent, str) else ent.query_id
        with self._lock:
            live = self._inflight_by_query.get(qid, 0)
            if live <= 0:
                return []
            if live == 1:
                del self._inflight_by_query[qid]
            else:
                self._inflight_by_query[qid] = live - 1
            self._inflight -= 1
            self.completed += 1
            if self._v2():
                c = (1.0 if isinstance(ent, str)
                     else getattr(ent, "admission_cost", 1.0))
                self._release_units_locked(qid, c, final=(live == 1))
            now = self._clock()
            if self._last_done is not None:
                dt = max(1e-6, now - self._last_done)
                self._rate = 0.8 * self._rate + 0.2 * (1.0 / dt)
            self._last_done = now
            if self._closed:
                return []
            return self._drain_locked()

    def _release_units_locked(self, qid: str, units: float,
                              *, final: bool) -> None:
        """Release ``units`` of in-flight admission charge for ``qid``
        (clamped to what the query actually holds, so a racing release
        can never drive a ledger negative).  ``final`` drops the
        query's per-query unit entries entirely."""
        held = self._units_by_query.get(qid, 0.0)
        u = min(units, held)
        t = self._tenant_by_query.get(qid, "")
        if final:
            self._units_by_query.pop(qid, None)
            u = held
        elif held - u <= 1e-12:
            self._units_by_query.pop(qid, None)
            u = held
        else:
            self._units_by_query[qid] = held - u
        self._inflight_cost = max(0.0, self._inflight_cost - u)
        if t:
            left = self._tenant_used.get(t, 0.0) - u
            if left <= 1e-12:
                self._tenant_used.pop(t, None)
            else:
                self._tenant_used[t] = left
        if final and qid not in self._reserved_cost_by_query \
                and qid not in self._pending_cost_by_query:
            self._tenant_by_query.pop(qid, None)

    def drop_query(self, qid: str) -> list:
        """Cancellation/timeout cleanup: atomically forget the query's
        pending admissions AND release its in-flight slots (its
        entities are being dropped by the workers and will never reach
        ``note_done``).  Returns pending entities of *other* queries
        the freed capacity now admits."""
        with self._lock:
            released = self._inflight_by_query.pop(qid, 0)
            self._inflight -= released
            pending = self._pending_by_query.pop(qid, 0)
            self._pending_total -= pending
            reserved = self._release_reservation_locked(qid)
            self.dropped += released + pending + reserved
            if self._v2():
                pc = self._pending_cost_by_query.pop(qid, 0.0)
                self._pending_cost = max(0.0, self._pending_cost - pc)
                self._release_units_locked(
                    qid, self._units_by_query.get(qid, 0.0), final=True)
                self._tenant_by_query.pop(qid, None)
            if self._closed or (released == 0 and pending == 0
                                and reserved == 0):
                return []
            return self._drain_locked()

    # ----------------------------------------------------------- shutdown
    def shutdown(self) -> None:
        """Refuse new admissions and drop the pending lane (the engine
        cancels the owning sessions, so their futures resolve with
        ``CancelledError`` — deterministic, never a hang)."""
        with self._lock:
            self._closed = True
            self._heap.clear()
            self._pending_total = 0
            self._pending_by_query.clear()
            self._reserved_total = 0
            self._reserved_by_query.clear()
            self._pending_cost = 0.0
            self._pending_cost_by_query.clear()
            self._reserved_cost_total = 0.0
            self._reserved_cost_by_query.clear()
            self._tenant_reserved.clear()

    # -------------------------------------------------------------- stats
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def pending(self) -> int:
        with self._lock:
            return self._pending_total

    def stats(self) -> dict:
        with self._lock:
            out = {
                "policy": self.policy,
                "max_inflight_entities": self.max_inflight,
                "admission_queue_cap": self.queue_cap,
                "inflight": self._inflight,
                "peak_inflight": self.peak_inflight,
                "pending": self._pending_total,
                "reserved": self._reserved_total,
                "admitted": self.admitted,
                "queued": self.queued,
                "shed": self.shed,
                "completed": self.completed,
                "dropped": self.dropped,
                "completion_rate_est": self._rate,
            }
            if self.tenant_weights is not None:
                names = (set(self.tenant_weights) | set(self._tenant_used)
                         | set(self._tenant_reserved))
                out["tenants"] = {
                    t: {"weight": self.tenant_weights.get(
                            t, self.tenant_default_weight),
                        "share_units": self._tenant_cap_locked(t),
                        "used_units": self._tenant_used.get(t, 0.0),
                        "reserved_units": self._tenant_reserved.get(t, 0.0)}
                    for t in sorted(names)}
            if self.cost_aware:
                out["cost"] = {
                    "cost_cap_s": self.cost_cap_s,
                    "inflight_cost_s": self._inflight_cost,
                    "pending_cost_s": self._pending_cost,
                    "reserved_cost_s": self._reserved_cost_total,
                    "unit_charge_s": self.unit_charge(1),
                }
        out["load"] = self.load_score()
        return out
