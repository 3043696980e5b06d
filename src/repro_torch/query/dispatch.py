"""Cost-model multi-backend dispatch (ROADMAP: "multi-backend dispatch").

The paper's planner hard-codes placement — "native unless the op says
remote".  This module makes placement a *decision*: a per-op cost model
estimates how long each op would take on each available backend, and a
:class:`BackendRouter` the planner consults at ``expand`` time assigns
every op of an entity's chain to the backend where it is estimated to
finish soonest, splitting one chain into native → remote → batcher
segments when that wins (handoff rides the existing Queue_2 / Thread_3
reply path).

Backends (all behind the common :class:`Backend` protocol):

- **native**   — the event loop's native worker pool (Queue_1);
- **remote**   — the κ remote-server pool (rides the existing per-entity
  dispatch and cross-session coalescing paths unchanged);
- **batcher**  — grouped UDF execution
  (:class:`repro_torch.serving.batcher.UDFBatcherBackend`): ops with a
  registered batched variant (``register_batched_udf`` — e.g. model
  UDFs, whose GroupBatcher amortizes prefill+decode over a group);
- **device**   — accelerator execution
  (:class:`repro_torch.query.device_backend.DeviceBackend`, built only when
  the engine enables ``device_backend``): native-table ops and ops with
  a registered device UDF (``register_device_udf``) run as jit-compiled
  JAX on the device, micro-batched; the first backend whose cost adds
  host↔device transfer and one-time jit-compile amortization terms.

Cost model (ARCHITECTURE.md "Dispatch" has the diagram)::

    native(op)  = op_est · (1 + util)          + backlog_native  / W
    remote(op)  = transport.cost(nbytes) + op_est
                  + pending_entities · lat_est / κ + backlog_remote / κ
    batcher(op) = wait/2 + op_est / G          + backlog_batcher
    device(op)  = wait/2 + transfer(nbytes, B) + op_est_dev
                  + compile_s / (1 + runs)     + backlog_device
    device_resident(op) = op_est_dev           (segment fusion on)

The last line is the *segment* pricing: a backend that declares
``resident_capable`` (the device backend with ``fuse_segments`` on)
charges its full ``estimate`` — batching wait, transfer, compile
amortization — only on the op that ENTERS a run of consecutive
placements, and ``estimate_resident`` (pure marginal compute) for every
subsequent op that stays.  The DP therefore prices device *segments*,
not ops: transfer and dispatch amortize over the whole fused segment,
compile over its run count, which widens the regime where the device
wins exactly as fusing the execution does.

where ``op_est`` is an EWMA of observed per-op execution seconds
(:class:`OpCostTracker`, calibrated online by the native workers and the
batcher), ``util`` is the native pool's recent BusyMeter utilization,
``lat_est`` the remote pool's amortized per-entity latency estimate, κ
the live server count, W the native worker count, G the batcher group
size, and each ``backlog`` a leaky-bucket ledger of work the router
itself recently placed on that backend (so one expand's fan-out spreads
across backends instead of herding onto the first-cheapest one).

Routing minimizes total estimated cost over the chain with a dynamic
program that charges ``handoff_s`` for every backend switch (a switch
costs a Queue_2 hop and possibly a batching window), entered at the
native backend — entities always start life on Queue_1.  Chains resumed
from a result-cache prefix hit are routed from their resume point only
(``start=op_index``).

``cost_overrides={op_name: {backend: seconds}}`` pins estimates for
benchmarks and tests (forced cost regimes); an override never makes a
backend eligible that ``can_run`` rejects.

The default engine (``dispatch="static"``) builds none of this: entities
carry ``route=None`` and the event loop reproduces the paper's rule
byte-identically.
"""
from __future__ import annotations

import abc
import queue
import threading
import time
from typing import Optional

from repro_torch.core.result_cache import op_signature

NATIVE = "native"
REMOTE = "remote"
BATCHER = "batcher"
DEVICE = "device"

_INF = float("inf")


def validate_overrides(overrides: dict | None,
                       known=(NATIVE, REMOTE, BATCHER, DEVICE)) -> dict:
    """Shape-check a ``cost_overrides`` mapping ({op_name: {backend:
    seconds}}).  The engine calls this BEFORE spawning any pool/loop/
    batcher threads, so a malformed knob raises without leaking them."""
    overrides = overrides or {}
    for op_name, per_backend in overrides.items():
        if not isinstance(per_backend, dict):
            raise ValueError(
                f"cost_overrides[{op_name!r}] must be a dict "
                f"{{backend: seconds}}, got {per_backend!r}")
        unknown = set(per_backend) - set(known)
        if unknown:
            raise ValueError(
                f"cost_overrides[{op_name!r}] names unknown "
                f"backend(s) {sorted(unknown)}; known: {sorted(known)}")
    return overrides


def collect_microbatch(inbox, first, *, size: int, max_wait_s: float,
                       clock=time.monotonic, stop=None):
    """Shared micro-batch gather loop for offload backends (batcher and
    device workers): collect up to ``size`` items from ``inbox``
    starting with ``first``, holding the group open at most
    ``max_wait_s`` from the first member's arrival.  Returns
    ``(group, saw_stop)`` — ``saw_stop`` when the ``stop`` sentinel was
    drained mid-collection, so the worker finishes this group and then
    exits."""
    group = [first]
    deadline = clock() + max_wait_s
    while len(group) < size:
        remaining = deadline - clock()
        if remaining <= 0:
            break
        try:
            nxt = inbox.get(timeout=remaining)
        except queue.Empty:
            break
        if nxt is stop:
            return group, True
        group.append(nxt)
    return group, False


OFFLOAD_STOP = object()   # shared poison pill for offload-backend inboxes


class OffloadInboxMixin:
    """Inbox lifecycle shared by the offload backends
    (``UDFBatcherBackend``, ``DeviceBackend``): a locked submit gate so
    no entity can land in the inbox after shutdown's close (a bare
    closed-check-then-put races the final drain sweep — a submitter
    descheduled between check and put would strand its entity in a dead
    inbox), the poison-pill-then-drain shutdown, and the post-join
    sweep.  Subclasses call :meth:`_init_inbox` in ``__init__``,
    provide ``name`` and ``_run_groups(entities)``, and their worker
    loops treat ``OFFLOAD_STOP`` as the pill, calling
    :meth:`_drain_after_stop` when they see it."""

    def _init_inbox(self) -> None:
        self.inbox: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self._submit_gate = threading.Lock()
        self.fault_injector = None   # set by the engine (chaos testing)

    def _maybe_fault(self) -> None:
        """Deterministic fault-injection hook for offload workers
        (:class:`repro_torch.distributed.fault.FaultInjector`, site
        ``backend:<name>``): a latency fault sleeps here; every other
        kind raises :class:`~repro_torch.distributed.fault.TransientError`,
        which the worker's existing per-entity error path reports — so
        an injected fault degrades exactly like a real one."""
        fi = self.fault_injector
        if fi is None:
            return
        fault = fi.decide(f"backend:{self.name}")
        if fault is None:
            return
        if fault.kind == "latency":
            time.sleep(fault.latency_s)
            return
        from repro_torch.distributed.fault import TransientError
        raise TransientError(
            f"injected {fault.kind} fault in {self.name} backend")

    def submit(self, entity) -> None:
        """Thread_3 hands an entity whose current op is routed here.
        Raises ``RuntimeError`` once shutdown has begun — a late
        enqueue must fail loudly (the event loop converts it into a
        per-entity failure), never sit silently in a dead inbox."""
        with self._submit_gate:
            if self._closed.is_set():
                raise RuntimeError(f"{self.name} backend is shut down")
            self.inbox.put(entity)

    def pending(self) -> int:
        return self.inbox.qsize()

    def shutdown(self, timeout: float = 5.0) -> None:
        """Poison-pill-then-drain shutdown: mark the backend closed
        under the submit gate (so the close is atomic with any
        in-progress put and late ``submit`` raises), queue the pill,
        and join.  The worker finishes its current micro-batch, then
        drains and *executes* everything accepted before the close —
        work already admitted is never silently dropped, so
        ``engine.shutdown()`` stays deterministic with sessions still
        in flight.  Idempotent."""
        with self._submit_gate:
            first_close = not self._closed.is_set()
            self._closed.set()
        if self._thread is None:
            return
        if first_close:
            self.inbox.put(OFFLOAD_STOP)
        self._thread.join(timeout)
        if not self._thread.is_alive():
            # the worker is joined, so this final sweep on the caller's
            # thread is race-free (and a repeat shutdown re-sweeps
            # harmlessly: the inbox is empty)
            self._drain_after_stop()

    def _drain_after_stop(self) -> None:
        """Execute entities still queued around the poison pill — work
        accepted before the close is never silently dropped (cancelled
        sessions' members are discarded in O(1) by the batch runner)."""
        leftover = []
        while True:
            try:
                nxt = self.inbox.get_nowait()
            except queue.Empty:
                break
            if nxt is not OFFLOAD_STOP:
                leftover.append(nxt)
        if leftover:
            self._run_groups(leftover)


class OpCostTracker:
    """EWMA of observed per-op execution seconds, keyed by canonical op
    signature.  ``kind="native"`` samples come from the native workers
    (pure op compute — also the best available estimate for the op's
    compute on a remote server); ``kind="batched"`` samples are the
    *amortized per-entity* seconds of a batcher group run."""

    def __init__(self, default_s: float = 1e-3, alpha: float = 0.25):
        self.default_s = default_s
        self.alpha = alpha
        self._lock = threading.Lock()
        self._est: dict[str, dict[tuple, float]] = {          # guarded-by: _lock
            "native": {}, "batched": {}, "device": {}}
        self._out_bytes: dict[tuple, float] = {}   # guarded-by: _lock

    def observe(self, op, seconds: float, kind: str = "native",
                out_bytes: int | None = None):
        key = op_signature(op)
        with self._lock:
            table = self._est[kind]
            prev = table.get(key)
            table[key] = (seconds if prev is None
                          else (1 - self.alpha) * prev + self.alpha * seconds)
            if out_bytes is not None:
                prev_b = self._out_bytes.get(key)
                self._out_bytes[key] = (
                    float(out_bytes) if prev_b is None
                    else (1 - self.alpha) * prev_b + self.alpha * out_bytes)

    def estimate(self, op, kind: str = "native",
                 default: float | None = None) -> float:
        with self._lock:
            est = self._est[kind].get(op_signature(op))
        return est if est is not None else (
            default if default is not None else self.default_s)

    def out_bytes(self, op, default: float = 0.0) -> float:
        """EWMA of the op's observed OUTPUT payload size — lets the
        router thread realistic payloads through a chain (a post-resize
        remote op is costed on the small intermediate, not the original
        blob)."""
        with self._lock:
            b = self._out_bytes.get(op_signature(op))
        return b if b is not None else default

    def known(self, op, kind: str = "native") -> bool:
        with self._lock:
            return op_signature(op) in self._est[kind]

    def mean_cost_estimate(self, kind: str = "native") -> float | None:
        """Mean of the calibrated per-op estimates — the admission
        controller's per-entity service-time fallback when no
        completion-rate sample exists yet.  None when nothing has been
        observed."""
        with self._lock:
            table = self._est[kind]
            if not table:
                return None
            return sum(table.values()) / len(table)

    def snapshot(self) -> dict:
        with self._lock:
            return {kind: dict(table) for kind, table in self._est.items()}


class LoadLedger:
    """Leaky bucket of *projected* work-seconds the router has placed on
    one backend.  Placements add their estimated seconds; the bucket
    drains at the backend's parallel capacity (``drain_rate()``
    work-seconds per wall second), so the queue-wait term a later
    placement sees is ``backlog_s() / capacity`` — the feedback that
    spreads a single expand's fan-out across backends."""

    def __init__(self, drain_rate, clock=time.monotonic):
        self._drain_rate = drain_rate
        self._clock = clock
        self._lock = threading.Lock()
        self._backlog = 0.0       # guarded-by: _lock
        self._last = clock()      # guarded-by: _lock

    def _decay_locked(self):
        now = self._clock()
        self._backlog = max(0.0, self._backlog
                            - (now - self._last) * max(1e-9, self._drain_rate()))
        self._last = now

    def add(self, seconds: float):
        with self._lock:
            self._decay_locked()
            self._backlog += max(0.0, seconds)

    def backlog_s(self) -> float:
        with self._lock:
            self._decay_locked()
            return self._backlog


class Backend(abc.ABC):
    """What the router needs from an execution backend.  Execution
    mechanics stay where they live (event loop / remote pool / batcher
    worker / device worker); this protocol only exposes the
    placement-relevant surface.  Implementations:
    :class:`NativeBackend`, :class:`RemoteBackend`,
    :class:`repro_torch.serving.batcher.UDFBatcherBackend`, and
    :class:`repro_torch.query.device_backend.DeviceBackend` (the latter two
    satisfy the protocol structurally rather than by subclassing —
    the router only requires the four methods and ``name``).

    The one hard semantic contract: backends are *interchangeable* —
    every backend that ``can_run`` an op must produce a result
    equivalent to every other backend's (the router is free to place
    the same op differently on every call)."""

    name: str = "?"

    #: Whether consecutive placements on this backend keep the payload
    #: resident (no per-op transfer/entry cost after the first).  The
    #: router then prices in-segment ops with :meth:`estimate_resident`.
    resident_capable: bool = False

    @abc.abstractmethod
    def can_run(self, op) -> bool:
        """Whether this backend can execute ``op`` at all.  A cost
        override never bypasses this — pinning an op cheap on a backend
        that cannot run it still costs ``inf`` there."""

    @abc.abstractmethod
    def estimate(self, op, payload_bytes: int) -> float:
        """Estimated seconds for ``op`` on this backend right now,
        including queueing/transport/amortization terms.
        ``payload_bytes`` is the router's estimate of the op's INPUT
        payload (threaded through the chain from observed output-size
        EWMAs), for backends with a transfer term."""

    def estimate_resident(self, op, payload_bytes: int) -> float:
        """Estimated seconds for ``op`` when the PREVIOUS op already ran
        here and the backend is ``resident_capable`` — the marginal cost
        of extending the resident segment by one op (no entry costs).
        Default: same as :meth:`estimate` (no residency advantage)."""
        return self.estimate(op, payload_bytes)

    @abc.abstractmethod
    def queue_depth(self) -> int:
        """Entities currently waiting on this backend (surfaced in
        ``dispatch_stats()["queue_depths"]``)."""

    def note_placed(self, op):
        """Router feedback: ``op`` was just routed here; add its
        projected work to the backend's leaky-bucket ledger so one
        expand's fan-out spreads across backends instead of herding
        onto the first-cheapest.  Default: no ledger."""


class NativeBackend(Backend):
    """The event loop's native worker pool seen as a routing target."""

    name = NATIVE

    def __init__(self, loop, tracker: OpCostTracker, *,
                 util_window_s: float = 0.25):
        self.loop = loop
        self.tracker = tracker
        self.util_window_s = util_window_s
        self.ledger = LoadLedger(lambda: max(1, loop.num_native_workers))
        self._util_cache = (0.0, -_INF)   # (value, measured_at)

    def can_run(self, op) -> bool:
        return True          # run_op resolves every op name locally

    def utilization(self) -> float:
        """Busy fraction of the pool over the recent window, in [0, 1].
        Memoized for a fraction of the window: route() calls this per op
        per entity, and the underlying BusyMeter scan takes every
        per-worker meter lock — rescanning inside one expand's fan-out
        would contend the native pool for identical answers."""
        val, at = self._util_cache
        now = time.monotonic()
        if now - at < self.util_window_s / 4.0:
            return val
        val = self.loop.t2_meter.utilization(
            workers=self.loop.num_native_workers,
            window_s=self.util_window_s)
        self._util_cache = (val, now)
        return val

    def estimate(self, op, payload_bytes: int) -> float:
        workers = max(1, self.loop.num_native_workers)
        base = self.tracker.estimate(op)
        return base * (1.0 + self.utilization()) \
            + self.ledger.backlog_s() / workers

    def queue_depth(self) -> int:
        return self.loop.queue1.qsize()

    def note_placed(self, op):
        self.ledger.add(self.tracker.estimate(op))


class RemoteBackend(Backend):
    """The κ remote-server pool seen as a routing target."""

    name = REMOTE

    def __init__(self, pool, tracker: OpCostTracker):
        self.pool = pool
        self.tracker = tracker
        self.ledger = LoadLedger(lambda: max(1, pool.live_count()))

    def can_run(self, op) -> bool:
        return self.pool.live_count() > 0

    def estimate(self, op, payload_bytes: int) -> float:
        live = self.pool.live_count()
        if not live:
            return _INF
        t = self.pool.transport
        queue_wait = (self.pool.pending_entities()
                      * self.pool.latency_estimate()) / live
        return t.cost(payload_bytes) + self.tracker.estimate(op) \
            + queue_wait + self.ledger.backlog_s() / live

    def queue_depth(self) -> int:
        return self.pool.pending_entities()

    def note_placed(self, op):
        self.ledger.add(self.tracker.estimate(op)
                        + self.pool.transport.service_time_s)


class StaticRouter:
    """Force every op onto one backend — ``dispatch="native"``, the
    all-native benchmark baseline (any backend name works)."""

    def __init__(self, backend: str = NATIVE):
        self.backend = backend
        self._lock = threading.Lock()
        self.chains_routed = 0    # guarded-by: _lock
        self.ops_routed = 0       # guarded-by: _lock

    def route(self, ops, start: int = 0, payload_bytes: int = 0) -> list:
        with self._lock:
            self.chains_routed += 1
            self.ops_routed += len(ops) - start
        return [self.backend] * len(ops)

    def stats(self) -> dict:
        with self._lock:
            return {"placements": {self.backend: self.ops_routed},
                    "handoffs": 0, "segments": self.chains_routed,
                    "chains_routed": self.chains_routed}


class BackendRouter:
    """Assigns each op of a chain to a backend by minimizing total
    estimated cost + ``handoff_s`` per backend switch (dynamic program
    over (op, backend); entry state is the native backend, because
    entities are always launched onto Queue_1)."""

    def __init__(self, backends: list[Backend], *,
                 overrides: dict | None = None,
                 handoff_s: float = 5e-4,
                 tracker: OpCostTracker | None = None,
                 health=None):
        self.backends = {b.name: b for b in backends}
        self.handoff_s = handoff_s
        self.overrides = validate_overrides(overrides,
                                            known=tuple(self.backends))
        self.tracker = tracker   # for payload propagation through chains
        # optional HealthRegistry (repro_torch.query.health): an OPEN breaker
        # prices its backend at inf; otherwise costs scale by the
        # error-EWMA penalty (exactly 1.0 while healthy, so enabling
        # health tracking never perturbs a fault-free engine's routing).
        # The penalty applies to overridden costs too — a pinned regime
        # still drains away from a sick backend.
        self.health = health
        self._lock = threading.Lock()
        self.placements = {b.name: 0 for b in backends}   # guarded-by: _lock
        self.handoffs = 0         # guarded-by: _lock
        self.segments = 0         # guarded-by: _lock
        self.chains_routed = 0    # guarded-by: _lock

    # ----------------------------------------------------------- costing
    def cost(self, op, backend: str, payload_bytes: int = 0) -> float:
        """Estimated seconds of ``op`` on ``backend`` (inf when the
        backend cannot run it — overrides never bypass ``can_run``)."""
        b = self.backends[backend]
        if not b.can_run(op):
            return _INF
        if self.health is not None and not self.health.routable(backend):
            return _INF
        ov = self.overrides.get(op.name)
        if ov is not None and backend in ov:
            return self._health_scaled(backend, float(ov[backend]))
        return self._health_scaled(backend, b.estimate(op, payload_bytes))

    def _health_scaled(self, backend: str, base: float) -> float:
        if self.health is None:
            return base
        return base * self.health.penalty(backend)

    def cost_resident(self, op, backend: str, payload_bytes: int = 0) -> float:
        """Estimated seconds of ``op`` on ``backend`` when the previous
        op was ALSO placed there and the backend keeps payloads resident
        across consecutive ops (``resident_capable`` — the fused device
        segment).  Overrides pin the per-op cost in both regimes, so a
        forced cost regime is unaffected by fusion."""
        b = self.backends[backend]
        if not b.can_run(op):
            return _INF
        if self.health is not None and not self.health.routable(backend):
            return _INF
        ov = self.overrides.get(op.name)
        if ov is not None and backend in ov:
            return self._health_scaled(backend, float(ov[backend]))
        if not getattr(b, "resident_capable", False):
            return self._health_scaled(backend, b.estimate(op, payload_bytes))
        return self._health_scaled(backend,
                                   b.estimate_resident(op, payload_bytes))

    # ----------------------------------------------------------- routing
    def route(self, ops, start: int = 0,
              payload_bytes: int = 0) -> Optional[list]:
        """Backend name per op for ``ops[start:]`` (``route[:start]`` is
        filled with ``native`` — those ops already ran, e.g. a cache
        prefix hit resumes at ``start``).  Returns None for an empty
        tail (nothing to place)."""
        n = len(ops)
        if start >= n:
            return None
        names = list(self.backends)
        # dp over ops[start:]: cost to finish op i on backend b.  The
        # payload estimate is threaded THROUGH the chain: each op's cost
        # uses the previous op's observed output-size EWMA (falling back
        # to the entry payload), so a post-downscale remote op is costed
        # on the small intermediate, not the original blob.
        pb = float(payload_bytes)
        best: dict[str, float] = {}
        parent: list[dict[str, str]] = []
        for i, op in enumerate(ops[start:]):
            # two step prices per backend: "cold" (entering the backend
            # for this op — full estimate with wait/transfer/compile
            # terms) and "resident" (staying on a resident-capable
            # backend — marginal compute only).  For every backend that
            # is not resident_capable the two coincide, and the DP
            # degenerates to the original per-op recurrence.
            step = {b: self.cost(op, b, pb) for b in names}
            res_step = {b: self.cost_resident(op, b, pb) for b in names}
            if self.tracker is not None:
                pb = self.tracker.out_bytes(op, default=pb)
            if i == 0:
                # chains enter at native (Queue_1), so the first op is
                # always a cold entry — residency starts at op 2
                cur = {b: step[b] + (self.handoff_s if b != NATIVE else 0.0)
                       for b in names}
                parent.append({b: "" for b in names})
            else:
                cur, par = {}, {}
                for b in names:
                    stay = best[b] + res_step[b]
                    enter_from, enter_base = b, _INF
                    for p in names:
                        if p != b and best[p] < enter_base:
                            enter_base, enter_from = best[p], p
                    enter = enter_base + self.handoff_s + step[b]
                    if stay <= enter:
                        cur[b], par[b] = stay, b
                    else:
                        cur[b], par[b] = enter, enter_from
                parent.append(par)
            best = cur
        end = min(names, key=lambda b: best[b])
        chosen = [end]
        for par in reversed(parent[1:]):
            chosen.append(par[chosen[-1]])
        chosen.reverse()
        route = [NATIVE] * start + chosen
        # feedback + stats
        handoffs = sum(a != b for a, b in zip(chosen, chosen[1:]))
        for b_name, op in zip(chosen, ops[start:]):
            self.backends[b_name].note_placed(op)
        if self.health is not None:
            # a half-open breaker admits only a probe trickle: each
            # routed chain that touches the backend consumes one slot
            for b_name in set(chosen):
                self.health.note_probe(b_name)
        with self._lock:
            self.chains_routed += 1
            self.handoffs += handoffs
            self.segments += handoffs + 1
            for b_name in chosen:
                self.placements[b_name] += 1
        return route

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            out = {
                "placements": dict(self.placements),
                "handoffs": self.handoffs,
                "segments": self.segments,
                "chains_routed": self.chains_routed,
            }
        out["queue_depths"] = {name: b.queue_depth()
                               for name, b in self.backends.items()}
        return out
