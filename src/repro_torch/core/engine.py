"""VDMS-Async engine: the main thread (Thread_1, paper section 5.1.1).

The client API is *futures-based*: ``submit(query)`` parses the query,
compiles it to a per-query plan (repro_torch.query.planner), launches the first
phase onto the event loop, and returns a :class:`QueryFuture` without
waiting for any operation to execute — submit cost is O(fan-out) pointer
work only (metadata filter + blob-pointer lookups; ~1 ms per 100
entities), never op or network time.  ``execute(query, timeout)``
is kept as a thin blocking wrapper so every existing caller works
unchanged and produces byte-identical responses.

Device and host: the engine runs its pipelines on one torch device
(``device``, the CUDA card by default).  Blobs stay on the host in the
blob store, and :mod:`repro_torch.core.boundary` is the one host
boundary: an entity's blob becomes a device tensor when its pipeline is
launched (:meth:`VDMSAsyncEngine._launch_now`), and results come back
to the host where they enter the response (:meth:`_entity_done`, and
the instant entities of :meth:`_expand_plan`) and at the write-back of an
``Add`` with operations (:meth:`_store_result`).  Responses therefore
hold numpy arrays, exactly as the JAX engine's can be read with
``np.asarray``.

Supports thousands of concurrent in-flight queries (experiment C3 and
beyond): each query is a session with its own fair-queue lane on Queue_1;
the shared event loop — with a configurable native-worker pool —
interleaves entities from all active sessions.  Cancellation/timeout
drops a session's queued and in-flight work instead of orphaning it.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Callable, Optional

import torch

from repro_torch.core.boundary import to_device, to_host
from repro_torch.core.entity import ERD, Entity
from repro_torch.core.event_loop import EventLoop
from repro_torch.core.remote import RemoteServerPool, TransportModel
from repro_torch.core.result_cache import ResultCache
from repro_torch.core.session import QueryFuture, QuerySession
from repro_torch.query.admission import AdmissionController, OverloadError
from repro_torch.query.dispatch import (BackendRouter, NativeBackend,
                                        OpCostTracker, RemoteBackend,
                                        StaticRouter, validate_overrides)
from repro_torch.query.health import HealthRegistry
from repro_torch.query.language import parse_query
from repro_torch.query.metadata import MetadataStore
from repro_torch.query.planner import CommandPlan, QueryPlanner
from repro_torch.storage.store import BlobStore


def _default_native_workers() -> int:
    return max(1, min(os.cpu_count() or 1, 8))


def _no_cuda(what: str) -> RuntimeError:
    return RuntimeError(
        f"{what} asks for the CUDA card, and torch sees no CUDA device "
        f"on this host; pass device='cpu' (and device_backend='cpu') to "
        f"run on the CPU")


def resolve_device(device) -> torch.device:
    """The engine's pipeline device: ``"cuda"`` (the current card),
    ``"cuda:<i>"`` or ``"cpu"``.  Raises when CUDA is asked for and
    absent — the engine never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise _no_cuda(f"device={device!r}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise ValueError(f"device={device!r}: only "
                             f"{torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda', 'cuda:<i>' or 'cpu', "
                         f"got {device!r}")
    return dev


def resolve_device_pool(device_backend) -> list[torch.device]:
    """The device backend's devices: ``True``/``"auto"``/``"cuda"``/
    ``"gpu"`` is every visible CUDA card, ``"cpu"`` one CPU-as-device
    executor.  Raises when CUDA is asked for and absent."""
    if device_backend is True or device_backend in ("auto", "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise _no_cuda(f"device_backend={device_backend!r}")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_backend == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"device_backend must be True, 'auto', 'cuda', 'gpu' "
                     f"or 'cpu', got {device_backend!r}")


class VDMSAsyncEngine:
    """The VDMS-Async query engine: paper-faithful by default, with
    every beyond-paper subsystem behind an explicitly-OFF knob.

    Constructor knobs (grouped; defaults reproduce the paper engine
    except for the scheduling pair, which benchmarks pin explicitly):

    **Device** —
      ``device``: the torch device the pipelines run on: ``"cuda"``
      (the default: the current CUDA card), ``"cuda:<i>"``, or
      ``"cpu"``.  A CUDA request on a host without one raises before
      any thread starts.

    **Remote pool** —
      ``num_remote_servers``: κ simulated remote servers (paper's UDF /
      remote executors), each a worker thread with a calibrated
      transport model.  ``transport``: a
      :class:`~repro_torch.core.remote.TransportModel` (network latency,
      bandwidth, per-entity service time).  ``dispatch_policy``:
      ``"round_robin"`` | ``"least_loaded"`` server picker (NOT the
      multi-backend ``dispatch`` knob below).  ``batch_remote``:
      coalesce up to N same-op entities per remote request.

    **Scheduling** (not paper-faithful by default; the exact paper
    baseline is ``num_native_workers=1, fair_scheduling=False``) —
      ``num_native_workers``: native executor pool size (the paper's
      single Thread_2 generalized; default cpu-bounded).
      ``fair_scheduling``: per-query Queue_1 lanes with round-robin
      service instead of one global FIFO.
      ``fuse_native``: compose maximal native-op runs into one call.

    **Result cache** (off by default) —
      ``cache_capacity`` / ``cache_capacity_bytes``: bounded LRU keyed
      on (eid, pipeline signature); 0 disables.

    **Cross-session coalescing** (off by default) —
      ``coalesce_window_ms`` / ``coalesce_max_batch``: Thread_3 groups
      pending remote work by op signature ACROSS sessions into one
      batched request per window.

    **Multi-backend dispatch** (static by default) —
      ``dispatch``: ``"static"`` (paper rule, byte-identical) |
      ``"cost"`` (cost-model router) | ``"native"`` (all-native
      baseline).  ``cost_overrides``: ``{op_name: {backend: seconds}}``
      pinned estimates for forced regimes.  ``batcher_group_size`` /
      ``batcher_max_wait_ms``: grouped-UDF backend micro-batching.
      ``device_backend``: build the device-executor backend
      (requires ``dispatch="cost"``): ``True``/``"auto"``/``"cuda"``/
      ``"gpu"`` targets every visible CUDA card, ``"cpu"`` a
      CPU-as-device executor.  ``device_batch_size`` /
      ``device_max_wait_ms``: device micro-batching window.
      ``device_fuse_segments``: fuse each routed device *segment*
      (maximal run of consecutive device-placed ops) into one
      batched program — one stack per segment and resident
      intermediates (default on when the device backend is;
      ``False`` reproduces the per-op device path bit-for-bit).
      ``num_device_workers``: device worker count (default: one per
      visible device of the selected platform; > 1 wraps them in a
      :class:`~repro_torch.query.device_backend.MultiDeviceBackend` that
      spreads segment groups by least estimated backlog).

    **Admission control** (off by default) —
      ``admission``: ``"none"`` (accept every ``submit()``
      unconditionally, byte-identical to the unbounded engine) |
      ``"queue"`` (park overflow entities in a priority-ordered pending
      lane drained as capacity frees) | ``"shed"`` (reject queries that
      do not fit with a typed
      :class:`~repro_torch.query.admission.OverloadError` carrying a
      retry-after estimate).  ``max_inflight_entities``: the hard cap
      on concurrently in-flight entities (required > 0 once admission
      is enabled).  ``admission_queue_cap``: bound on pending-lane
      entities; overflowing it sheds even under ``"queue"``.
      ``submit(..., priority=)`` orders the pending lane.
      **Admission v2** (both require admission enabled; both off by
      default): ``admission_tenants``: ``{tenant: weight}`` weighted
      fair shares of the admission budget — ``submit(..., tenant=)``
      names the lane, unlisted tenants weigh
      ``admission_tenant_default_weight``, and the empty tenant
      (plain in-process submits) is exempt.
      ``admission_cost_aware`` + ``admission_cost_cap_s``: charge each
      entity its estimated work-seconds (ops x the cost tracker's
      calibrated mean) against a work-seconds budget instead of
      counting raw entities.

    **Fault tolerance** (off by default; every default reproduces
    today's behavior bit-for-bit) —
      ``max_retries``: attempts per remote request (first included).
      ``retry_backoff_base_s`` / ``retry_backoff_max_s``: bounded
      exponential backoff with full jitter between retries (base 0.0 =
      instant resubmit, the old behavior); a retry always targets a
      *different* live server than the one that just failed.
      ``heartbeat_timeout_s``: remote servers beat a
      :class:`~repro_torch.distributed.fault.HeartbeatMonitor`; a silent
      server (died without an error reply) is declared dead and its
      in-flight work requeued to live peers.  ``fallback``: ``"none"``
      | ``"native"`` — on a transient final-attempt failure, re-route
      the failing op to the native backend instead of failing the
      entity (each op falls back at most once).  ``breaker_enabled``
      (+ ``breaker_failure_threshold`` / ``breaker_open_s`` /
      ``breaker_probes``, requires ``dispatch="cost"``): per-backend
      circuit breakers whose error-rate EWMA feeds the router as a
      health penalty; an OPEN backend is unroutable until its
      half-open probes succeed.  ``fault_injector``: a seeded
      :class:`~repro_torch.distributed.fault.FaultInjector` deterministically
      injecting error/crash/latency/die/hang faults into remote
      servers and offload backends (tests and resilience benchmarks;
      ``None`` disables injection entirely).
      ``submit(..., timeout_s=)`` bounds the retry deadline budget.

    Public surface: :meth:`submit` / :meth:`execute` for queries,
    :meth:`add_entity` for ingest, :meth:`scale_remote` for elasticity,
    and the introspection quartet :meth:`utilization` /
    :meth:`cache_stats` / :meth:`dispatch_stats` /
    :meth:`admission_stats`, plus the deterministic coalescing controls
    :meth:`flush_coalesced` / :meth:`pending_coalesced`.  Always call
    :meth:`shutdown` (all loop, pool, and backend threads are joined;
    afterwards ``submit`` raises)."""

    def __init__(self, *, device: str = "cuda",
                 num_remote_servers: int = 1,
                 transport: TransportModel | None = None,
                 fuse_native: bool = False,
                 batch_remote: int = 1,
                 dispatch_policy: str = "round_robin",
                 num_native_workers: int | None = None,
                 # analysis: ok(knob-inert) — deliberate: FIFO starvation is a known seed defect; fairness-off is the opt-out
                 fair_scheduling: bool = True,
                 cache_capacity: int = 0,
                 cache_capacity_bytes: int = 256 << 20,
                 coalesce_window_ms: float = 0.0,
                 coalesce_max_batch: int = 64,
                 dispatch: str = "static",
                 cost_overrides: dict | None = None,
                 batcher_group_size: int = 8,
                 batcher_max_wait_ms: float = 2.0,
                 device_backend: bool | str = False,
                 device_batch_size: int = 8,
                 device_max_wait_ms: float = 2.0,
                 device_fuse_segments: bool | None = None,
                 num_device_workers: int | None = None,
                 admission: str = "none",
                 max_inflight_entities: int = 0,
                 admission_queue_cap: int = 1024,
                 admission_tenants: dict | None = None,
                 admission_tenant_default_weight: float = 1.0,
                 admission_cost_aware: bool = False,
                 admission_cost_cap_s: float = 0.0,
                 max_retries: int = 3,
                 retry_backoff_base_s: float = 0.0,
                 retry_backoff_max_s: float = 1.0,
                 heartbeat_timeout_s: float = 0.0,
                 fallback: str = "none",
                 breaker_enabled: bool = False,
                 breaker_failure_threshold: float | None = None,
                 breaker_open_s: float | None = None,
                 breaker_probes: int | None = None,
                 fault_injector=None):
        if admission not in ("none", "queue", "shed"):
            raise ValueError(
                f"admission must be 'none' (accept everything, the "
                f"paper-faithful default), 'queue' (park overflow in a "
                f"priority lane) or 'shed' (reject with OverloadError), "
                f"got {admission!r}")
        if admission == "none" and max_inflight_entities:
            # a cap no policy enforces would be silently inert — same
            # failure mode as a stray cost override
            raise ValueError(
                "max_inflight_entities requires admission='queue' or "
                "'shed' (admission='none' never consults the cap)")
        if admission == "none":
            # admission-v2 knobs parameterize the controller only —
            # with no controller they would be silently inert
            for val, name, default in (
                    (admission_tenants, "admission_tenants", None),
                    (admission_tenant_default_weight,
                     "admission_tenant_default_weight", 1.0),
                    (admission_cost_aware, "admission_cost_aware", False),
                    (admission_cost_cap_s, "admission_cost_cap_s", 0.0)):
                if val != default:
                    raise ValueError(
                        f"{name} requires admission='queue' or 'shed' "
                        f"(admission='none' builds no controller to "
                        f"consult it)")
        # built pre-thread: a malformed admission knob (cap <= 0, bad
        # queue cap, malformed tenant table, cost knobs half-set) must
        # raise before any pool/loop thread exists
        self.admission_ctl = (
            AdmissionController(
                max_inflight=max_inflight_entities,
                policy=admission,
                queue_cap=admission_queue_cap,
                tenant_weights=admission_tenants,
                tenant_default_weight=admission_tenant_default_weight,
                cost_aware=admission_cost_aware,
                cost_cap_s=admission_cost_cap_s)
            if admission != "none" else None)
        self.admission = admission
        if dispatch not in ("static", "cost", "native"):
            raise ValueError(
                f"dispatch must be 'static' (paper-faithful placement), "
                f"'cost' (cost-model router) or 'native' (all-native "
                f"baseline), got {dispatch!r}")
        if device_backend and dispatch != "cost":
            # a device backend no router can place work on would be
            # silently inert — same failure mode as a stray override
            raise ValueError(
                "device_backend requires dispatch='cost' (only the "
                "cost-model router can place segments on the device)")
        if not device_backend:
            # knobs that only parameterize the device backend must not
            # pass silently on an engine that never builds one (the
            # stray-override failure mode)
            if device_fuse_segments is not None:
                raise ValueError(
                    "device_fuse_segments requires device_backend "
                    "(there is no device segment to fuse without it)")
            if num_device_workers is not None:
                raise ValueError(
                    "num_device_workers requires device_backend "
                    "(there are no device workers without it)")
        elif num_device_workers is not None and num_device_workers < 1:
            raise ValueError(
                f"num_device_workers must be >= 1, got "
                f"{num_device_workers!r}")
        # resolve the devices HERE, before any pool/loop thread exists:
        # a CUDA request on a host without one raises, and that failure
        # must not leak running threads
        self.device = resolve_device(device)
        device_pool = None
        if device_backend:
            device_pool = resolve_device_pool(device_backend)
        if dispatch == "static":
            if cost_overrides:
                # a forced regime with no router would be silently inert
                # — the caller almost certainly forgot dispatch="cost"
                raise ValueError(
                    "cost_overrides requires dispatch='cost' or 'native' "
                    "(dispatch='static' never consults a cost model)")
        else:
            # shape-check the knob BEFORE any pool/loop/batcher/device
            # thread exists: a malformed override must not leak running
            # threads (validated under "native" too, where it is merely
            # unused, so a typo'd regime never passes silently).
            # "device" is only a valid override target when the device
            # backend is actually enabled: a pinned device regime on an
            # engine with no device backend would either be silently
            # inert (dispatch="native") or fail inside BackendRouter
            # after threads exist (dispatch="cost") — both fail here
            # instead.
            known = ("native", "remote", "batcher") \
                + (("device",) if device_backend else ())
            validate_overrides(cost_overrides, known=known)
        # fault-tolerance knobs, validated BEFORE any thread exists
        # (same discipline as admission/dispatch above)
        if fallback not in ("none", "native"):
            raise ValueError(
                f"fallback must be 'none' (a final-attempt failure fails "
                f"the entity, the paper-faithful default) or 'native' "
                f"(re-route the failing op to the native backend), got "
                f"{fallback!r}")
        if max_retries < 1:
            raise ValueError(
                f"max_retries must be >= 1 (the first attempt counts), "
                f"got {max_retries!r}")
        if breaker_enabled and dispatch != "cost":
            # a breaker no router consults would be silently inert —
            # health only changes behavior through the cost-model DP
            raise ValueError(
                "breaker_enabled requires dispatch='cost' (only the "
                "cost-model router consults backend health)")
        if not breaker_enabled:
            for val, name in ((breaker_failure_threshold,
                               "breaker_failure_threshold"),
                              (breaker_open_s, "breaker_open_s"),
                              (breaker_probes, "breaker_probes")):
                if val is not None:
                    raise ValueError(
                        f"{name} requires breaker_enabled (there is no "
                        f"circuit breaker to parameterize without it)")
        self.health = None
        self.fallback = fallback
        if breaker_enabled:
            names = ["native", "remote", "batcher"]
            if device_backend:
                names.append("device")
            bk = {}
            if breaker_failure_threshold is not None:
                bk["failure_threshold"] = breaker_failure_threshold
            if breaker_open_s is not None:
                bk["open_s"] = breaker_open_s
            if breaker_probes is not None:
                bk["half_open_probes"] = breaker_probes
            self.health = HealthRegistry(names, **bk)
        # gates the fault-tolerance stats blocks in dispatch_stats(): a
        # default engine's dict stays byte-identical to the baseline
        self._ft_visible = (fault_injector is not None
                            or heartbeat_timeout_s > 0.0
                            or retry_backoff_base_s > 0.0
                            or breaker_enabled or fallback != "none")
        self.meta = MetadataStore()
        self.store = BlobStore()
        self.erd = ERD()
        self.pool = RemoteServerPool(
            num_remote_servers, transport,
            policy=dispatch_policy,
            max_retries=max_retries,
            retry_backoff_base_s=retry_backoff_base_s,
            retry_backoff_max_s=retry_backoff_max_s,
            heartbeat_timeout_s=heartbeat_timeout_s,
            fault_injector=fault_injector)
        # hot-path perf subsystems, both paper-faithful OFF by default:
        # cache_capacity > 0 enables the (eid, pipeline-signature) result
        # cache; coalesce_window_ms > 0 enables cross-session remote
        # request coalescing (one batched request per op signature per
        # window, amortized via TransportModel.cost_batch)
        self.result_cache = (ResultCache(cache_capacity,
                                         cache_capacity_bytes)
                             if cache_capacity > 0 else None)
        self._sessions: dict[str, QuerySession] = {}
        self._session_lock = threading.Lock()
        # None -> cpu-bounded pool; 1 -> the paper-faithful single Thread_2
        self.num_native_workers = (num_native_workers
                                   if num_native_workers is not None
                                   else _default_native_workers())
        # multi-backend dispatch ("static", the default, builds none of
        # this and stays byte-identical to the paper engine): a per-op
        # cost tracker calibrated by the native workers, the GroupBatcher
        # promoted to a backend, and a router the planner consults at
        # expand time (repro_torch.query.dispatch)
        self.dispatch = dispatch
        self.cost_tracker = None
        self.router = None
        self.batcher_backend = None
        self.device_backend = None
        if dispatch != "static":
            self.cost_tracker = OpCostTracker()
            if dispatch == "cost":
                # deferred: serving.batcher pulls in the model stack,
                # which a non-batcher engine never needs
                from repro_torch.serving.batcher import UDFBatcherBackend
                self.batcher_backend = UDFBatcherBackend(
                    group_size=batcher_group_size,
                    max_wait_s=batcher_max_wait_ms / 1000.0,
                    tracker=self.cost_tracker)
                if device_backend:
                    # deferred: the device executor is only built on
                    # request.  device_backend=True/"auto"/"cuda"/"gpu"
                    # targets every visible card, "cpu" a CPU-as-device
                    # executor (resolved above, pre-thread).
                    # Fusion defaults ON; one worker per visible device
                    # unless num_device_workers pins the count (a single
                    # worker stays a plain DeviceBackend — no wrapper
                    # indirection on the common path).
                    from repro_torch.query.device_backend import (
                        DeviceBackend, MultiDeviceBackend)
                    fuse = (device_fuse_segments
                            if device_fuse_segments is not None else True)
                    count = (num_device_workers
                             if num_device_workers is not None
                             else len(device_pool))
                    workers = [
                        DeviceBackend(
                            batch_size=device_batch_size,
                            max_wait_s=device_max_wait_ms / 1000.0,
                            tracker=self.cost_tracker,
                            device=device_pool[i % len(device_pool)],
                            fuse_segments=fuse)
                        for i in range(count)]
                    self.device_backend = (
                        workers[0] if count == 1
                        else MultiDeviceBackend(workers))
                if fault_injector is not None:
                    # offload backends consult the injector per group
                    # run (site "backend:<name>"); remote servers got
                    # theirs via the pool above
                    self.batcher_backend.fault_injector = fault_injector
                    if self.device_backend is not None:
                        self.device_backend.fault_injector = \
                            fault_injector
        self.loop = EventLoop(self.pool, self.erd,
                              fuse_native=fuse_native,
                              batch_remote=batch_remote,
                              num_native_workers=self.num_native_workers,
                              fair_scheduling=fair_scheduling,
                              on_entity_done=self._entity_done,
                              is_cancelled=self._is_cancelled,
                              coalesce_window_s=coalesce_window_ms / 1000.0,
                              coalesce_max_batch=coalesce_max_batch,
                              result_cache=self.result_cache,
                              batcher_backend=self.batcher_backend,
                              device_backend=self.device_backend,
                              cost_tracker=self.cost_tracker,
                              health=self.health,
                              fallback_native=fallback == "native")
        if dispatch == "native":
            self.router = StaticRouter("native")
        elif dispatch == "cost":
            self.batcher_backend.bind(self.loop.queue2, self._is_cancelled)
            backends = [NativeBackend(self.loop, self.cost_tracker),
                        RemoteBackend(self.pool, self.cost_tracker),
                        self.batcher_backend]
            if self.device_backend is not None:
                self.device_backend.bind(self.loop.queue2,
                                         self._is_cancelled)
                backends.append(self.device_backend)
            self.router = BackendRouter(
                backends,
                overrides=cost_overrides,
                tracker=self.cost_tracker,
                health=self.health)
        self.planner = QueryPlanner(self.meta, self.store,
                                    result_cache=self.result_cache,
                                    router=self.router)
        if self.admission_ctl is not None:
            self.admission_ctl.bind(
                loop=self.loop, pool=self.pool, launch=self._launch_now,
                offload_backends=(self.batcher_backend, self.device_backend),
                tracker=self.cost_tracker)
        self._qid = itertools.count()
        self._shut = False

    # ------------------------------------------------------------ ingest
    def add_entity(self, kind: str, data, properties: dict, *,
                   eid: str | None = None) -> str:
        return self.planner.ingest(kind, data, properties, eid=eid)

    # ------------------------------------------------------------- query
    def submit(self, query: list[dict] | dict, *,
               on_entity: Optional[Callable[[Entity], None]] = None,
               cache: bool = True, priority: int = 0,
               timeout_s: Optional[float] = None,
               tenant: str = "") -> QueryFuture:
        """Submit a VDMS JSON query; returns immediately with a
        :class:`QueryFuture`.

        ``query`` is a list of command dicts (``FindImage`` /
        ``FindVideo`` / ``AddImage`` / ``AddVideo`` — see
        ``repro_torch.query.language``).  Submission cost is O(fan-out)
        pointer work only: the query is parsed, compiled to a phased
        plan, and its first phase launched onto the event loop without
        waiting for any operation to execute.

        The returned future supports ``result(timeout)``, ``done()``,
        ``cancel()``, ``exception()``, and ``add_done_callback(fn)``.
        ``on_entity(entity)`` additionally streams each entity as it
        completes its pipeline — called from event-loop threads, so the
        callback must be quick and thread-safe.

        ``cache=False`` makes this query bypass the result cache (no
        reads, no writes); it is a no-op when the engine was built
        without a cache (``cache_capacity=0``, the default).

        ``priority`` orders the admission controller's pending lane
        (higher first, FIFO within a priority); ignored (and harmless)
        when ``admission="none"``.  Under ``admission="shed"`` a query
        whose first phase does not fit under ``max_inflight_entities``
        raises :class:`~repro_torch.query.admission.OverloadError` from this
        call — fail fast, with ``retry_after_s`` attached — and nothing
        of it is launched.

        ``timeout_s`` sets the query's retry deadline budget: remote
        retries (and their backoff sleeps) never outlive it, so a
        retrying request cannot keep burning server capacity after the
        client's own ``result(timeout)`` would have given up.
        ``execute(query, timeout)`` wires its timeout through here.

        ``tenant`` names the admission-v2 quota lane the query charges
        (``admission_tenants`` weighted fair shares); the default empty
        tenant is exempt from quotas, and the knob is inert unless the
        engine was built with a tenant table."""
        if self._shut:
            raise RuntimeError("engine is shut down")
        cmds = parse_query(query)
        plan = self.planner.compile(cmds)
        qid = str(next(self._qid))
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        session = QuerySession(qid, plan, self, on_entity=on_entity,
                               use_cache=cache, priority=priority,
                               deadline=deadline, tenant=tenant)
        fut = QueryFuture(session)     # built before launch: the return
        with self._session_lock:       # after start() is a single bytecode
            if self._shut:
                # re-checked under the lock shutdown() snapshots with: a
                # session registered here is in that snapshot and gets
                # cancelled; one refused here never launches — either
                # way the future resolves, never a post-shutdown hang
                raise RuntimeError("engine is shut down")
            self._sessions[qid] = session
        session.start()
        if self.admission_ctl is not None:
            # shed fails FAST: an OverloadError raised while start() ran
            # phase 0 on this thread surfaces here as the submit()
            # exception (the session is already discarded and its future
            # resolved — callers holding neither see a hang)
            exc = session.sync_overload()
            if exc is not None:
                raise exc
        return fut

    def execute(self, query: list[dict] | dict, timeout: float | None = None,
                *, cache: bool = True) -> dict:
        """Run a VDMS JSON query; returns {"entities": {eid: array},
        "stats": {...}}.  Blocks until the pipeline drains (the client-
        facing call is synchronous, like VDMS; internally it is
        ``submit().result()``).  ``timeout`` now bounds the *whole query*
        (the old loop applied it per command) and on expiry the query is
        *cancelled* — its queued and in-flight entities are dropped,
        nothing leaks — where the old loop raised and orphaned them."""
        fut = self.submit(query, cache=cache, timeout_s=timeout)
        try:
            return fut.result(timeout)
        except TimeoutError:
            fut.cancel()
            raise

    # --------------------------------------------------- session plumbing
    def _expand_plan(self, cplan: CommandPlan, qid: str,
                use_cache: bool = True) -> list[Entity]:
        ents = self.planner.expand_plan(cplan, qid, use_cache)
        for e in ents:
            if e.done():
                # born done (no ops, or a full cache hit): straight into
                # the response — the host boundary's way out
                e.data = to_host(e.data)
        return ents

    def _admission_precheck(self, cplans, *, qid: str, first_phase: bool,
                            use_cache: bool = True, tenant: str = ""):
        """Pre-expand overload gate, deciding before any expansion work
        happens.  It runs in exactly two situations:

        - an **Add barrier phase** (Add is always the sole member of
          its phase, so the estimate is O(1)) — the controller
          atomically decides AND **reserves** the capacity under both
          policies, because the admission decision (shed, or queue-cap
          overflow) must come before the barrier's ingest side effect,
          and a check without a claim would let two queries racing the
          same last slot both pass, both ingest, then have one rejected
          post-ingest;
        - a **Find phase when the controller is saturated** — but only
          when the result cache cannot serve it (cache off, or the
          query opted out): entities the cache resolves as instant full
          hits consume no capacity and never reach :meth:`_launch`, so
          shedding on the raw match count would reject free queries.
          Find expansion has no side effects, so this stays an
          advisory check (no reservation).

        No-op on the uncontended path; the post-expand check in
        :meth:`_launch` (which sees only the entities that actually
        need capacity) stays the authority."""
        ctl = self.admission_ctl
        if ctl is None:
            return
        # cost-aware admission charges per estimated op count: the
        # widest command of the phase bounds the per-entity charge
        n_ops = max((len(cp.command.operations) for cp in cplans),
                    default=1)
        is_add_phase = any(cp.command.verb == "add" for cp in cplans)
        if is_add_phase:
            ctl.reserve(qid, self.planner.estimate_fanout(cplans),
                        first_phase=first_phase, tenant=tenant,
                        n_ops=n_ops)
            return
        if not ctl.saturated():
            return
        if self.result_cache is not None and use_cache:
            return
        ctl.precheck(self.planner.estimate_fanout(cplans),
                     first_phase=first_phase, tenant=tenant, n_ops=n_ops)

    def _launch(self, ents: list[Entity], *, priority: int = 0,
                first_phase: bool = True, tenant: str = ""):
        """Launch one phase's entities, gated by admission control when
        enabled: the controller returns the subset that fits under
        ``max_inflight_entities`` now, parks the rest in its pending
        lane, or raises :class:`OverloadError` (shedding) — in which
        case nothing was launched or queued."""
        ctl = self.admission_ctl
        if ctl is not None:
            qid = ents[0].query_id if ents else ""
            n_ops = max((len(e.ops) for e in ents), default=1)
            ents = ctl.admit_phase(qid, ents, priority,
                                   first_phase=first_phase,
                                   tenant=tenant, n_ops=n_ops)
            if qid and self._is_cancelled(qid):
                # cancel raced the admission: if its drop_query ran
                # BEFORE admit_phase re-entered this query in the
                # ledger, the slots just taken would leak forever
                # (workers skip cancelled entities without a completion
                # callback).  Release them; keep only other queries'
                # drained pending entities.
                ents = [e for e in ents if e.query_id != qid]
                ents += ctl.drop_query(qid)
        self._launch_now(ents)

    def _launch_now(self, ents: list[Entity]):
        # Pointers land on Queue_1 as one batch: workers wake only after
        # the whole phase is queued, so submit() stays milliseconds-fast
        # instead of GIL-starving behind already-running native work.
        for e in ents:
            # the host boundary's way in: the pipeline runs on the device
            e.data = to_device(e.data, self.device)
            self.erd.update(e, "enqueued")
        if ents:
            self.loop.enqueue_many(ents)

    def _store_result(self, ent: Entity):
        self.store.put(ent.eid, to_host(ent.data))
        if self.result_cache is not None:
            # blob write-back (Add with operations): cached results for
            # this eid were computed from the blob just overwritten
            self.result_cache.invalidate(ent.eid)

    def _entity_done(self, ent: Entity):
        with self._session_lock:
            session = self._sessions.get(ent.query_id)
        try:
            # the host boundary's way out: the response holds host arrays
            ent.data = to_host(ent.data)
            if session is not None:
                session.entity_done(ent)
        finally:
            if self.admission_ctl is not None and not ent.admission_released:
                # a completed entity frees an in-flight slot: drain the
                # pending lane right here on the event-loop thread that
                # delivered the completion (no polling thread needed).
                # In a finally: a raising session callback (e.g. a
                # blob-store write-back failure) must never leak the
                # slot — a few leaks would pin the ledger at the cap and
                # stall every later query.  The per-entity flag keeps
                # the release idempotent: after such a raise the worker
                # error path delivers the SAME entity here a second
                # time, which must not double-release capacity.
                ent.admission_released = True
                self._launch_now(self.admission_ctl.note_done(ent))

    def _is_cancelled(self, qid: str) -> bool:
        # hot path (checked at every op boundary by every worker): a bare
        # dict.get is GIL-atomic, so skip _session_lock here — it would
        # serialize the whole native pool on one lock
        session = self._sessions.get(qid)
        return session is None or session.is_cancelled

    def _session_finished(self, qid: str):
        with self._session_lock:
            self._sessions.pop(qid, None)

    def _discard_session(self, qid: str):
        """Cancellation/timeout cleanup: forget the session, drop its
        queued native work, its in-flight remote requests, and its
        pending/in-flight admission ledger entries (freed capacity
        immediately admits other queries' pending entities)."""
        with self._session_lock:
            self._sessions.pop(qid, None)
        self.loop.discard_query(qid)
        self.pool.drop_query(qid)
        if self.admission_ctl is not None:
            self._launch_now(self.admission_ctl.drop_query(qid))

    def active_sessions(self) -> int:
        with self._session_lock:
            return len(self._sessions)

    # -------------------------------------------------------- operations
    def scale_remote(self, n: int):
        self.pool.scale_to(n)

    def utilization(self) -> dict:
        return {
            "thread2_busy_s": self.loop.t2_meter.busy_seconds(),
            "thread3_busy_s": self.loop.t3_meter.busy_seconds(),
            "native_workers": self.num_native_workers,
            "remote_processed": sum(s.processed for s in self.pool.servers),
            "remote_dispatched": self.pool.dispatched,
            "remote_transport_busy_s": sum(s.transport_busy_s
                                           for s in self.pool.servers),
            "coalesced_batches": self.loop.coalesced_batches,
            "coalesced_entities": self.loop.coalesced_entities,
            "retried": self.pool.retried,
            "reissued": self.pool.reissued,
            "duplicates_dropped": self.pool.duplicates_dropped,
            "cancelled_dropped": self.pool.cancelled_dropped,
        }

    def cache_stats(self) -> dict:
        """Engine-lifetime result-cache counters (empty dict when the
        cache is off): ``size`` / ``bytes`` and their capacities,
        ``hits`` / ``prefix_hits`` / ``misses`` / ``hit_rate``, and the
        write-side ledger (``puts``, ``stale_puts``, ``oversize_puts``,
        ``evictions``, ``invalidations``).  Per-query hit counts ride
        on each response's ``stats`` instead (``cache_full_hits`` /
        ``cache_prefix_hits``)."""
        return (self.result_cache.stats()
                if self.result_cache is not None else {})

    def dispatch_stats(self) -> dict:
        """Multi-backend router counters: ``placements`` (ops placed
        per backend), ``handoffs`` / ``segments`` / ``chains_routed``,
        live ``queue_depths``, plus per-backend accounting blocks —
        ``batcher`` (groups/entities run, errors, cancelled drops) and
        ``device`` (groups/entities/ops run, ``fused_segments``,
        ``compiles`` — first runs of a (segment, batch shape), where
        kernel builds and lazy set-up land — + bounded program-cache
        ``jit_entries``/``jit_evictions``,
        calibration state, ``h2d_bytes``/``d2h_bytes`` moved,
        ``padding_waste_frac``, and — with ``num_device_workers > 1``
        — a ``per_device`` breakdown) when those backends exist.  ``{"mode": "static"}`` alone when the router is off
        (not to be confused with ``dispatch_policy``, the remote pool's
        round-robin/least-loaded server picker)."""
        out: dict = {"mode": self.dispatch}
        if self.router is not None:
            out.update(self.router.stats())
        if self.batcher_backend is not None:
            out["batcher"] = self.batcher_backend.stats()
        if self.device_backend is not None:
            out["device"] = self.device_backend.stats()
        if self.health is not None:
            out["breakers"] = self.health.stats()
        if self._ft_visible:
            # only when a fault-tolerance knob is on: a default engine's
            # dict stays byte-identical to the baseline
            out["pool"] = self.pool.health_stats()
            out["fallbacks"] = self.loop.fallbacks
        return out

    def admission_stats(self) -> dict:
        """Admission-control counters (``{"policy": "none"}`` alone when
        admission is off): the live ``inflight`` / ``peak_inflight`` /
        ``pending`` ledger, lifetime ``admitted`` / ``queued`` /
        ``shed`` / ``completed`` / ``dropped`` counts, the
        ``completion_rate_est`` feeding retry-after estimates, and the
        ``load`` score component snapshot (see
        :meth:`repro_torch.query.admission.AdmissionController.load_score`)."""
        if self.admission_ctl is None:
            return {"policy": "none"}
        return self.admission_ctl.stats()

    def pending_coalesced(self) -> int:
        """Entities buffered in open coalescing groups right now — the
        deterministic signal to poll instead of sleeping out the
        wall-clock window (always 0 when coalescing is off)."""
        return self.loop.pending_coalesced()

    def flush_coalesced(self):
        """Force-dispatch all open coalescing groups now, regardless of
        their window deadlines — the deterministic alternative to
        waiting out ``coalesce_window_ms`` (tests, graceful drains).
        Asynchronous: the flush is processed by Thread_3; a no-op when
        coalescing is off."""
        self.loop.flush_coalesced()

    def shutdown(self):
        """Deterministic teardown, safe with sessions still in flight:
        new ``submit``\\ s are refused first, every live session is
        cancelled (blocked ``result()`` callers wake with
        ``CancelledError``), pending admissions are dropped, the
        offload backends drain behind their poison pills (late routed
        work fails loudly instead of vanishing), and every loop, pool,
        and backend thread is joined.  Idempotent."""
        with self._session_lock:
            # setting the flag under the registration lock makes the
            # snapshot below complete: every submit() that got past the
            # flag is in it, every later one raises
            self._shut = True
            live = list(self._sessions.values())
        if self.admission_ctl is not None:
            # refuse new admissions before cancelling sessions, so a
            # cancel-triggered drain cannot relaunch pending work
            self.admission_ctl.shutdown()
        for s in live:            # wake any blocked result() callers
            s.cancel()
        if self.batcher_backend is not None:
            self.batcher_backend.shutdown()
        if self.device_backend is not None:
            self.device_backend.shutdown()
        self.loop.shutdown()
        self.pool.shutdown()
