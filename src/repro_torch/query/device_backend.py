"""Device-executor backend: the dispatch backend that runs routed ops as
batched work on an accelerator (the CUDA card; ``torch.device("cpu")``
gives a CPU-as-device executor for hosts without one).

The dispatch layer's three other backends all execute per entity on CPU
threads or simulated servers; this one's cost structure is
qualitatively different: one worker thread per device owns batched
execution, which amortizes per-op launch and Python overhead over the
micro-batch.

Execution model: one worker thread per device pulls entities off an
inbox, collects a micro-batch of up to ``batch_size`` entities held at
most ``max_wait_s`` from the first member, partitions it, and runs each
partition as ONE batched device program.  Two partition granularities:

- **per-op** (``fuse_segments=False``): partition by (current op,
  payload shape/dtype); each partition is stacked, run as one batched
  call, and the entity goes back through the event loop for its next
  op.
- **fused segments** (``fuse_segments=True``, the engine default when
  the device backend is on): partition by (*segment signature*, shape,
  dtype), where the segment is the maximal run of consecutive ops the
  router placed on ``device``.  The whole segment runs as ONE program —
  the batched native-table ops composed with the ``DEVICE_BATCH_PATHS``
  fast paths — so tensors stay on the device across the chain and a
  4-op segment costs one event-loop round trip where the per-op path
  paid four.  Registered *chain* fast paths (tuple keys in
  ``DEVICE_BATCH_PATHS``, e.g. ``("resize", "crop", "normalize")`` →
  the fused preprocessing kernel in ``repro_torch.kernels.preprocess``)
  collapse a multi-op run into a single kernel launch inside the
  program.  Fused partitions are **double-buffered**: the next
  partition is stacked and its kernels enqueued while the previous one
  still computes on the card (CUDA launches are asynchronous; a CUDA
  event marks each partition's end), and only then is the previous one
  settled.

What runs where inside a partition:

- **native-table ops** (crop/resize/blur/...): every op of
  ``repro_torch.visual.ops`` takes (..., H, W, C), so the stacked batch
  (B, H, W, C) goes through the same function the per-entity path runs
  (batches are padded to power-of-two buckets so the shape set stays
  small — singleton groups skip padding entirely).  Ops with a batched
  kernel fast path run it on the stacked batch (``DEVICE_BATCH_PATHS``
  — ``blur`` launches the Gaussian-blur kernel once over (B,H,W,C)).
- **device UDFs** (``repro_torch.core.udf.register_device_udf``): the
  registered callable takes the whole micro-batch and owns its own
  device placement.  A segment containing a device UDF (or a video
  payload) takes the host path op-by-op.

Entities arrive carrying tensors on the engine's device (the engine's
host boundary, ``repro_torch.core.boundary``).  A partition is stacked
on this backend's device — a plain stack when the entity already lives
there — and each result goes back on the device its entity came from,
so nothing crosses to the host here.

Replies ride the event loop's existing Thread_3 path as
``("device", entity, result, err, ops_advanced)`` messages on Queue_2 —
the same handoff remote and batcher replies take.  A fused segment is
ONE reply advancing ``ops_advanced`` ops, so the result-cache
prefix-resume snapshot lands at the segment *boundary*.

Cost model (the device terms of the dispatch DP)::

    enter(op)  = wait/2 + transfer(payload, B)       one h2d+d2h per segment
               + op_est_device | op_est_native / B   per-entity compute
               + compile_s / (1 + runs(op))          first-run amortization
               + backlog                             placement-feedback ledger
    resident(op) = op_est_device | op_est_native / B pure marginal compute

``enter`` is charged when a chain arrives on the device (the router's
DP entry into a device segment); with fusion enabled every *subsequent*
consecutive device op costs only ``resident``.  ``transfer`` is a
:class:`DeviceCostModel` estimate calibrated once at construction by
timing a real host→device→host round trip; the "compile" term is the
first run of a program at a shape (kernel build and lazy CUDA set-up
land there).

Multi-device: :class:`MultiDeviceBackend` wraps one
:class:`DeviceBackend` worker per visible device behind the same
``Backend`` protocol surface; segment groups are spread by least
estimated backlog, and ``stats()`` aggregates plus reports a
``per_device`` breakdown.

The default engine never builds any of this (``dispatch="static"`` and
even ``dispatch="cost"`` without ``device_backend=True`` are unchanged);
enabling it only ADDS a routing option — correctness is unaffected
because every backend must be result-equivalent.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import queue
import threading
import time
from typing import Any, Optional

import torch

from repro_torch.core.boundary import to_device
from repro_torch.core.result_cache import op_signature
from repro_torch.core import spans as spans_mod
from repro_torch.query.dispatch import OFFLOAD_STOP, OffloadInboxMixin

DEVICE = "device"


# --------------------------------------------------- pallas fast paths
def _blur_batch(batch, *, ksize: int = 5, sigma_x: float = 0.0,
                sigma_y: float = 0.0):
    """Batched Gaussian blur over (B,H,W,C) — one kernel launch for the
    whole micro-batch (the CUDA kernel on the card, the plain version on
    the CPU);
    parameter handling mirrors ``repro_torch.visual.ops.blur`` exactly so the
    result matches the per-entity native path."""
    from repro_torch.kernels import ops as kops
    return kops.gaussian_blur(batch, ksize, sigma_x, sigma_y or None)


def _preprocess_chain(batch, *, ops):
    """resize→crop→normalize as ONE fused kernel launch over the whole
    (B,H,W,C) batch (``repro_torch.kernels.preprocess``): the interpolation
    matrices carry the crop window and the normalize folds into a
    trailing affine, so the three-op prefix costs two matmuls."""
    from repro_torch.kernels import ops as kops
    rs, cr, nm = ops
    rk, ck, nk = rs.kwargs, cr.kwargs, nm.kwargs
    return kops.fused_preprocess(
        batch, resize_h=rk["height"], resize_w=rk["width"],
        method=rk.get("method", "bilinear"),
        crop_x=ck["x"], crop_y=ck["y"],
        crop_w=ck["width"], crop_h=ck["height"],
        mean=nk.get("mean", 0.0), std=nk.get("std", 1.0))


# str key: op whose batched device execution is a direct whole-batch
# kernel call; fn(batch (B,H,W,C), **op.kwargs) -> batch.
# tuple key: a *chain* fast path — a run of consecutive ops matching the
# tuple collapses into one call inside the fused segment program;
# fn(batch, ops=(op, ...)) -> batch.  Chain keys only fire when segment
# fusion is on (the per-op path never sees a multi-op partition).
DEVICE_BATCH_PATHS = {
    "blur": _blur_batch,
    ("resize", "crop", "normalize"): _preprocess_chain,
}


def _apply_batched(name, kwargs, batch):
    from repro_torch.visual.ops import apply_native_op
    return apply_native_op(name, batch, kwargs)


def _sync_point(device: torch.device):
    """A CUDA event marking the end of the work enqueued so far on
    ``device``'s current stream (``None`` on the CPU, where every call
    has finished when it returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _wait(event) -> None:
    if event is not None:
        event.synchronize()


class DeviceCostModel:
    """Host↔device transfer + first-run cost terms.

    The transfer side mirrors :class:`repro_torch.core.remote.TransportModel`
    for the PCIe/ICI hop: a fixed per-call dispatch latency (amortized
    over the micro-batch — one device call serves B entities) plus
    payload bytes over the h2d and d2h bandwidths.  ``calibrate()``
    replaces the default bandwidths with measured ones by timing a real
    host→device→host round trip against the target device.

    The compile side is an EWMA of observed first-run wall times
    (kernel build and lazy set-up), ``compile_default_s`` until one has been seen.
    """

    def __init__(self, *, h2d_bytes_s: float = 4e9, d2h_bytes_s: float = 4e9,
                 dispatch_latency_s: float = 50e-6,
                 compile_default_s: float = 0.05, alpha: float = 0.25):
        self.h2d_bytes_s = h2d_bytes_s
        self.d2h_bytes_s = d2h_bytes_s
        self.dispatch_latency_s = dispatch_latency_s
        self.compile_default_s = compile_default_s
        self.alpha = alpha
        self._compile_est: Optional[float] = None
        self.calibrated = False

    def calibrate(self, device, probe_bytes: int = 1 << 20):
        """Measure real h2d/d2h bandwidth with one probe round trip.
        Failures (no device, backend quirks) leave the defaults."""
        try:
            device = torch.device(device)
            probe = torch.ones(probe_bytes // 4, dtype=torch.float32)
            t0 = time.monotonic()
            on_dev = probe.to(device, copy=True)
            _wait(_sync_point(device))
            t1 = time.monotonic()
            on_dev.to("cpu", copy=True)
            t2 = time.monotonic()
            if t1 - t0 > 0:
                self.h2d_bytes_s = probe_bytes / (t1 - t0)
            if t2 - t1 > 0:
                self.d2h_bytes_s = probe_bytes / (t2 - t1)
            self.calibrated = True
        except Exception:  # noqa: BLE001 — calibration is best-effort
            pass

    def transfer_s(self, nbytes: float, batch: int = 1) -> float:
        """Seconds to move one entity's payload through the device,
        with the fixed dispatch latency amortized over the micro-batch
        (output size approximated by input size)."""
        nbytes = max(0.0, float(nbytes))
        return (self.dispatch_latency_s / max(1, batch)
                + nbytes / self.h2d_bytes_s + nbytes / self.d2h_bytes_s)

    def observe_compile(self, seconds: float):
        prev = self._compile_est
        self._compile_est = (seconds if prev is None
                             else (1 - self.alpha) * prev
                             + self.alpha * seconds)

    def compile_s(self) -> float:
        return (self._compile_est if self._compile_est is not None
                else self.compile_default_s)


@dataclasses.dataclass
class _Staged:
    """One in-flight fused device partition: stacked and its program
    enqueued, settlement + replies deferred so the NEXT partition's
    staging can overlap this one's compute (the double-buffer slot)."""
    seg: tuple
    skey: tuple
    live: list
    homes: list      # each entity's own device, where its result goes
    n: int
    out: Any
    done: Any        # CUDA event after the program (None on the CPU)
    t0: float
    fresh: bool
    ckey: tuple


class DeviceBackend(OffloadInboxMixin):
    """Accelerator execution as a dispatch backend (``Backend`` protocol
    from repro_torch.query.dispatch; see the module docstring for the
    execution and cost model).

    Built by the engine when ``dispatch="cost"`` and ``device_backend``
    is enabled; ``bind()`` attaches it to the event loop's Queue_2 and
    cancellation predicate and starts the worker — separate from
    ``__init__`` because the engine builds backends before the loop
    exists (same lifecycle as :class:`UDFBatcherBackend`, whose inbox
    lifecycle — gated ``submit``, poison-pill ``shutdown``, post-join
    drain — this class shares via
    :class:`repro_torch.query.dispatch.OffloadInboxMixin`).
    """

    name = DEVICE

    def __init__(self, *, batch_size: int = 8, max_wait_s: float = 0.002,
                 tracker=None, device=None,
                 cost_model: DeviceCostModel | None = None,
                 calibrate: bool = True, clock=time.monotonic,
                 fuse_segments: bool = False,
                 jit_cache_cap: int = 128, spans=None):
        from repro_torch.query.dispatch import LoadLedger, OpCostTracker
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceBackend defaults to the CUDA card and this host "
                    "has none; pass device=torch.device('cpu')")
            device = torch.device("cuda", torch.cuda.current_device())
        self.batch_size = max(1, batch_size)
        self.max_wait_s = max(0.0, max_wait_s)
        self.tracker = tracker or OpCostTracker()
        self.device = torch.device(device)
        self.cost_model = cost_model or DeviceCostModel()
        if calibrate and cost_model is None:
            self.cost_model.calibrate(self.device)
        self._clock = clock
        self.fuse_segments = bool(fuse_segments)
        self.jit_cache_cap = max(1, jit_cache_cap)
        # the engine's recorder (device.* spans; a device UDF's route
        # records into it while this backend runs its group)
        self.spans = spans if spans is not None else \
            spans_mod.SpanRecorder()
        # single device stream: the worker serializes device calls, so
        # the ledger drains at 1 work-second per wall second
        self.ledger = LoadLedger(lambda: 1.0, clock=clock)
        self._init_inbox()
        self._reply_to: Optional[queue.Queue] = None
        self._is_cancelled = lambda qid: False
        # bounded LRU of built programs: per-op signature keys on the
        # per-op path, segment-signature tuples on the fused path (a
        # long-lived engine seeing many op signatures must not grow its
        # program cache without bound)
        self._jit_cache: collections.OrderedDict = collections.OrderedDict()
        self._compiled: set = set()   # (cache key, batch shape) run once
        self._runs: dict = {}         # op/segment signature -> device runs
        self.groups_run = 0
        self.entities_run = 0
        self.ops_run = 0
        self.fused_segments = 0
        self.errors = 0
        self.cancelled_dropped = 0
        self.compiles = 0
        self.jit_evictions = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.stacked_rows = 0     # real entities stacked into batches
        self.pad_rows = 0         # pow2-bucket padding rows computed

    # -------------------------------------------------- engine plumbing
    def bind(self, reply_to: queue.Queue, is_cancelled) -> None:
        """Attach to the event loop (its Queue_2 + cancellation
        predicate) and start the device worker thread."""
        self._reply_to = reply_to
        self._is_cancelled = is_cancelled
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-backend")
        self._thread.start()

    # --------------------------------------------------- Backend protocol
    def can_run(self, op) -> bool:
        """Native-table ops run batched as-is; anything else needs a
        registered device UDF."""
        from repro_torch.core.udf import has_device_udf
        from repro_torch.visual.ops import NATIVE_OPS
        return op.name in NATIVE_OPS or has_device_udf(op.name)

    def _per_entity_estimate(self, op) -> float:
        """Per-entity device compute: the observed device EWMA once this
        op has run here, else the native estimate amortized over the
        micro-batch (one vectorized call serves the whole batch — the
        same optimistic prior the batcher backend uses)."""
        if self.tracker.known(op, kind="device"):
            return self.tracker.estimate(op, kind="device")
        return self.tracker.estimate(op) / self.batch_size

    def estimate(self, op, payload_bytes: int) -> float:
        compile_amort = (self.cost_model.compile_s()
                         / (1.0 + self._runs.get(op_signature(op), 0)))
        return (self.max_wait_s / 2.0
                + self.cost_model.transfer_s(payload_bytes,
                                             batch=self.batch_size)
                + self._per_entity_estimate(op)
                + compile_amort
                + self.ledger.backlog_s())

    @property
    def resident_capable(self) -> bool:
        """Whether consecutive placements here extend a device-resident
        segment (the router then prices them with
        :meth:`estimate_resident`) — true exactly when segment fusion
        is on."""
        return self.fuse_segments

    def estimate_resident(self, op, payload_bytes: int) -> float:
        """Marginal cost of ``op`` when the entity is ALREADY resident
        (the previous op was placed here and fusion is on): pure
        per-entity compute.  No batching wait, no transfer, no compile
        surcharge — the segment ships as one program whose entry op
        already paid those, which is what makes fusion *widen* the
        regime where the device wins."""
        return self._per_entity_estimate(op)

    def queue_depth(self) -> int:
        return self.inbox.qsize()

    def submit(self, entity) -> None:
        entity.inbox_t = time.perf_counter()
        super().submit(entity)

    def note_placed(self, op) -> None:
        self.ledger.add(self._per_entity_estimate(op))

    def device_allocs(self) -> Optional[int]:
        """The caching allocator's ``cudaMalloc`` calls on this device so
        far (``None`` off CUDA, or where torch does not count them)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.memory_stats(self.device).get("num_device_alloc")

    def trace_stats(self) -> dict:
        """The engine's spans and counters (``SpanRecorder.snapshot()``),
        with ``device.mallocs`` read now on a CUDA device."""
        snap = self.spans.snapshot()
        allocs = self.device_allocs()
        if allocs is not None:
            snap["counters"]["device.mallocs"] = allocs
        return snap

    def stats(self) -> dict:
        """Lifetime counters of this worker.  ``h2d_bytes`` counts the
        stacked partitions on the device, padding rows included, and
        ``d2h_bytes`` the programs' output bytes: neither is a
        host↔device copy, since entities arrive on the device and leave
        it through the engine's boundary (``boundary.*`` spans).
        ``trace`` is :meth:`trace_stats`."""
        stacked = self.stacked_rows + self.pad_rows
        return {"device": str(self.device),
                "platform": self.device.type,
                "calibrated": self.cost_model.calibrated,
                "groups_run": self.groups_run,
                "entities_run": self.entities_run,
                "ops_run": self.ops_run,
                "fused_segments": self.fused_segments,
                "errors": self.errors,
                "cancelled_dropped": self.cancelled_dropped,
                "pending": self.pending(),
                "compiles": self.compiles,
                "jit_entries": len(self._jit_cache),
                "jit_cache_cap": self.jit_cache_cap,
                "jit_evictions": self.jit_evictions,
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes,
                "padding_waste_frac": (self.pad_rows / stacked
                                       if stacked else 0.0),
                "trace": self.trace_stats()}

    # ---------------------------------------------- program-cache plumbing
    def _jit_lookup(self, key, build):
        """Built-program lookup with LRU touch; ``build()`` fills a
        miss.  Eviction drops the program AND its per-shape first-run
        marks, and counts toward ``jit_evictions`` in ``stats()``."""
        fn = self._jit_cache.get(key)
        if fn is not None:
            self._jit_cache.move_to_end(key)
            return fn
        fn = build()
        self._jit_cache[key] = fn
        while len(self._jit_cache) > self.jit_cache_cap:
            evicted, _ = self._jit_cache.popitem(last=False)
            self.jit_evictions += 1
            self._compiled = {ck for ck in self._compiled
                              if ck[0] != evicted}
        return fn

    # ------------------------------------------------------- worker loop
    def _run(self):
        from repro_torch.query.dispatch import collect_microbatch
        while True:
            first = self.inbox.get()
            if first is OFFLOAD_STOP:
                self._drain_after_stop()
                return
            group, stop = collect_microbatch(
                self.inbox, first, size=self.batch_size,
                max_wait_s=self.max_wait_s, clock=self._clock,
                stop=OFFLOAD_STOP)
            self._run_groups(group)
            if stop:
                self._drain_after_stop()
                return

    def _segment_ops(self, ent) -> tuple:
        """The entity's current device *segment*: the maximal run of
        consecutive ops the router placed on this backend, starting at
        its current op.  Per-op when fusion is off (or the entity has
        no route — drain paths)."""
        if not self.fuse_segments or ent.route is None:
            return (ent.current_op(),)
        i = ent.op_index
        j = i + 1
        while j < len(ent.ops) and j < len(ent.route) \
                and ent.route[j] == DEVICE:
            j += 1
        return tuple(ent.ops[i:j])

    def _run_groups(self, group):
        t = time.perf_counter()
        self.spans.add("device.wait", sum(t - e.inbox_t for e in group),
                       len(group))
        with spans_mod.using(self.spans), self.spans.span(
                "device.group", {e.query_id for e in group}):
            self._run_group(group)

    def _run_group(self, group):
        if not self.fuse_segments:
            # per-op path: one device call covers one (op, shape, dtype)
            by_key: dict = {}
            for ent in group:
                arr = ent.data
                key = (ent.current_op(), tuple(arr.shape), str(arr.dtype))
                by_key.setdefault(key, []).append(ent)
            for (op, _shape, _dtype), ents in by_key.items():
                self._run_partition(op, ents)
            return
        # fused path: one device call covers one (segment, shape, dtype)
        by_key = {}
        for ent in group:
            arr = ent.data
            seg = self._segment_ops(ent)
            key = (tuple(op_signature(o) for o in seg),
                   tuple(arr.shape), str(arr.dtype))
            if key not in by_key:
                by_key[key] = (seg, [])
            by_key[key][1].append(ent)
        staged: Optional[_Staged] = None     # the double-buffer slot
        for (skey, _shape, _dtype), (seg, ents) in by_key.items():
            live = []
            for ent in ents:
                if self._is_cancelled(ent.query_id):
                    self.cancelled_dropped += 1
                else:
                    live.append(ent)
            if not live:
                continue
            if self._needs_host_path(seg, live):
                # host partitions don't pipeline: settle the in-flight
                # device partition first so replies keep arrival order
                if staged is not None:
                    self._finalize_staged(staged)
                    staged = None
                self._run_segment_host(seg, skey, live)
                continue
            nxt = self._stage_segment(seg, skey, live)
            if staged is not None:
                # next partition's h2d + dispatch are in flight while
                # this one computes — now settle it (block, d2h, reply)
                self._finalize_staged(staged)
            staged = nxt
        if staged is not None:
            self._finalize_staged(staged)

    # --------------------------------------------------- fused segments
    @staticmethod
    def _needs_host_path(seg, live) -> bool:
        """A segment runs as one device-resident program only when every
        op is a pure native-table op over image payloads.  Device UDFs
        consume lists (they own their placement), and video payloads
        keep the documented per-op fallback."""
        from repro_torch.core.udf import has_device_udf
        from repro_torch.visual.ops import NATIVE_OPS
        if live[0].data.ndim != 3:
            return True
        return any(op.name not in NATIVE_OPS or has_device_udf(op.name)
                   for op in seg)

    def _build_segment_fn(self, seg):
        """Compose the segment into one program over the stacked batch:
        registered chain fast paths first (longest match), then
        single-op fast paths, then the batched native-table ops.
        Intermediates never leave the device."""
        chain_keys = sorted(
            (k for k in DEVICE_BATCH_PATHS if isinstance(k, tuple)),
            key=len, reverse=True)
        names = [o.name for o in seg]
        steps = []
        i = 0
        while i < len(seg):
            chain = next((k for k in chain_keys
                          if tuple(names[i:i + len(k)]) == k), None)
            if chain is not None:
                steps.append(functools.partial(
                    DEVICE_BATCH_PATHS[chain], ops=tuple(seg[i:i + len(chain)])))
                i += len(chain)
            elif names[i] in DEVICE_BATCH_PATHS:
                fast, kwargs = DEVICE_BATCH_PATHS[names[i]], seg[i].kwargs
                steps.append(lambda b, _f=fast, _k=kwargs: _f(b, **_k))
                i += 1
            else:
                steps.append(functools.partial(
                    _apply_batched, seg[i].name, seg[i].kwargs))
                i += 1

        def program(batch):
            for step in steps:
                batch = step(batch)
            return batch

        return program

    def _stack(self, live) -> tuple:
        """Stack the partition's payloads on this device, padded to a
        power-of-two bucket (a singleton is not padded).  Returns
        ``(batch, pad)``."""
        arrs = [to_device(e.data, self.device) for e in live]
        n = len(arrs)
        if n == 1:
            return arrs[0][None], 0
        batch = torch.stack(arrs)
        pad = self._bucket(n) - n
        if pad:
            batch = torch.cat([batch, batch[-1:].expand(
                (pad,) + tuple(batch.shape[1:]))])
        return batch, pad

    @staticmethod
    def _homes(live) -> list:
        return [e.data.device if isinstance(e.data, torch.Tensor)
                else None for e in live]

    @staticmethod
    def _split(out, n, homes) -> list:
        """One result per live entity, on the device it came from."""
        return [out[i] if home is None else out[i].to(home)
                for i, home in zip(range(n), homes)]

    def _stage_segment(self, seg, skey, live) -> Optional[_Staged]:
        """Stack and pad one partition on the device and enqueue its
        program WITHOUT blocking — the returned slot is settled by
        :meth:`_finalize_staged` after the next partition has been
        staged (double-buffering: staging N+1 overlaps compute N)."""
        with self.spans.span("device.stage"):
            try:
                self._maybe_fault()
                n = len(live)
                homes = self._homes(live)
                batch, pad = self._stack(live)
                self.stacked_rows += n
                self.pad_rows += pad
                self.h2d_bytes += batch.nbytes
                fn = self._jit_lookup(skey,
                                      lambda: self._build_segment_fn(seg))
                ckey = (skey, tuple(batch.shape))
                fresh = ckey not in self._compiled
                t0 = self._clock()
                out = fn(batch)
                return _Staged(seg=seg, skey=skey, live=live, homes=homes,
                               n=n, out=out, done=_sync_point(self.device),
                               t0=t0, fresh=fresh, ckey=ckey)
            except Exception as e:  # noqa: BLE001 — report, keep the worker
                self.errors += 1
                for ent in live:
                    self._reply_to.put((DEVICE, ent, None, e, len(seg)))
                return None

    def _finalize_staged(self, st: Optional[_Staged]):
        if st is None:
            return
        with self.spans.span("device.settle"):
            try:
                _wait(st.done)
                exec_s = self._clock() - st.t0
                if st.fresh:
                    self._compiled.add(st.ckey)
                    self.compiles += 1
                    # first-run wall ≈ kernel build + lazy set-up —
                    # feeds the amortization term, which only needs the
                    # magnitude
                    self.cost_model.observe_compile(exec_s)
                self.d2h_bytes += st.out.nbytes
                results = self._split(st.out, st.n, st.homes)
            except Exception as e:  # noqa: BLE001
                self.errors += 1
                for ent in st.live:
                    self._reply_to.put((DEVICE, ent, None, e,
                                        len(st.seg)))
                return
            self._deliver(st.seg, st.skey, st.live, results, exec_s)

    def _run_segment_host(self, seg, skey, live):
        """Host path for segments the fused program cannot serve (device
        UDFs, video payloads): op-by-op over the partition, one reply
        per entity for the whole segment."""
        with self.spans.span("device.host_segment"):
            from repro_torch.core.udf import get_device_udf, has_device_udf
            from repro_torch.core.pipeline import run_op
            t0 = self._clock()
            data = [e.data for e in live]
            try:
                self._maybe_fault()
                for op in seg:
                    if has_device_udf(op.name):
                        data = get_device_udf(op.name)(list(data),
                                                       **op.kwargs)
                        if len(data) != len(live):
                            # same contract as batched UDFs: a short
                            # result list must never strand unanswered
                            # entities
                            raise ValueError(
                                f"device UDF {op.name!r} returned "
                                f"{len(data)} results for {len(live)} "
                                f"inputs")
                    else:
                        data = [run_op(op, d) for d in data]
            except Exception as e:  # noqa: BLE001
                self.errors += 1
                for ent in live:
                    self._reply_to.put((DEVICE, ent, None, e, len(seg)))
                return
            self._deliver(seg, skey, live, list(data), self._clock() - t0)

    def _deliver(self, seg, skey, live, results, exec_s):
        """Shared tail of a fused/host partition: calibration, counters,
        one reply per entity advancing the whole segment."""
        first_run = skey not in self._runs
        if not first_run:
            # attribute the partition wall evenly across the segment's
            # ops (the same rough-but-calibrating split fuse_native
            # uses); the FIRST run is skipped — compile-contaminated
            per_op = exec_s / len(live) / len(seg)
            out_bytes = getattr(results[0], "nbytes", None)
            for k, op in enumerate(seg):
                self.tracker.observe(
                    op, per_op, kind="device",
                    out_bytes=out_bytes if k == len(seg) - 1 else None)
        self._runs[skey] = self._runs.get(skey, 0) + 1
        for op in seg:
            # per-op run counts drive estimate()'s compile amortization
            sig = op_signature(op)
            self._runs[sig] = self._runs.get(sig, 0) + 1
        self.groups_run += 1
        self.entities_run += len(live)
        self.ops_run += len(live) * len(seg)
        if len(seg) > 1:
            self.fused_segments += 1
        for ent, res in zip(live, results):
            self._reply_to.put((DEVICE, ent, res, None, len(seg)))

    # ------------------------------------------------------ per-op path
    def _run_partition(self, op, ents):
        live = []
        for ent in ents:
            if self._is_cancelled(ent.query_id):
                self.cancelled_dropped += 1
            else:
                live.append(ent)
        if not live:
            return
        from repro_torch.core.udf import get_device_udf, has_device_udf
        sig = op_signature(op)
        first_run = sig not in self._runs
        try:
            self._maybe_fault()
            if has_device_udf(op.name):
                t0 = self._clock()
                results = get_device_udf(op.name)(
                    [e.data for e in live], **op.kwargs)
                exec_s = self._clock() - t0
                if len(results) != len(live):
                    # same contract as batched UDFs: a short result list
                    # must never strand unanswered entities
                    raise ValueError(
                        f"device UDF {op.name!r} returned {len(results)} "
                        f"results for {len(live)} inputs")
            else:
                results, exec_s = self._run_native_batch(op, live)
        except Exception as e:  # noqa: BLE001 — report, don't kill worker
            self.errors += 1
            for ent in live:
                self._reply_to.put((DEVICE, ent, None, e, 1))
            return
        # the device EWMA must hold PURE per-entity execution seconds —
        # estimate() adds transfer and compile amortization separately,
        # so feeding them into the EWMA would double-count.  The native
        # path excludes transfer by construction (exec_s spans only the
        # device program); an op's FIRST run is skipped entirely because
        # its wall is dominated by first-run set-up (device UDFs own
        # their set-up, so their first call is equally contaminated).
        if not first_run:
            self.tracker.observe(op, exec_s / len(live), kind="device",
                                 out_bytes=getattr(results[0], "nbytes",
                                                   None))
        self._runs[sig] = self._runs.get(sig, 0) + 1
        self.groups_run += 1
        self.entities_run += len(live)
        self.ops_run += len(live)
        for ent, res in zip(live, results):
            self._reply_to.put((DEVICE, ent, res, None, 1))

    # ------------------------------------------------- native batch path
    @staticmethod
    def _bucket(n: int) -> int:
        """Next power of two ≥ n — batches are padded up to a bucket so
        the programs see a handful of batch shapes instead of one per
        group size (padded rows are computed independently and sliced
        away)."""
        b = 1
        while b < n:
            b <<= 1
        return b

    def _run_native_batch(self, op, ents) -> tuple:
        """Returns ``(results, exec_seconds)`` where the seconds span
        ONLY the device program — stacking is excluded because the cost
        model charges transfer via its own calibrated term."""
        if ents[0].data.ndim != 3:
            # video (T,H,W,C) and other non-image payloads: the
            # standard per-entity path (run_op's frame loop; stacking
            # would give one batch shape per clip length for little gain)
            from repro_torch.core.pipeline import run_op
            t0 = self._clock()
            return [run_op(op, e.data) for e in ents], self._clock() - t0
        n = len(ents)
        homes = self._homes(ents)
        batch, pad = self._stack(ents)
        _wait(_sync_point(self.device))
        self.stacked_rows += n
        self.pad_rows += pad
        self.h2d_bytes += batch.nbytes
        sig = op_signature(op)

        def build():
            kwargs = op.kwargs
            if op.name in DEVICE_BATCH_PATHS:
                fast = DEVICE_BATCH_PATHS[op.name]
                return lambda b: fast(b, **kwargs)
            return functools.partial(_apply_batched, op.name, kwargs)

        fn = self._jit_lookup(sig, build)
        ckey = (sig, tuple(batch.shape))
        fresh = ckey not in self._compiled
        t1 = self._clock()
        out = fn(batch)
        _wait(_sync_point(self.device))
        exec_s = self._clock() - t1
        if fresh:
            self._compiled.add(ckey)
            self.compiles += 1
            # first-run wall ≈ kernel build + lazy set-up (the steady
            # state is negligible next to it) — good enough for the
            # amortization term, which only needs the magnitude
            self.cost_model.observe_compile(exec_s)
        self.d2h_bytes += out.nbytes
        return self._split(out, n, homes), exec_s


class MultiDeviceBackend:
    """One :class:`DeviceBackend` worker per visible device behind a
    single ``Backend``-protocol surface (name ``"device"``), so the
    router and event loop stay single-backend while execution spreads
    across devices.

    Placement: ``estimate`` quotes the cheapest worker (whose ledger
    backlog the router's feedback keeps honest), ``note_placed`` charges
    that worker's ledger, and ``submit`` routes each entity to the
    worker with the least estimated backlog at submit time (placement
    ledger first, inbox depth as the tiebreak) — segment *groups*
    naturally land together because consecutive submits see the same
    ordering until the ledger moves.  ``stats()`` aggregates the fleet
    and carries a ``per_device`` breakdown
    (``dispatch_stats()["device"]["per_device"]``: per-device groups,
    compiles, transfer bytes, padding waste)."""

    name = DEVICE

    def __init__(self, workers: list):
        if not workers:
            raise ValueError("MultiDeviceBackend needs >= 1 worker")
        self.workers = list(workers)

    # -------------------------------------------------- engine plumbing
    def bind(self, reply_to, is_cancelled) -> None:
        for w in self.workers:
            w.bind(reply_to, is_cancelled)

    def submit(self, entity) -> None:
        self._least_loaded().submit(entity)

    def _least_loaded(self):
        return min(self.workers,
                   key=lambda w: (w.ledger.backlog_s(), w.pending()))

    def pending(self) -> int:
        return sum(w.pending() for w in self.workers)

    def shutdown(self, timeout: float = 5.0) -> None:
        for w in self.workers:
            w.shutdown(timeout)

    @property
    def fault_injector(self):
        return self.workers[0].fault_injector

    @fault_injector.setter
    def fault_injector(self, fi) -> None:
        # all workers share one injector: their draws interleave on the
        # single "backend:device" site stream in submission order
        for w in self.workers:
            w.fault_injector = fi

    # --------------------------------------------------- Backend protocol
    def can_run(self, op) -> bool:
        return self.workers[0].can_run(op)

    def estimate(self, op, payload_bytes: int) -> float:
        return min(w.estimate(op, payload_bytes) for w in self.workers)

    @property
    def resident_capable(self) -> bool:
        return self.workers[0].resident_capable

    def estimate_resident(self, op, payload_bytes: int) -> float:
        return min(w.estimate_resident(op, payload_bytes)
                   for w in self.workers)

    def queue_depth(self) -> int:
        return sum(w.queue_depth() for w in self.workers)

    def note_placed(self, op) -> None:
        self._least_loaded().note_placed(op)

    def stats(self) -> dict:
        per = [w.stats() for w in self.workers]
        agg = {"device": f"multi({len(per)})",
               "platform": per[0]["platform"],
               "calibrated": all(p["calibrated"] for p in per)}
        for key in ("groups_run", "entities_run", "ops_run",
                    "fused_segments", "errors", "cancelled_dropped",
                    "pending", "compiles", "jit_entries", "jit_evictions",
                    "h2d_bytes", "d2h_bytes"):
            agg[key] = sum(p[key] for p in per)
        agg["jit_cache_cap"] = sum(p["jit_cache_cap"] for p in per)
        stacked = sum(w.stacked_rows + w.pad_rows for w in self.workers)
        agg["padding_waste_frac"] = (
            sum(w.pad_rows for w in self.workers) / stacked
            if stacked else 0.0)
        agg["trace"] = self.trace_stats()
        agg["per_device"] = per
        return agg

    def trace_stats(self) -> dict:
        """The engine's spans and counters (one recorder for every
        worker), ``device.mallocs`` summed over the distinct CUDA
        devices."""
        snap = self.workers[0].spans.snapshot()
        allocs = {str(w.device): w.device_allocs() for w in self.workers}
        if any(a is not None for a in allocs.values()):
            snap["counters"]["device.mallocs"] = sum(
                a for a in allocs.values() if a is not None)
        return snap
