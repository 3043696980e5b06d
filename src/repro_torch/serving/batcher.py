"""Batched model-UDF serving: iteration-level grouped batching.

The query engine's Thread_3 hands entities to model UDFs; running
prefill+decode per entity wastes the card.  The ``GroupBatcher``
coalesces queued requests into groups (by prompt length, so the cache
write offsets stay uniform — the decode step takes one scalar
cache_index), prefill runs once per group, and one ``decode_step``
advances every sequence in the group per iteration.  Requests that hit
EOS/max_tokens are marked done immediately (their slots idle until the
group drains, then the next group is admitted — iteration-level, not
token-level, admission).

``UDFBatcherBackend`` promotes this layer to a first-class *dispatch
backend* behind the common ``repro_torch.query.dispatch.Backend``
protocol: ops with a registered batched variant
(``register_batched_udf`` — model UDFs register one built on a
GroupBatcher) become routable, the router's cost model amortizes the op
estimate over the group size, and group results hand back to the engine
through the existing Thread_3 reply path (a ``("batched", entity,
result, err)`` message on Queue_2).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models.registry import ModelAPI, token_start
from repro_torch.query.dispatch import OFFLOAD_STOP, OffloadInboxMixin
from repro_torch.serving.serve_step import sample_token


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (prompt_len,)
    max_new: int = 16
    eos_id: int = -1              # -1: never
    out: list = dataclasses.field(default_factory=list)
    done_event: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def result(self, timeout=None) -> np.ndarray:
        if not self.done_event.wait(timeout):
            raise TimeoutError(f"request {self.rid} timed out")
        return np.asarray(self.out, np.int32)

    def done(self) -> bool:
        # mirrors the engine's QueryFuture polling API
        return self.done_event.is_set()


class GroupBatcher:
    """Groups same-length prompts and serves each group with one prefill
    and one decode step per iteration, on the device the parameters
    live on."""

    def __init__(self, model: ModelAPI, params, *, group_size: int = 8,
                 max_new_default: int = 16, sh: ShardingCtx | None = None,
                 temperature: float = 0.0, cache_dtype=torch.float32):
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.sh = sh or ShardingCtx(mesh=None)
        self.group_size = group_size
        self.max_new_default = max_new_default
        self.temperature = temperature
        self.cache_dtype = cache_dtype
        self.waiting: "queue.Queue[Request]" = queue.Queue()
        self._rid = 0
        self._lock = threading.Lock()
        self.steps_run = 0
        self.tokens_out = 0
        self.groups_run = 0

    def submit(self, tokens, max_new: int | None = None, eos_id=-1) -> Request:
        with self._lock:
            self._rid += 1
            req = Request(self._rid, np.asarray(tokens, np.int32),
                          max_new or self.max_new_default, eos_id)
        self.waiting.put(req)
        return req

    def run_until_idle(self):
        """Serve every waiting request, group by group."""
        while True:
            group = self._next_group()
            if not group:
                return
            self._run_group(group)

    # ------------------------------------------------------------------
    def _next_group(self) -> list[Request]:
        """Pull up to group_size same-prompt-length requests."""
        leftovers = []
        group: list[Request] = []
        while len(group) < self.group_size:
            try:
                r = self.waiting.get_nowait()
            except queue.Empty:
                break
            if not group or len(r.tokens) == len(group[0].tokens):
                group.append(r)
            else:
                leftovers.append(r)
        for r in leftovers:
            self.waiting.put(r)
        return group

    def _run_group(self, group: list[Request]):
        cfg = self.model.cfg
        n = len(group)
        prompt_len = len(group[0].tokens)
        max_new = max(r.max_new for r in group)
        P = token_start(cfg)
        max_cache = P + prompt_len + max_new + 1

        toks = torch.from_numpy(np.stack([r.tokens for r in group]))
        batch = {"tokens": toks.to(self.device)}
        if P:
            batch["patch_embeds"] = torch.zeros(
                (n, P, cfg.d_model), dtype=torch.float32, device=self.device)
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.zeros(
                (n, cfg.encoder_seq_len, cfg.d_model), dtype=torch.float32,
                device=self.device)
        logits, cache = self.model.prefill(self.params, batch, self.sh,
                                           max_cache,
                                           cache_dtype=self.cache_dtype)
        live = np.ones(n, bool)
        gen = None
        if self.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(
                self.groups_run)
        tok = sample_token(logits, gen, self.temperature, cfg.vocab_size)
        for step in range(max_new):
            tok_np = tok.cpu().numpy()
            for i, r in enumerate(group):
                if not live[i]:
                    continue
                t = int(tok_np[i, 0])
                r.out.append(t)
                self.tokens_out += 1
                if t == r.eos_id or len(r.out) >= r.max_new:
                    live[i] = False
                    r.done_event.set()
            if not live.any() or step == max_new - 1:
                break
            logits, cache = self.model.decode_step(
                self.params, tok, cache, P + prompt_len + step, self.sh)
            self.steps_run += 1
            tok = sample_token(logits, gen, self.temperature, cfg.vocab_size)
        for r in group:
            r.done_event.set()
        self.groups_run += 1


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
