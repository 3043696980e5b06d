"""Asynchronous query sessions: the futures-based client API.

``VDMSAsyncEngine.submit(query)`` returns a :class:`QueryFuture`
immediately; the query's phases then run entirely on the event loop's
threads.  The session object is the per-query state machine:

    submit -> plan (compile) -> phase launch (expand + enqueue)
           -> entity completions (worker / Thread_3 callbacks)
           -> phase barrier? next phase : assemble result -> done

The blocking ``execute()`` is a thin ``submit().result(timeout)`` wrapper,
so the response dict stays byte-identical to the old inline loop: results
are assembled in (command order x matched-eid order), never in completion
order.  A finished entity's result stays a device tensor until then, and
the assembly brings every such result to the host in one call (the host
boundary's way out, :mod:`repro_torch.core.boundary`); results held past
``boundary.OUT_COPY_BYTES`` cross earlier, in one call as the entity
that reaches it finishes, so a large fan-out never holds more than that
on the device.  A failed or cancelled query brings none.

Cancellation (``future.cancel()`` or an ``execute`` timeout) marks the
session, drops its queued native work from Queue_1, and forgets its
in-flight remote requests, so nothing is orphaned in ``pool.inflight``
and no latch-like state leaks — the failure mode of the old
``_run_entities``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import CancelledError
from typing import TYPE_CHECKING, Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import boundary
from repro_torch.core.entity import Entity
from repro_torch.query.admission import OverloadError

if TYPE_CHECKING:  # avoid a core <-> query import cycle at runtime
    from repro_torch.query.planner import QueryPlan

_RUNNING, _DONE, _CANCELLED = "running", "done", "cancelled"


class QuerySession:
    """Per-query state machine driven by event-loop callbacks."""

    def __init__(self, qid: str, plan: "QueryPlan", engine: Any,
                 on_entity: Optional[Callable[[Entity], None]] = None,
                 use_cache: bool = True, priority: int = 0,
                 deadline: Optional[float] = None, tenant: str = ""):
        self.qid = qid
        self.plan = plan
        self._engine = engine
        self._on_entity = on_entity
        self.use_cache = use_cache
        self.priority = priority   # admission pending-lane ordering
        self.deadline = deadline   # monotonic; bounds remote retries
        self.tenant = tenant       # admission-v2 quota lane ("" = exempt)
        self._cv = threading.Condition()
        self._state = _RUNNING
        self._phase = -1
        self._pending = 0
        self._cmds = {cp.index: cp for phase in plan.phases for cp in phase}
        self._ent_results: dict[int, dict[str, Any]] = {
            i: {} for i in self._cmds}
        # results still on the device, and their bytes, until they cross
        self._held: list[tuple[int, str]] = []
        self._held_bytes = 0
        self.stats: dict[str, Any] = {"matched": 0, "failed": 0}
        # cache-hit stats appear only when the engine cache exists, so the
        # cache-off response dict stays byte-identical to the baseline
        if getattr(engine, "result_cache", None) is not None:
            self.stats["cache_full_hits"] = 0
            self.stats["cache_prefix_hits"] = 0
        self._t0 = time.monotonic()
        self._result: dict | None = None
        self._exc: BaseException | None = None
        self._done_cbs: list[Callable[[], None]] = []

    # ------------------------------------------------------------- drive
    def start(self):
        self._advance(0)

    def _advance(self, phase_idx: int):
        """Launch phases starting at ``phase_idx`` until one has in-flight
        work (or the plan is exhausted).  Runs on the submitting thread
        for phase 0 and on event-loop threads afterwards."""
        try:
            while True:
                if phase_idx >= len(self.plan.phases):
                    self._finish()
                    return
                # overload fast path BEFORE expansion: a saturated shed
                # engine rejects here — crucially before an Add phase's
                # ingest side effects (a no-op when uncontended or when
                # admission is off)
                self._engine._admission_precheck(
                    self.plan.phases[phase_idx], qid=self.qid,
                    first_phase=phase_idx == 0,
                    use_cache=self.use_cache, tenant=self.tenant)
                instant: list[Entity] = []   # zero-op entities: already done
                to_run: list[Entity] = []
                # Expansion runs UNDER the session lock: an Add phase
                # ingests entities, and cancel() (which also takes _cv)
                # must either stop the phase before it writes or return
                # only after the write completed — never report cancelled
                # while the barrier keeps writing behind the caller's back.
                with self._cv:
                    if self._state is not _RUNNING:
                        return
                    for cplan in self.plan.phases[phase_idx]:
                        ents = self._engine._expand_plan(cplan, self.qid,
                                                    self.use_cache)
                        if cplan.command.verb == "find":
                            self.stats["matched"] += len(ents)
                        for e in ents:
                            if e.cache_hit == "full":
                                self.stats["cache_full_hits"] += 1
                            elif e.cache_hit == "prefix":
                                self.stats["cache_prefix_hits"] += 1
                            (to_run if not e.done() else instant).append(e)
                    self._phase = phase_idx
                    self._pending = len(to_run)
                    if self.deadline is not None:
                        # retries of this query's remote work must not
                        # outlive its timeout budget
                        for e in to_run:
                            e.deadline = self.deadline
                    for e in instant:
                        self._record_locked(e)
                for e in instant:
                    self._stream(e)
                if to_run:
                    self._engine._launch(to_run, priority=self.priority,
                                         first_phase=phase_idx == 0,
                                         tenant=self.tenant)
                    return
                phase_idx += 1
        except Exception as e:  # noqa: BLE001 — surface via the future
            self._fail(e)

    def entity_done(self, ent: Entity):
        """Event-loop callback: one of this session's entities finished
        (or failed) its pipeline."""
        with self._cv:
            if self._state is not _RUNNING:
                return
            self._record_locked(ent)
            phase = self._phase
            held = self._hold_locked(ent)
        if held and not self._bring_out(held):
            return
        # stream BEFORE decrementing: _pending can only hit zero (letting
        # result() return) once every completed entity's callback fired
        self._stream(ent)
        with self._cv:
            if self._state is not _RUNNING:
                return
            self._pending -= 1
            advance = self._pending == 0
        if advance:
            if phase + 1 >= len(self.plan.phases):
                self._finish()      # assembly is cheap; finish inline
            elif all(cp.command.verb == "add"
                     for cp in self.plan.phases[phase + 1]):
                # Add-only phase: expansion is one ingest per command —
                # cheap enough to run inline, so an ingest-heavy query
                # doesn't churn one thread per Add barrier
                self._advance(phase + 1)
            else:
                # Find-phase expansion (metadata scan + blob lookups for a
                # possibly huge fan-out) must not run on the event-loop
                # thread that delivered this completion — it would stall
                # dispatch/responses for every other session.
                threading.Thread(target=self._advance, args=(phase + 1,),
                                 name=f"session-{self.qid}-phase{phase + 1}",
                                 daemon=True).start()

    # ----------------------------------------------------------- records
    def wants_host_now(self, ent: Entity) -> bool:
        """Whether ``ent``'s result must reach the host as it finishes: a
        stream hands it to the client, and an Add with operations writes
        it back to the blob store.  Any other result waits on the device
        for the query's copy (:meth:`_hold_locked`, :meth:`_finish`)."""
        command = self._cmds[ent.cmd_index].command
        return self._on_entity is not None or (
            command.verb == "add" and bool(command.operations))

    def _record_locked(self, ent: Entity):
        # old-loop semantics, kept byte-identical: only Find failures are
        # counted, and an Add with operations always persists its (possibly
        # partially processed) data back to the blob store
        cplan = self._cmds[ent.cmd_index]
        if cplan.command.verb == "add":
            if cplan.command.operations:
                try:
                    self._engine._store_result(ent)
                except Exception as e:  # noqa: BLE001 — a blob-store
                    # write-back failure must fail the ENTITY, not
                    # strand the session: this runs before _pending is
                    # decremented, and a raise here would re-raise on
                    # the worker's error-path redelivery of the same
                    # entity, so _pending would never reach zero and
                    # result() would hang forever
                    ent.failed = (f"store write-back failed: "
                                  f"{type(e).__name__}: {e}")
        elif ent.failed:
            self.stats["failed"] += 1
        self._ent_results[ent.cmd_index][ent.eid] = ent.data

    def _hold_locked(self, ent: Entity) -> list[tuple[int, str]]:
        """Note ``ent``'s result if it stays on the device; once the held
        results reach ``boundary.OUT_COPY_BYTES``, hand them back to be
        brought over now (:meth:`_bring_out`), else ``[]``."""
        if not isinstance(ent.data, torch.Tensor):
            return []
        self._held.append((ent.cmd_index, ent.eid))
        self._held_bytes += ent.data.nbytes
        if self._held_bytes < boundary.OUT_COPY_BYTES:
            return []
        held, self._held, self._held_bytes = self._held, [], 0
        return held

    def _bring_out(self, held: list[tuple[int, str]]) -> bool:
        """Bring ``held`` results to the host in one call, outside the
        lock so cancel() never waits on the copy; False when the copy
        failed the query."""
        with self._cv:
            datas = [self._ent_results[c][eid] for c, eid in held]
        try:
            arrays = self._engine._to_host_many(self.qid, datas)
        except Exception as e:  # noqa: BLE001 — surface via the future
            self._fail(e)
            return False
        with self._cv:
            for (c, eid), arr in zip(held, arrays):
                self._ent_results[c][eid] = arr
        return True

    def _stream(self, ent: Entity):
        if self._on_entity is None:
            return
        try:
            self._on_entity(ent)
        except Exception:  # noqa: BLE001 — client callback, never fatal
            pass

    @staticmethod
    def _fire(cbs):
        # done-callbacks run on event-loop threads: a raising client
        # callback must never kill Thread_3 / a native worker
        for cb in cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------- terminal ops
    def _finish(self):
        with self._cv:
            if self._state is not _RUNNING:
                return
            entities: dict[str, Any] = {}
            for phase in self.plan.phases:
                for cp in phase:
                    res = self._ent_results[cp.index]
                    for eid in cp.eids:
                        if eid in res:
                            entities[eid] = res[eid]
        # the host boundary's way out: every result not yet a host array
        # crosses in one call, outside the lock so cancel() never waits
        # on the copy
        held = [eid for eid, v in entities.items()
                if not isinstance(v, np.ndarray)]
        if held:
            try:
                entities.update(zip(held, self._engine._to_host_many(
                    self.qid, [entities[eid] for eid in held])))
            except Exception as e:  # noqa: BLE001 — surface via the future
                self._fail(e)
                return
        with self._cv:
            if self._state is not _RUNNING:
                return
            self.stats["duration_s"] = time.monotonic() - self._t0
            self._result = {"entities": entities, "stats": self.stats}
            self._state = _DONE
            self._cv.notify_all()
            cbs = list(self._done_cbs)
        self._engine._session_finished(self.qid)
        self._fire(cbs)

    def _fail(self, exc: BaseException):
        with self._cv:
            if self._state is not _RUNNING:
                return
            self._exc = exc
            self._state = _DONE
            self._cv.notify_all()
            cbs = list(self._done_cbs)
        self._engine._discard_session(self.qid)
        self._fire(cbs)

    def cancel(self) -> bool:
        with self._cv:
            if self._state is _DONE:
                return False
            already = self._state is _CANCELLED
            self._state = _CANCELLED
            self._cv.notify_all()
            cbs = [] if already else list(self._done_cbs)
        if not already:
            self._engine._discard_session(self.qid)
            self._fire(cbs)
        return True

    # -------------------------------------------------------------- waits
    def wait(self, timeout: float | None = None) -> bool:
        with self._cv:
            return self._cv.wait_for(
                lambda: self._state is not _RUNNING, timeout)

    def result(self, timeout: float | None = None) -> dict:
        if not self.wait(timeout):
            raise TimeoutError(f"query {self.qid} timed out")
        if self._state is _CANCELLED:
            raise CancelledError(f"query {self.qid} cancelled")
        if self._exc is not None:
            raise self._exc
        return self._result

    def outcome(self) -> tuple[str, Any]:
        """Non-blocking terminal-state snapshot:
        ``("done", result)`` / ``("error", exc)`` / ``("cancelled",
        None)`` / ``("running", None)``.  The cluster gather layer reads
        this from done-callbacks to classify a shard sub-query's fate
        without the raise/except round-trip of :meth:`result`."""
        with self._cv:
            if self._state is _RUNNING:
                return ("running", None)
            if self._state is _CANCELLED:
                return ("cancelled", None)
            if self._exc is not None:
                return ("error", self._exc)
            return ("done", self._result)

    def sync_overload(self) -> Optional[OverloadError]:
        """The :class:`OverloadError` this session failed with, if any —
        read by ``engine.submit()`` right after the synchronous phase-0
        launch so a shed query fails fast at the call site instead of
        only on the future."""
        with self._cv:
            exc = self._exc
        return exc if isinstance(exc, OverloadError) else None

    def add_done_callback(self, cb: Callable[[], None]):
        with self._cv:
            if self._state is _RUNNING:
                self._done_cbs.append(cb)
                return
        cb()

    @property
    def state(self) -> str:
        return self._state

    @property
    def is_cancelled(self) -> bool:
        return self._state is _CANCELLED


class QueryFuture:
    """Handle to an in-flight query session.

    ``result(timeout)`` blocks for the assembled response (raising
    ``TimeoutError`` / ``concurrent.futures.CancelledError``), ``done()``
    and ``cancelled()`` poll, ``cancel()`` drops all remaining work, and
    ``add_done_callback(fn)`` fires ``fn(future)`` on completion.
    Per-entity streaming callbacks are installed at ``submit(...,
    on_entity=fn)`` time and fire as each entity finishes its pipeline.
    """

    def __init__(self, session: QuerySession):
        self._session = session

    @property
    def query_id(self) -> str:
        return self._session.qid

    def result(self, timeout: float | None = None) -> dict:
        return self._session.result(timeout)

    def done(self) -> bool:
        return self._session.state is not _RUNNING

    def cancelled(self) -> bool:
        return self._session.is_cancelled

    def cancel(self) -> bool:
        return self._session.cancel()

    def exception(self, timeout: float | None = None) -> BaseException | None:
        if not self._session.wait(timeout):
            raise TimeoutError(f"query {self.query_id} timed out")
        if self._session.is_cancelled:
            raise CancelledError(f"query {self.query_id} cancelled")
        return self._session._exc

    def outcome(self) -> tuple[str, Any]:
        """Non-blocking ``("done", result) | ("error", exc) |
        ("cancelled", None) | ("running", None)`` snapshot."""
        return self._session.outcome()

    def add_done_callback(self, fn: Callable[["QueryFuture"], None]):
        self._session.add_done_callback(lambda: fn(self))

    def stats(self) -> dict:
        """Live stats snapshot (matched/failed so far)."""
        return dict(self._session.stats)
