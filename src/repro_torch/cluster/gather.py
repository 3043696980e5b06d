"""Cluster scatter/gather: one client query fanned across shards.

A :class:`ClusterQuery` is the cluster-level twin of
``repro_torch.core.session.QuerySession`` — the same phase barriers
(``repro_torch.query.planner.group_phases``: consecutive Finds concurrent,
each Add a solo barrier), driven by shard sub-query futures instead of
entity completions:

    submit -> phase launch (scatter: one *piece* per (command, shard))
           -> piece completions (shard done-callbacks)
           -> all pieces settled? next phase : assemble -> done

**Scatter.**  A Find command becomes one piece per live shard, each
constrained to ``_owner == sid`` — every entity is stored with its
primary's shard id, so the scatter partitions the key space exactly
(replica copies carry the *primary's* tag and stay invisible until a
failover asks for them).  An Add command becomes one piece per replica
holder (``ring.owners(eid, replica_factor)``), every copy tagged with
the primary's sid.

**Gather.**  Piece results stream in arrival order: per-entity
callbacks fire as shards finish (deduped on ``(command, eid)`` so a
replicated Add streams once), and sub-responses merge into a per-command
pool as they land.  Assembly at the end is deterministic regardless of
arrival order — (command order x sorted-eid order, limit-trimmed), the
same rule a single engine applies — so a 1-shard cluster's response is
byte-identical to a plain engine's.

**Failover.**  A piece that dies on a shard the cluster now considers
dead (killed, or its circuit breaker opened) is re-driven instead of
failing the query: an Add re-targets the next distinct live owner on
the ring; a Find broadcasts the dead shard's ``_owner`` range to the
live shards, which is exactly where the ring placed its replicas.  With
``replica_factor=1`` there is no surviving copy, so the query fails
with :class:`~repro_torch.distributed.fault.ShardLostError` — loudly, never
a hang.  Overload and permanent errors propagate unchanged: admission
shedding is back-pressure, not ill health.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import CancelledError
from typing import Any, Callable, Optional

from repro_torch.distributed.fault import PermanentError, ShardLostError
from repro_torch.query.admission import OverloadError
from repro_torch.query.planner import group_phases

_RUNNING, _DONE, _CANCELLED = "running", "done", "cancelled"

#: reserved property key: every stored copy carries its primary's shard
#: id here; the scatter filters on it, replication hides behind it
OWNER_PROP = "_owner"


class _Piece:
    """One shard sub-query: a single command scoped to one shard's slice
    of the key space."""

    __slots__ = ("cmd_index", "name", "body", "owner_sid", "shard_sid",
                 "is_add", "fut")

    def __init__(self, cmd_index: int, name: str, body: dict,
                 owner_sid, shard_sid, is_add: bool = False):
        self.cmd_index = cmd_index
        self.name = name               # original command name (AddImage...)
        self.body = body               # shard-scoped command body
        self.owner_sid = owner_sid     # whose key range this piece covers
        self.shard_sid = shard_sid     # which shard actually runs it
        self.is_add = is_add
        self.fut = None                # shard QueryFuture once submitted


class ClusterQuery:
    """Per-query scatter/gather state machine (see module docstring)."""

    def __init__(self, qid: str, raw_cmds: list[tuple[str, dict]],
                 cmds, engine,
                 on_entity: Optional[Callable] = None,
                 use_cache: bool = True, priority: int = 0,
                 timeout_s: Optional[float] = None, tenant: str = ""):
        self.qid = qid
        self._raw = raw_cmds           # [(name, body)] in command order
        self._cmds = cmds              # parsed Commands (validation + verbs)
        self._engine = engine
        self._on_entity = on_entity
        self.use_cache = use_cache
        self.priority = priority
        self.tenant = tenant           # forwarded to every shard submit
        self._deadline = (time.monotonic() + timeout_s
                          if timeout_s is not None else None)
        self._cv = threading.Condition()
        self._state = _RUNNING               # guarded-by: _cv
        self._phases = group_phases(cmds)
        self._phase = -1
        self._outstanding = 0                # guarded-by: _cv
        self._live: set[_Piece] = set()      # not yet settled  # guarded-by: _cv
        self._issued: set[tuple] = set()     # scatter dedup  # guarded-by: _cv
        self._collected: dict[int, dict[str, Any]] = {
            i: {} for i in range(len(cmds))}                 # guarded-by: _cv
        self._streamed: set[tuple] = set()   # streamed once  # guarded-by: _cv
        self._add_state: dict[int, dict] = {}                # guarded-by: _cv
        self.stats: dict[str, Any] = \
            {"matched": 0, "failed": 0}                      # guarded-by: _cv
        if engine._shards_have_cache:
            self.stats["cache_full_hits"] = 0
            self.stats["cache_prefix_hits"] = 0
        self._t0 = time.monotonic()
        self._result: dict | None = None                     # guarded-by: _cv
        self._exc: BaseException | None = None               # guarded-by: _cv
        self._done_cbs: list[Callable[[], None]] = []        # guarded-by: _cv

    # ------------------------------------------------------------- drive
    def start(self):
        self._advance(0)

    def _advance(self, phase_idx: int):
        """Launch phase ``phase_idx``.  Phase 0 runs on the submitting
        thread; later phases on fresh daemon threads (a scatter expands
        on every shard — it must not run on the shard callback thread
        that delivered the previous barrier's last completion)."""
        try:
            if phase_idx >= len(self._phases):
                self._finish()
                return
            with self._cv:
                if self._state is not _RUNNING:
                    return
                self._phase = phase_idx
                pieces = self._build_phase_locked(phase_idx)
                self._outstanding = len(pieces)
            for piece in pieces:
                self._submit(piece)
        except Exception as e:  # noqa: BLE001 — surface via the future
            self._fail(e)

    def _advance_async(self, phase_idx: int):
        if phase_idx >= len(self._phases):
            self._finish()           # assembly is cheap; finish inline
            return
        threading.Thread(target=self._advance, args=(phase_idx,),
                         name=f"cluster-{self.qid}-phase{phase_idx}",
                         daemon=True).start()

    # ----------------------------------------------------------- scatter
    def _build_phase_locked(self, phase_idx: int) -> list[_Piece]:
        eng = self._engine
        live = eng.live_shards()
        if not live:
            raise ShardLostError(
                f"query {self.qid}: no live shards to scatter phase "
                f"{phase_idx} onto")
        dead = eng.dead_shards()
        pieces: list[_Piece] = []
        for i in self._phases[phase_idx]:
            name, body = self._raw[i]
            if self._cmds[i].verb == "add":
                eid = eng._assign_eid(self._cmds[i].kind)
                owners = [s for s in eng.owner_preference(eid)
                          if s in live][:eng.replica_factor]
                primary = owners[0]
                self._add_state[i] = {"eid": eid, "primary": primary,
                                      "tried": set(owners),
                                      "inflight": len(owners),
                                      "succeeded": 0}
                shard_body = dict(body)
                shard_body["properties"] = {
                    **body.get("properties", {}), OWNER_PROP: primary}
                shard_body["eid"] = eid
                for s in owners:
                    pieces.append(_Piece(i, name, shard_body, primary, s,
                                         is_add=True))
            else:
                for s in live:
                    pieces.append(_Piece(i, name,
                                         self._scoped_find(body, s), s, s))
                if eng.replica_factor > 1:
                    # a shard already known dead never receives a piece;
                    # its key range is served by the replicas the ring
                    # placed on the survivors
                    for d in dead:
                        for r in live:
                            pieces.append(_Piece(
                                i, name, self._scoped_find(body, d), d, r))
        for p in pieces:
            self._issued.add((p.cmd_index, p.owner_sid, p.shard_sid))
        return pieces

    @staticmethod
    def _scoped_find(body: dict, owner_sid) -> dict:
        scoped = dict(body)
        scoped["constraints"] = {**body.get("constraints", {}),
                                 OWNER_PROP: ["==", owner_sid]}
        return scoped

    def _submit(self, piece: _Piece):
        eng = self._engine
        with self._cv:
            if self._state is not _RUNNING:
                return
        remaining = None
        if self._deadline is not None:
            remaining = max(self._deadline - time.monotonic(), 1e-3)
        try:
            fut = eng._shard_submit(
                piece.shard_sid, [{piece.name: piece.body}],
                on_entity=self._make_stream(piece),
                cache=self.use_cache, priority=self.priority,
                timeout_s=remaining, tenant=self.tenant)
        except Exception as e:  # noqa: BLE001 — classified below
            self._piece_failed(piece, e)
            return
        piece.fut = fut
        cancel_now = False
        with self._cv:
            if self._state is _RUNNING:
                self._live.add(piece)
            else:
                cancel_now = True     # client cancel raced the scatter
        if cancel_now:
            fut.cancel()
            return
        fut.add_done_callback(lambda f, p=piece: self._piece_done(p))

    # ------------------------------------------------------------ gather
    def _make_stream(self, piece: _Piece):
        if self._on_entity is None:
            return None

        def stream(ent):
            key = (piece.cmd_index, ent.eid)
            with self._cv:
                if key in self._streamed:
                    return            # replica copy of an Add: stream once
                self._streamed.add(key)
            try:
                self._on_entity(ent)
            except Exception:  # noqa: BLE001 — client callback, never fatal
                pass
        return stream

    def _piece_done(self, piece: _Piece):
        status, payload = piece.fut.outcome()
        if status != "done":
            self._piece_failed(
                piece,
                payload if status == "error" else
                CancelledError(f"shard {piece.shard_sid} dropped "
                               f"sub-query of {self.qid}"))
            return
        with self._cv:
            if self._state is not _RUNNING:
                return
            self._live.discard(piece)
            pool = self._collected[piece.cmd_index]
            for eid, data in payload["entities"].items():
                # first arrival wins: replica re-drives under
                # replica_factor > 2 can overlap holder sets
                pool.setdefault(eid, data)
            sub = payload["stats"]
            self.stats["failed"] += sub.get("failed", 0)
            for key in ("cache_full_hits", "cache_prefix_hits"):
                if key in self.stats:
                    self.stats[key] += sub.get(key, 0)
            if piece.is_add:
                st = self._add_state[piece.cmd_index]
                st["inflight"] -= 1
                st["succeeded"] += 1
            advance = self._settle_locked()
        self._engine._note_shard_ok(piece.shard_sid)
        if advance:
            self._advance_async(self._phase + 1)

    def _piece_failed(self, piece: _Piece, exc: BaseException):
        eng = self._engine
        redrive: list[_Piece] = []
        fail: BaseException | None = None
        advance = False
        with self._cv:
            if self._state is not _RUNNING:
                return
            self._live.discard(piece)
            if isinstance(exc, (OverloadError, PermanentError)):
                # back-pressure / the query's own fault: not ill health,
                # no failover — the caller must see it unchanged
                fail = exc
            else:
                eng._note_shard_failure(piece.shard_sid)
                if not eng.shard_dead(piece.shard_sid):
                    # a healthy shard genuinely erred (bad op, store
                    # failure): surface it, exactly like a plain engine
                    fail = exc
                elif piece.is_add:
                    st = self._add_state[piece.cmd_index]
                    st["inflight"] -= 1
                    nxt = eng.next_owner(st["eid"], exclude=st["tried"])
                    if nxt is not None:
                        st["tried"].add(nxt)
                        st["inflight"] += 1
                        eng._note_failover(piece.shard_sid)
                        p2 = _Piece(piece.cmd_index, piece.name, piece.body,
                                    piece.owner_sid, nxt, is_add=True)
                        self._issued.add((p2.cmd_index, p2.owner_sid, nxt))
                        redrive.append(p2)
                        self._outstanding += 1
                    elif st["inflight"] == 0 and st["succeeded"] == 0:
                        # every holder candidate tried and none landed a
                        # copy: the barrier can never be satisfied
                        fail = ShardLostError(
                            f"query {self.qid}: no live shard could "
                            f"ingest {st['eid']}")
                elif eng.replica_factor > 1:
                    eng._note_failover(piece.shard_sid)
                    for r in eng.live_shards():
                        key = (piece.cmd_index, piece.owner_sid, r)
                        if key in self._issued:
                            continue   # that holder already ran this range
                        self._issued.add(key)
                        redrive.append(_Piece(piece.cmd_index, piece.name,
                                              piece.body, piece.owner_sid,
                                              r))
                        self._outstanding += 1
                else:
                    fail = ShardLostError(
                        f"query {self.qid}: shard {piece.shard_sid} lost "
                        f"with replica_factor=1 (no replica to re-drive "
                        f"its entities on); original error: "
                        f"{type(exc).__name__}: {exc}")
            if fail is None:
                advance = self._settle_locked()
        if fail is not None:
            self._fail(fail)
            return
        for p in redrive:
            self._submit(p)
        if advance:
            self._advance_async(self._phase + 1)

    def _settle_locked(self) -> bool:
        self._outstanding -= 1
        return self._outstanding == 0

    # ------------------------------------------------------- terminal ops
    def _finish(self):
        with self._cv:
            if self._state is not _RUNNING:
                return
            entities: dict[str, Any] = {}
            for i, cmd in enumerate(self._cmds):
                pool = self._collected[i]
                eids = sorted(pool)
                if cmd.verb == "find":
                    # per-shard limits returned each shard's sorted head,
                    # so the union's sorted head IS the global head
                    if cmd.limit:
                        eids = eids[: cmd.limit]
                    self.stats["matched"] += len(eids)
                for eid in eids:
                    entities[eid] = pool[eid]
            self.stats["duration_s"] = time.monotonic() - self._t0
            self._result = {"entities": entities, "stats": self.stats}
            self._state = _DONE
            self._cv.notify_all()
            cbs = list(self._done_cbs)
        self._engine._query_finished(self.qid)
        self._fire(cbs)

    def _fail(self, exc: BaseException):
        with self._cv:
            if self._state is not _RUNNING:
                return
            self._exc = exc
            self._state = _DONE
            self._cv.notify_all()
            cbs = list(self._done_cbs)
            live = list(self._live)
            self._live.clear()
        for piece in live:            # drop surviving siblings' work
            if piece.fut is not None:
                piece.fut.cancel()
        self._engine._query_finished(self.qid)
        self._fire(cbs)

    def cancel(self) -> bool:
        with self._cv:
            if self._state is _DONE:
                return False
            already = self._state is _CANCELLED
            self._state = _CANCELLED
            self._cv.notify_all()
            cbs = [] if already else list(self._done_cbs)
            live = list(self._live)
            self._live.clear()
        if not already:
            for piece in live:        # drop every shard's queued/in-flight
                if piece.fut is not None:
                    piece.fut.cancel()
            self._engine._query_finished(self.qid)
            self._fire(cbs)
        return True

    @staticmethod
    def _fire(cbs):
        for cb in cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001 — client callback
                pass

    # -------------------------------------------------------------- waits
    def wait(self, timeout: float | None = None) -> bool:
        with self._cv:
            return self._cv.wait_for(
                lambda: self._state is not _RUNNING, timeout)

    def result(self, timeout: float | None = None) -> dict:
        if not self.wait(timeout):
            raise TimeoutError(f"query {self.qid} timed out")
        with self._cv:
            state, exc, result = self._state, self._exc, self._result
        if state is _CANCELLED:
            raise CancelledError(f"query {self.qid} cancelled")
        if exc is not None:
            raise exc
        return result

    def outcome(self) -> tuple[str, Any]:
        with self._cv:
            if self._state is _RUNNING:
                return ("running", None)
            if self._state is _CANCELLED:
                return ("cancelled", None)
            if self._exc is not None:
                return ("error", self._exc)
            return ("done", self._result)

    def sync_overload(self) -> Optional[OverloadError]:
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
        with self._cv:
            return self._state

    @property
    def is_cancelled(self) -> bool:
        with self._cv:
            return self._state is _CANCELLED


class ClusterFuture:
    """Handle to an in-flight cluster query — the same surface as
    :class:`repro_torch.core.session.QueryFuture`, so a ``ShardedEngine`` is a
    drop-in behind existing callers."""

    def __init__(self, query: ClusterQuery):
        self._query = query

    @property
    def query_id(self) -> str:
        return self._query.qid

    def result(self, timeout: float | None = None) -> dict:
        return self._query.result(timeout)

    def done(self) -> bool:
        return self._query.state is not _RUNNING

    def cancelled(self) -> bool:
        return self._query.is_cancelled

    def cancel(self) -> bool:
        return self._query.cancel()

    def exception(self, timeout: float | None = None) -> BaseException | None:
        if not self._query.wait(timeout):
            raise TimeoutError(f"query {self.query_id} timed out")
        if self._query.is_cancelled:
            raise CancelledError(f"query {self.query_id} cancelled")
        return self._query._exc

    def outcome(self) -> tuple[str, Any]:
        return self._query.outcome()

    def add_done_callback(self, fn: Callable[["ClusterFuture"], None]):
        self._query.add_done_callback(lambda: fn(self))

    def stats(self) -> dict:
        """Live stats snapshot (failed/cache counters accumulate as
        shard sub-responses land; matched is final at completion)."""
        return dict(self._query.stats)
