"""ShardedEngine: N ``VDMSAsyncEngine`` shards behind one session API.

The paper scales the *remote op pool*; this layer scales the **engine
itself** — metadata store, blob store, result cache, admission ledger
and event loop all partition with their shard (the VDMS deployment
model: independent server instances, data partitioned across them).
``submit()`` returns one
:class:`~repro_torch.cluster.gather.ClusterFuture` and ``execute()``
stays the thin blocking wrapper, so every existing caller pattern works
against a cluster unchanged.

Devices: every shard is a port ``VDMSAsyncEngine`` built from the same
keyword arguments, so ``device`` (the CUDA card by default),
``device_backend`` and the rest reach every shard as they are.  This
departs from the paper's deployment, one server per shard: on one host
with one card, N shards share that card, its default stream and its
caching allocator, and each shard's device backend runs its own worker
over its own share of the entities.  Killing a shard
(:meth:`ShardedEngine.kill_shard`) shuts its engine down, which joins
that shard's threads and synchronises or frees nothing the live shards
share.  Blobs stay host arrays (``repro_torch.core.boundary``), so a
rebalance copies numpy arrays between shard stores.

Placement is a consistent-hash ring over entity ids
(:class:`~repro_torch.cluster.ring.HashRing`, ``virtual_nodes`` per
shard).
Entity ids are assigned HERE — one cluster-level counter producing the
same ``"{kind}-{n}"`` sequence a single store would — so a
``num_shards=1`` cluster is byte-identical to a plain engine, response
dicts included.  Every stored copy carries its primary's shard id in
the reserved ``_owner`` property; the scatter filters on it (see
``repro_torch.cluster.gather``).

Health & failover: each shard gets a circuit breaker in a
:class:`~repro_torch.query.health.HealthRegistry`.  ``kill_shard`` (or a
breaker opened by repeated sub-query failures, when replicas exist)
marks a shard dead; queries in flight re-drive the dead shard's pieces
on the replica holders with ``replica_factor >= 2``, and fail loudly
with :class:`~repro_torch.distributed.fault.ShardLostError` at
``replica_factor=1``.

Elasticity: ``add_shard()`` / ``remove_shard()`` go through
``ring.rebalance()`` — only the key ranges adjacent to the changed
shard move, planned by
:func:`repro_torch.distributed.elastic.migration_moves` and executed
through the ordinary Add path.  ``cluster_stats()`` exposes per-shard
ownership, imbalance, failover counts, and breaker states.
"""
from __future__ import annotations

import itertools
import threading
from typing import Callable, Optional

from repro_torch.cluster.gather import (OWNER_PROP, ClusterFuture,
                                        ClusterQuery)
from repro_torch.cluster.ring import HashRing
from repro_torch.core.engine import VDMSAsyncEngine
from repro_torch.distributed.elastic import migration_moves
from repro_torch.distributed.fault import ShardLostError
from repro_torch.query.health import HealthRegistry
from repro_torch.query.language import parse_query


class ShardedEngine:
    """A cluster of ``VDMSAsyncEngine`` shards behind the session API.

    Knobs: ``num_shards`` (ring members at construction),
    ``replica_factor`` (copies per entity; 1 = no replication,
    byte-identical single-shard semantics), ``virtual_nodes`` (ring
    points per shard — more vnodes, tighter balance), plus breaker
    parameters (``breaker_*``) for the per-shard health machines.  All
    remaining keyword arguments are forwarded verbatim to every shard's
    ``VDMSAsyncEngine`` constructor."""

    def __init__(self, *, num_shards: int = 2, replica_factor: int = 1,
                 virtual_nodes: int = 64,
                 breaker_failure_threshold: float = 0.5,
                 breaker_min_samples: int = 5,
                 breaker_open_s: float = 1.0,
                 **engine_kwargs):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards!r}")
        if not 1 <= replica_factor <= num_shards:
            raise ValueError(
                f"replica_factor must be in [1, num_shards={num_shards}], "
                f"got {replica_factor!r} (a replica needs a distinct "
                f"shard to live on)")
        self.replica_factor = replica_factor
        self._engine_kwargs = dict(engine_kwargs)
        self._shards_have_cache = engine_kwargs.get("cache_capacity", 0) > 0
        self.ring = HashRing(range(num_shards), virtual_nodes=virtual_nodes)
        # shards stay in this dict after death so stats remain readable;
        # routing consults _dead + the breakers, never dict membership
        self.shards: dict[int, VDMSAsyncEngine] = {
            sid: VDMSAsyncEngine(**engine_kwargs)
            for sid in range(num_shards)}
        self.health = HealthRegistry(
            [self._bname(sid) for sid in self.shards],
            never_open=(),
            failure_threshold=breaker_failure_threshold,
            min_samples=breaker_min_samples,
            open_s=breaker_open_s)
        self._lock = threading.Lock()
        self._dead: set[int] = set()
        self._eids: dict[str, str] = {}      # eid -> kind (migration reads)
        self._eid_counter = itertools.count()
        self._qid = itertools.count()
        self._queries: dict[str, ClusterQuery] = {}
        self._failovers: dict[int, int] = {}
        self._moved_entities = 0
        self._next_sid = num_shards
        self._shut = False

    @staticmethod
    def _bname(sid) -> str:
        return f"shard:{sid}"

    # ------------------------------------------------------------ ingest
    def _assign_eid(self, kind: str) -> str:
        eid = f"{kind}-{next(self._eid_counter)}"
        with self._lock:
            self._eids[eid] = kind
        return eid

    def add_entity(self, kind: str, data, properties: dict) -> str:
        """Ingest one entity: id assigned at the cluster level, copies
        placed on the first ``replica_factor`` live ring owners, every
        copy tagged with the primary's shard id."""
        if self._shut:
            raise RuntimeError("engine is shut down")
        eid = self._assign_eid(kind)
        live = self.live_shards()
        owners = [s for s in self.owner_preference(eid)
                  if s in live][: self.replica_factor]
        if not owners:
            raise ShardLostError(f"no live shard to ingest {eid}")
        props = {**properties, OWNER_PROP: owners[0]}
        for sid in owners:
            self.shards[sid].add_entity(kind, data, props, eid=eid)
        return eid

    # ------------------------------------------------------------- query
    def submit(self, query, *,
               on_entity: Optional[Callable] = None,
               cache: bool = True, priority: int = 0,
               timeout_s: Optional[float] = None,
               tenant: str = "") -> ClusterFuture:
        """Submit a VDMS JSON query against the cluster; same contract
        as ``VDMSAsyncEngine.submit`` (future, streaming callbacks,
        cache opt-out, priority, deadline, admission tenant) with the
        scatter/gather and failover semantics of
        ``repro_torch.cluster.gather``."""
        if self._shut:
            raise RuntimeError("engine is shut down")
        cmds = parse_query(query)            # validate before any scatter
        raw_items = [query] if isinstance(query, dict) else list(query)
        raw = []
        for item in raw_items:
            (name, body), = item.items()
            raw.append((name, body))
        qid = str(next(self._qid))
        cq = ClusterQuery(qid, raw, cmds, self, on_entity=on_entity,
                          use_cache=cache, priority=priority,
                          timeout_s=timeout_s, tenant=tenant)
        fut = ClusterFuture(cq)
        with self._lock:
            if self._shut:
                raise RuntimeError("engine is shut down")
            self._queries[qid] = cq
        cq.start()
        exc = cq.sync_overload()
        if exc is not None:
            # same fail-fast contract as the single engine: a shard shed
            # the scatter synchronously, nothing of the query survives
            raise exc
        return fut

    def execute(self, query, timeout: float | None = None, *,
                cache: bool = True) -> dict:
        fut = self.submit(query, cache=cache, timeout_s=timeout)
        try:
            return fut.result(timeout)
        except TimeoutError:
            fut.cancel()                 # drop every shard's work
            raise

    # --------------------------------------------------- gather plumbing
    def _shard_submit(self, sid: int, query, **kw):
        return self.shards[sid].submit(query, **kw)

    def _query_finished(self, qid: str):
        with self._lock:
            self._queries.pop(qid, None)

    def owner_preference(self, eid: str) -> list[int]:
        """Every ring member in this eid's owner-preference order."""
        return self.ring.owners(eid, self.ring.shard_count())

    def next_owner(self, eid: str, exclude) -> int | None:
        """First live shard in ring preference order not in ``exclude``
        — the Add failover target after a holder died mid-ingest."""
        live = self.live_shards()
        for sid in self.owner_preference(eid):
            if sid in live and sid not in exclude:
                return sid
        return None

    # ------------------------------------------------------------ health
    def shard_dead(self, sid: int) -> bool:
        """Killed explicitly, or — only when replicas exist to serve its
        range — marked dead by its breaker.  At ``replica_factor=1`` an
        open breaker stays advisory: skipping the shard would silently
        drop its key range, and a loud per-query error is strictly
        better than quietly incomplete results."""
        if sid in self._dead:
            return True
        if self.replica_factor < 2:
            return False
        b = self.health.get(self._bname(sid))
        return b is not None and not b.routable()

    def live_shards(self) -> list[int]:
        return sorted(s for s in self.shards if not self.shard_dead(s))

    def dead_shards(self) -> list[int]:
        return sorted(s for s in self.shards if self.shard_dead(s))

    def _note_shard_ok(self, sid: int):
        self.health.record_success(self._bname(sid))

    def _note_shard_failure(self, sid: int):
        self.health.record_failure(self._bname(sid))

    def _note_failover(self, sid: int):
        with self._lock:
            self._failovers[sid] = self._failovers.get(sid, 0) + 1

    def kill_shard(self, sid: int):
        """Hard-kill one shard (fault injection / ungraceful death): its
        engine shuts down mid-flight; in-flight pieces re-drive on the
        replica holders (``replica_factor >= 2``) or fail loudly."""
        if sid not in self.shards:
            raise ValueError(f"unknown shard {sid!r}")
        with self._lock:
            self._dead.add(sid)       # marked dead BEFORE the teardown:
        # pieces cancelled by the shutdown classify as failover, not error
        self.shards[sid].shutdown()

    # --------------------------------------------------------- elasticity
    def add_shard(self) -> int:
        """Join a fresh shard: ring rebalance + minimal migration via
        the ordinary Add path.  Returns the new shard id."""
        if self._shut:
            raise RuntimeError("engine is shut down")
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        self.shards[sid] = VDMSAsyncEngine(**self._engine_kwargs)
        self.health.register(self._bname(sid))
        delta = self.ring.rebalance(add=sid)
        self._migrate(delta)
        return sid

    def remove_shard(self, sid: int):
        """Graceful leave: migrate this shard's ranges to the survivors
        (reading from it while it still serves), then shut it down.  A
        dead shard cannot leave gracefully — its ranges already live on
        the replicas, so just leave it killed."""
        if sid not in self.shards:
            raise ValueError(f"unknown shard {sid!r}")
        if sid in self._dead:
            raise ValueError(
                f"shard {sid!r} is dead; graceful removal reads from the "
                f"leaving shard (its replicas already serve its range)")
        if len(self.shards) - 1 < self.replica_factor:
            raise ValueError(
                f"cannot drop below replica_factor={self.replica_factor} "
                f"shards")
        delta = self.ring.rebalance(remove=sid)
        self._migrate(delta)
        eng = self.shards.pop(sid)
        self.health.remove(self._bname(sid))
        with self._lock:
            self._dead.discard(sid)
        eng.shutdown()

    def _migrate(self, delta):
        """Execute a rebalance plan: copy each moved key from a
        surviving holder to its new owners (the existing Add path, so
        ingest invariants hold), re-tag primaries, drop shed copies."""
        rf = self.replica_factor
        with self._lock:
            eids = dict(self._eids)
        moves = migration_moves(
            eids, lambda k: delta.old_owners(k, rf),
            lambda k: delta.new_owners(k, rf))
        moved = 0
        for mv in moves:
            src = next((s for s in delta.old_owners(mv.key, rf)
                        if s in self.shards and s not in self._dead
                        and mv.key in self.shards[s].store), None)
            if src is None:
                continue               # no surviving copy to read from
            holder = self.shards[src]
            data = holder.store.get(mv.key)
            props = holder.meta.get(mv.key)
            props[OWNER_PROP] = mv.new_primary
            for sid in mv.copy_to:
                self.shards[sid].add_entity(eids[mv.key], data, props,
                                            eid=mv.key)
                moved += 1
            if mv.primary_changed:
                for sid in delta.new_owners(mv.key, rf):
                    if sid not in mv.copy_to and sid in self.shards:
                        self.shards[sid].meta.update(
                            mv.key, {OWNER_PROP: mv.new_primary})
            for sid in mv.drop_from:
                if sid not in self.shards:
                    continue
                shard = self.shards[sid]
                shard.meta.remove(mv.key)
                shard.store.delete(mv.key)
                if shard.result_cache is not None:
                    shard.result_cache.invalidate(mv.key)
        with self._lock:
            self._moved_entities += moved

    # ------------------------------------------------------------- stats
    def cluster_stats(self) -> dict:
        """Per-shard ownership/holding, imbalance (max/mean primary
        ownership over live shards), failover counts, migration volume,
        and breaker states."""
        with self._lock:
            eids = list(self._eids)
            failovers = dict(self._failovers)
            moved = self._moved_entities
        owned = self.ring.ownership(eids, n=1)
        live = set(self.live_shards())
        per_shard = {}
        for sid, eng in sorted(self.shards.items()):
            per_shard[sid] = {
                "live": sid in live,
                "owned": owned.get(sid, 0),
                "held": eng.meta.count(),
            }
        live_counts = [per_shard[s]["owned"] for s in sorted(live)]
        mean = sum(live_counts) / len(live_counts) if live_counts else 0.0
        imbalance = (max(live_counts) / mean
                     if live_counts and mean > 0 else 1.0)
        return {
            "num_shards": len(self.shards),
            "live_shards": sorted(live),
            "replica_factor": self.replica_factor,
            "virtual_nodes": self.ring.virtual_nodes,
            "entities": len(eids),
            "per_shard": per_shard,
            "imbalance": imbalance,
            "failovers": failovers,
            "failovers_total": sum(failovers.values()),
            "moved_entities": moved,
            "breakers": self.health.stats(),
        }

    def admission_stats(self) -> dict:
        """Per-shard admission ledgers (leak checks sum across shards)."""
        return {sid: eng.admission_stats()
                for sid, eng in sorted(self.shards.items())}

    def active_queries(self) -> int:
        with self._lock:
            return len(self._queries)

    # ---------------------------------------------------------- teardown
    def shutdown(self):
        """Deterministic teardown: refuse new submits, cancel live
        cluster queries (their shard pieces drop everywhere), then shut
        every shard.  Idempotent."""
        with self._lock:
            self._shut = True
            live = list(self._queries.values())
        for cq in live:
            cq.cancel()
        for sid, eng in list(self.shards.items()):
            if sid not in self._dead:
                eng.shutdown()
