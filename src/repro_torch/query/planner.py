"""Per-query planning: compile parsed ``Command``s into an explicit plan.

The engine used to interpret commands with an inline loop — one command
at a time, each blocking on its own latch.  The planner makes the query's
structure first-class instead:

- ``compile`` groups a query's commands into **phases**.  Consecutive
  ``Find`` commands form one phase and execute *concurrently* (their
  entities interleave on the native pool and remote pool); an ``Add``
  command is a barrier phase of its own, because later commands may match
  the entity it ingests (write-then-read within one query keeps the
  sequential semantics of the old loop).
- ``expand`` performs the entity fan-out for one command at phase-launch
  time: constraint filtering against the metadata store, blob-pointer
  lookup, op-pipeline attachment.  Fan-out is deferred to launch (not
  compile) so a phase sees the writes of every barrier before it.
- when the engine carries a :class:`~repro_torch.core.result_cache.ResultCache`,
  ``expand`` consults it per entity: a full ``(eid, pipeline-signature)``
  hit produces an already-``done()`` entity that skips Queue_1 entirely;
  a prefix hit re-enters the pipeline at the first uncached op.  Add
  ingestion invalidates the ingested eid (write-then-read semantics).
- when the engine carries a dispatch router
  (:class:`~repro_torch.query.dispatch.BackendRouter`, ``dispatch !=
  "static"``), ``expand`` also routes each entity's remaining op chain
  across backends — AFTER the cache lookup, so a prefix-resumed entity
  is routed from its resume op only, never for work the cache already
  paid for.  A run of consecutive ``device`` placements is a *segment*:
  with ``device_fuse_segments`` on, the event loop hands the whole run
  to the device backend as ONE unit (one fused jit program, one
  transfer each way) and the result cache snapshots only at segment
  boundaries — so a later query's prefix hit resumes at a boundary,
  never mid-segment (the intermediates never left the device; the
  router then re-prices the remaining tail from the resume point).

Result assembly stays deterministic regardless of execution order: the
plan records each command's matched-eid order, and the session assembles
the response in (command order x eid order) — byte-identical to the old
blocking loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.boundary import to_host
from repro_torch.core.entity import Entity
from repro_torch.core.result_cache import ResultCache, prefix_signatures
from repro_torch.query.language import Command
from repro_torch.query.metadata import MetadataStore
from repro_torch.storage.store import BlobStore


@dataclasses.dataclass
class CommandPlan:
    """One command's slice of the query plan.  Barrier semantics live in
    the phase structure itself: an Add command is always the sole member
    of its phase and later phases launch only after it completes."""
    index: int                 # position in the query (assembly order)
    command: Command
    # filled in by expand_plan():
    eids: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class QueryPlan:
    phases: list[list[CommandPlan]]

    @property
    def num_commands(self) -> int:
        return sum(len(p) for p in self.phases)


def group_phases(cmds: list[Command]) -> list[list[int]]:
    """Command indices grouped into barrier phases: consecutive Finds
    run concurrently, each Add is the sole member of its phase.  The
    single source of phase semantics — used by :meth:`QueryPlanner.compile`
    and by the cluster scatter (``repro_torch.cluster``), which must launch
    the SAME barriers across shards that a single engine would honor
    locally."""
    phases: list[list[int]] = []
    current: list[int] = []
    for i, cmd in enumerate(cmds):
        if cmd.verb == "add":
            if current:
                phases.append(current)
                current = []
            phases.append([i])
        else:
            current.append(i)
    if current:
        phases.append(current)
    return phases


class QueryPlanner:
    """Compiles commands to phases and expands per-command entity fan-out."""

    def __init__(self, meta: MetadataStore, store: BlobStore,
                 result_cache: ResultCache | None = None,
                 router=None):
        self.meta = meta
        self.store = store
        self.result_cache = result_cache
        self.router = router      # BackendRouter | StaticRouter | None

    # ----------------------------------------------------------- compile
    def compile(self, cmds: list[Command]) -> QueryPlan:
        return QueryPlan(phases=[
            [CommandPlan(index=i, command=cmds[i]) for i in phase]
            for phase in group_phases(cmds)])

    # ------------------------------------------------------------ ingest
    def ingest(self, kind: str, data, properties: dict,
               eid: str | None = None) -> str:
        """The single ingestion path: metadata row + blob.  Used both by
        the engine's ``add_entity`` and by Add-command expansion, so
        ingestion changes apply to each identically.  ``eid`` pins the
        entity id (cluster ingest assigns ids at the ring level so a
        1-shard cluster's ids match a plain engine's); ``None`` keeps
        the store-assigned counter id."""
        eid = self.meta.add(kind, properties, eid=eid)
        self.store.put(eid, to_host(data))
        if self.result_cache is not None:
            # Add barrier invalidation: any cached result keyed on this
            # eid predates the blob this write just installed
            self.result_cache.invalidate(eid)
        return eid

    # ---------------------------------------------------------- admission
    def estimate_fanout(self, cplans: list[CommandPlan]) -> int:
        """*Capacity-consuming* entity fan-out one phase would produce,
        without expanding it: the metadata match count per Find
        (limit-capped) and one entity per Add — crucially without the
        Add's ingest side effects, so admission control can shed a
        query before its barrier writes anything.  Commands with no
        operations contribute zero: their entities are born ``done()``
        (a metadata/blob lookup, or a plain ingest) and never occupy an
        in-flight slot, so shedding on their match count would reject
        queries that cost the engine nothing.  Only consulted off the
        uncontended hot path (saturation, or an Add barrier)."""
        n = 0
        for cp in cplans:
            cmd = cp.command
            if not cmd.operations:
                continue
            if cmd.verb == "add":
                n += 1
            else:
                eids = self.meta.find_ids(cmd.kind, cmd.constraints)
                n += len(eids[:cmd.limit]) if cmd.limit else len(eids)
        return n

    # ------------------------------------------------------------ expand
    def expand_plan(self, cplan: CommandPlan, query_id: str,
               use_cache: bool = True) -> list[Entity]:
        """Fan a command out into entities (ingesting first for Add).
        Records the matched-eid order on the plan for result assembly.
        ``use_cache=False`` (a ``submit(..., cache=False)`` query)
        bypasses the result cache for both reads and writes."""
        cmd = cplan.command
        if cmd.verb == "add":
            eids = [self.ingest(cmd.kind, cmd.data, cmd.properties,
                                eid=cmd.eid)]
        else:
            eids = self.meta.find_ids(cmd.kind, cmd.constraints)
            if cmd.limit:
                eids = eids[: cmd.limit]
        cplan.eids = eids
        rc = self.result_cache
        # only Find pipelines are cached: an Add's processed result is
        # written back to the blob store, so snapshots taken during its
        # pipeline would be keyed against a blob that no longer exists
        if rc is None or not use_cache or cmd.verb != "find" \
                or not cmd.operations:
            return [self._route(self._make_entity(eid, cmd, cplan.index,
                                                  query_id))
                    for eid in eids]
        sigs = prefix_signatures(cmd.operations)
        n_ops = len(cmd.operations)
        ents = []
        for eid in eids:
            # epoch BEFORE the blob read: if an invalidation lands in
            # between, this entity's eventual cache puts are refused
            # (safe direction — worse is a wasted put, never staleness)
            epoch = rc.epoch(eid)
            k, cached = rc.longest_cached_prefix(eid, sigs)
            if k:
                # resume at the first uncached op (k == n_ops: born done,
                # never touches Queue_1); the blob load is skipped — the
                # cached value IS the pipeline state after ops[:k]
                if k == n_ops and isinstance(cached, np.ndarray):
                    # a full hit flows straight into the client's result
                    # dict: hand out a writable copy so hit and miss
                    # responses behave identically under client mutation
                    # (prefix hits feed ops instead and never escape raw)
                    cached = cached.copy()
                ent = Entity(eid=eid, kind=cmd.kind, data=cached,
                             metadata=self.meta.get(eid),
                             ops=list(cmd.operations), op_index=k,
                             query_id=query_id, cmd_index=cplan.index)
                ent.cache_hit = "full" if k == n_ops else "prefix"
            else:
                ent = self._make_entity(eid, cmd, cplan.index, query_id)
            ent.cacheable = True
            ent.cache_sigs = sigs
            ent.cache_epoch = epoch
            ents.append(self._route(ent))
        return ents

    def _route(self, ent: Entity) -> Entity:
        """Multi-backend placement for the entity's REMAINING ops
        (``op_index`` onward — a cache prefix hit resumes mid-chain and
        is only routed from there).  No router (``dispatch="static"``)
        leaves ``route=None``: the event loop's paper-faithful rule."""
        if self.router is not None and not ent.done():
            ent.route = self.router.route(
                ent.ops, start=ent.op_index,
                payload_bytes=getattr(ent.data, "nbytes", 0))
        return ent

    def _make_entity(self, eid: str, cmd: Command, cmd_index: int,
                     query_id: str) -> Entity:
        return Entity(eid=eid, kind=cmd.kind, data=self.store.get(eid),
                      metadata=self.meta.get(eid), ops=list(cmd.operations),
                      query_id=query_id, cmd_index=cmd_index)
