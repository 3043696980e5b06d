"""Pipeline-signature result cache (ROADMAP: "result caching keyed on
(eid, pipeline signature)").

The planner sees the whole op pipeline at ``expand`` time, so it can
short-circuit repeated sub-pipelines before any work reaches Queue_1 —
the serving-side prediction-cache lever of systems like Clipper, applied
to visual query pipelines:

- **Full hit**: the exact ``(eid, signature(ops))`` pair is cached; the
  entity is born ``done()`` and skips Queue_1 entirely.
- **Prefix hit**: only ``ops[:k]`` is cached for some ``k``; the entity
  re-enters the pipeline at ``op_index = k`` — the first uncached op —
  carrying the cached intermediate as its data.

Signatures are canonical hashes of the op chain — ``(name, params,
where, url, port)`` per op, hashed incrementally so all prefix
signatures of an N-op pipeline cost one O(N) pass per *command* (they
are shared by every entity the command fans out).

Population happens on the event loop: the final result of every
cacheable entity, plus an intermediate snapshot after each remote/UDF op
(the expensive resume points; native ops are cheap enough to recompute).

Invalidation: ingesting an eid (the Add-barrier write path — also the
processed-blob write-back of an Add with operations) drops every cached
signature of that eid AND bumps the eid's epoch, preserving
write-then-read semantics even against in-flight work: the planner
snapshots the epoch *before* reading the blob, and a ``put`` carrying a
stale epoch is refused — so a Find racing an Add's write-back can never
repopulate the cache from the pre-write blob.  A query submitted with
``cache=False`` neither reads nor writes the cache.

Cached numpy values are stored as read-only copies: the populating run's
client keeps a private array it may mutate freely, and a warm hit serves
the read-only copy, so no client can silently corrupt what every other
session reads.  Torch tensors cannot be frozen, so a tensor is cloned on
``put`` and again on every hit: the cached tensor itself never escapes,
and an op or client that writes into the tensor it was handed cannot
corrupt later hits.

The cache is a bounded, thread-safe LRU — bounded in entries
(``cache_capacity``; the engine default of 0 disables it —
paper-faithful off) and in payload bytes (``cache_capacity_bytes``),
since a few hundred video tensors can dwarf any sane entry count.
"""
from __future__ import annotations

import collections
import hashlib
import threading
from typing import Any

import numpy as np
import torch


def _private(value):
    """What a hit hands out: a clone of a cached tensor (the cached one
    must never escape), anything else as stored."""
    return value.clone() if isinstance(value, torch.Tensor) else value


def op_signature(op) -> tuple:
    """Canonical identity of one operation (mirrors the fusion key in
    repro_torch.core.pipeline)."""
    return (op.name, op.params, op.where, op.url, op.port)


def prefix_signatures(ops) -> list[str]:
    """Signatures of every pipeline prefix: ``sigs[k-1]`` identifies
    ``ops[:k]``.  Computed with one incremental hash pass."""
    h = hashlib.sha1()
    sigs = []
    for op in ops:
        h.update(repr(op_signature(op)).encode())
        sigs.append(h.hexdigest())
    return sigs


def pipeline_signature(ops) -> str:
    """Canonical signature of a whole op chain."""
    sigs = prefix_signatures(ops)
    return sigs[-1] if sigs else hashlib.sha1(b"").hexdigest()


class ResultCache:
    """Bounded thread-safe LRU keyed on ``(eid, pipeline_signature)``."""

    def __init__(self, capacity: int = 1024,
                 capacity_bytes: int = 256 << 20):
        self.capacity = max(1, capacity)
        self.capacity_bytes = capacity_bytes
        self._lock = threading.Lock()
        self._od: collections.OrderedDict[tuple[str, str], Any] = \
            collections.OrderedDict()                   # guarded-by: _lock
        self._by_eid: dict[str, set[str]] = {}          # guarded-by: _lock
        self._epochs: dict[str, int] = {}               # guarded-by: _lock
        self._bytes = 0                                 # guarded-by: _lock
        self.hits = 0          # full-pipeline hits  # guarded-by: _lock
        self.prefix_hits = 0   # partial hits        # guarded-by: _lock
        self.misses = 0         # guarded-by: _lock
        self.puts = 0           # guarded-by: _lock
        self.stale_puts = 0     # guarded-by: _lock
        self.oversize_puts = 0  # guarded-by: _lock
        self.evictions = 0      # guarded-by: _lock
        self.invalidations = 0  # guarded-by: _lock

    # -------------------------------------------------------------- reads
    def get(self, eid: str, sig: str):
        """``(True, value)`` on a hit (LRU-touched), else ``(False, None)``.
        Does not update hit/miss counters — use ``longest_cached_prefix`` on the
        query path."""
        key = (eid, sig)
        with self._lock:
            if key not in self._od:
                return False, None
            self._od.move_to_end(key)
            value = self._od[key]
        return True, _private(value)

    def longest_cached_prefix(self, eid: str, sigs: list[str]):
        """Longest cached prefix of a pipeline: ``(k, value)`` where
        ``sigs[k-1]`` hit (``k == len(sigs)`` is a full hit), or
        ``(0, None)``.  Counts exactly one of hit/prefix_hit/miss."""
        with self._lock:
            for k in range(len(sigs), 0, -1):
                key = (eid, sigs[k - 1])
                if key in self._od:
                    self._od.move_to_end(key)
                    if k == len(sigs):
                        self.hits += 1
                    else:
                        self.prefix_hits += 1
                    value = self._od[key]
                    break
            else:
                self.misses += 1
                return 0, None
        return k, _private(value)

    def epoch(self, eid: str) -> int:
        """Current write epoch of ``eid``.  Snapshot it BEFORE reading
        the blob; pass it back to ``put`` so a record computed from a
        since-invalidated blob is refused instead of poisoning the
        cache."""
        with self._lock:
            return self._epochs.get(eid, 0)

    # ------------------------------------------------------------- writes
    def put(self, eid: str, sig: str, value: Any, epoch: int | None = None):
        if getattr(value, "nbytes", 0) > self.capacity_bytes:
            # un-cacheable: admitting it would evict the entire cache
            # only to evict the value itself next.  put() runs
            # concurrently on native workers and Thread_3, so even this
            # refusal counter takes the lock — a bare += loses updates.
            with self._lock:
                self.oversize_puts += 1
            return
        with self._lock:
            # cheap staleness check BEFORE the array copy below — put()
            # runs on event-loop threads (Thread_3 included), so a doomed
            # multi-MB copy would stall dispatch for every session
            if epoch is not None and epoch != self._epochs.get(eid, 0):
                self.stale_puts += 1
                return
        if isinstance(value, np.ndarray):
            # read-only copy: the populating client keeps its private,
            # mutable array; warm hits share this frozen one
            value = value.copy()
            value.setflags(write=False)
        elif isinstance(value, torch.Tensor):
            value = value.clone()
        key = (eid, sig)
        with self._lock:
            if epoch is not None and epoch != self._epochs.get(eid, 0):
                self.stale_puts += 1     # invalidated during the copy
                return
            if key in self._od:
                self._od.move_to_end(key)
                self._bytes -= getattr(self._od[key], "nbytes", 0)
            self._od[key] = value
            self._bytes += getattr(value, "nbytes", 0)
            self._by_eid.setdefault(eid, set()).add(sig)
            self.puts += 1
            while self._od and (len(self._od) > self.capacity
                                or self._bytes > self.capacity_bytes):
                self._evict_oldest_locked()

    def _evict_oldest_locked(self):
        (e, s), old = self._od.popitem(last=False)
        self._bytes -= getattr(old, "nbytes", 0)
        self.evictions += 1
        sigset = self._by_eid.get(e)
        if sigset is not None:
            sigset.discard(s)
            if not sigset:
                del self._by_eid[e]

    def invalidate(self, eid: str) -> int:
        """Drop every cached signature of ``eid`` and bump its epoch
        (Add-barrier rule; the bump also poisons in-flight records)."""
        with self._lock:
            self._epochs[eid] = self._epochs.get(eid, 0) + 1
            sigs = self._by_eid.pop(eid, None)
            if not sigs:
                return 0
            n = 0
            for sig in sigs:
                old = self._od.pop((eid, sig), None)
                if old is not None:
                    self._bytes -= getattr(old, "nbytes", 0)
                    n += 1
            self.invalidations += n
            return n

    def clear(self):
        with self._lock:
            self._od.clear()
            self._by_eid.clear()
            self._bytes = 0

    # -------------------------------------------------------------- stats
    def __len__(self):
        with self._lock:
            return len(self._od)

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.prefix_hits + self.misses
            return {
                "size": len(self._od),
                "capacity": self.capacity,
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "hits": self.hits,
                "prefix_hits": self.prefix_hits,
                "misses": self.misses,
                "puts": self.puts,
                "stale_puts": self.stale_puts,
                "oversize_puts": self.oversize_puts,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "hit_rate": ((self.hits + self.prefix_hits) / lookups
                             if lookups else 0.0),
            }
