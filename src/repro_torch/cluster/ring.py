"""Consistent-hash ring: entity-id -> shard placement (VDMS-style
horizontal partitioning; Remis et al. partition visual data across
server instances the same way).

Each shard contributes ``virtual_nodes`` points on a 64-bit ring,
hashed from ``"{sid}#{v}"`` with sha1 — a *stable* hash, never
Python's seeded ``hash()``, so placement is identical across processes
and runs.  A key's **owner** is the first point clockwise from
``hash(key)``; its **owner list** walks clockwise collecting the first
``n`` *distinct* shards, which makes replica placement automatic: the
``replica_factor=2`` holder set of a key is simply ``owners(key, 2)``,
and the replica is always on a different shard than the primary.

Virtual nodes bound imbalance (more vnodes -> tighter balance) and —
the property the cluster's rebalance path depends on — make shard
join/leave move only the key ranges adjacent to the changed shard's
points.  :meth:`rebalance` mutates the ring and hands back a
:class:`RingDelta` that can answer ownership questions against BOTH
topologies, so the migration planner
(:func:`repro_torch.distributed.elastic.migration_moves`) sees exactly the
minimal delta.
"""
from __future__ import annotations

import bisect
import hashlib
import threading


def ring_point(label: str) -> int:
    """Stable 64-bit ring position for a label (vnode name or key)."""
    return int.from_bytes(
        hashlib.sha1(label.encode("utf-8")).digest()[:8], "big")


def _lookup(points: list[int], sids: list, key: str, n: int) -> list:
    """First ``n`` distinct shards clockwise from ``hash(key)`` in the
    (points, sids) snapshot — pure, so :class:`RingDelta` can run it
    against a retired topology."""
    if not points or n < 1:
        return []
    out: list = []
    start = bisect.bisect_right(points, ring_point(key))
    for step in range(len(points)):
        sid = sids[(start + step) % len(points)]
        if sid not in out:
            out.append(sid)
            if len(out) == n:
                break
    return out


class RingDelta:
    """Before/after ownership view of one :meth:`HashRing.rebalance`.

    ``old_owners`` / ``new_owners`` answer against the pre- and
    post-change topology; both are snapshots, so the delta stays valid
    even if the ring changes again later."""

    def __init__(self, old_points, old_sids, new_points, new_sids):
        self._old = (list(old_points), list(old_sids))
        self._new = (list(new_points), list(new_sids))

    def old_owners(self, key: str, n: int = 1) -> list:
        return _lookup(*self._old, key, n)

    def new_owners(self, key: str, n: int = 1) -> list:
        return _lookup(*self._new, key, n)


class HashRing:
    """Thread-safe consistent-hash ring over opaque shard ids."""

    def __init__(self, shards=(), *, virtual_nodes: int = 64):
        if virtual_nodes < 1:
            raise ValueError(
                f"virtual_nodes must be >= 1, got {virtual_nodes!r}")
        self.virtual_nodes = virtual_nodes
        self._lock = threading.Lock()
        self._points: list[int] = []   # sorted ring positions
        self._sids: list = []          # parallel: shard id per point
        self._shards: set = set()
        for sid in shards:
            self.add_shard(sid)

    # ------------------------------------------------------------ topology
    def _insert_locked(self, sid):
        if sid in self._shards:
            raise ValueError(f"shard {sid!r} already on the ring")
        self._shards.add(sid)
        for v in range(self.virtual_nodes):
            p = ring_point(f"{sid}#{v}")
            i = bisect.bisect_left(self._points, p)
            self._points.insert(i, p)
            self._sids.insert(i, sid)

    def _drop_locked(self, sid):
        if sid not in self._shards:
            raise ValueError(f"shard {sid!r} not on the ring")
        self._shards.discard(sid)
        keep = [(p, s) for p, s in zip(self._points, self._sids) if s != sid]
        self._points = [p for p, _ in keep]
        self._sids = [s for _, s in keep]

    def add_shard(self, sid):
        with self._lock:
            self._insert_locked(sid)

    def remove_shard(self, sid):
        with self._lock:
            self._drop_locked(sid)

    def rebalance(self, *, add=None, remove=None) -> RingDelta:
        """Apply a join (``add``) and/or leave (``remove``) atomically
        and return the :class:`RingDelta` describing what moved."""
        if add is None and remove is None:
            raise ValueError("rebalance needs add= and/or remove=")
        with self._lock:
            old_points = list(self._points)
            old_sids = list(self._sids)
            if add is not None:
                self._insert_locked(add)
            if remove is not None:
                self._drop_locked(remove)
            return RingDelta(old_points, old_sids,
                             self._points, self._sids)

    # ------------------------------------------------------------- lookups
    def owner(self, key: str):
        """The primary shard for ``key`` (first point clockwise)."""
        with self._lock:
            owners = _lookup(self._points, self._sids, key, 1)
        if not owners:
            raise ValueError("ring has no shards")
        return owners[0]

    def owners(self, key: str, n: int = 1) -> list:
        """First ``n`` distinct shards clockwise from ``key`` — the
        replica holder set (primary first).  Fewer than ``n`` shards on
        the ring returns them all."""
        with self._lock:
            return _lookup(self._points, self._sids, key, n)

    def shards(self) -> list:
        with self._lock:
            return sorted(self._shards)

    def shard_count(self) -> int:
        with self._lock:
            return len(self._shards)

    # --------------------------------------------------------------- stats
    def ownership(self, keys, n: int = 1) -> dict:
        """Holder count per shard over ``keys`` (primary-only at the
        default ``n=1``); every ring member appears, even with zero."""
        with self._lock:
            counts = {sid: 0 for sid in self._shards}
            for key in keys:
                for sid in _lookup(self._points, self._sids, key, n):
                    counts[sid] += 1
        return counts

    def stats(self) -> dict:
        with self._lock:
            return {"shards": sorted(self._shards),
                    "virtual_nodes": self.virtual_nodes,
                    "points": len(self._points)}
