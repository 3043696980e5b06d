"""In-memory property-graph metadata store (the PMGD stand-in).

Entities carry properties; equality-indexed lookups use hash indexes,
range constraints scan the candidate set.  Supports the constraint
grammar of VDMS queries: {"prop": ["==", v]}, ["!=", v], [">=", a, "<=", b],
["in", [..]] — conjunctive across properties (paper Figs 1/8).
"""
from __future__ import annotations

import itertools
import threading
from collections import defaultdict
from typing import Any

_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">": lambda a, b: a is not None and a > b,
    ">=": lambda a, b: a is not None and a >= b,
    "<": lambda a, b: a is not None and a < b,
    "<=": lambda a, b: a is not None and a <= b,
    "in": lambda a, b: a in b,
}


class MetadataStore:
    def __init__(self):
        self._lock = threading.RLock()
        self._props: dict[str, dict] = {}
        self._kind: dict[str, str] = {}
        self._eq_index: dict[str, dict[Any, set]] = defaultdict(lambda: defaultdict(set))
        self._edges: dict[str, list[tuple[str, str]]] = defaultdict(list)
        self._ids = itertools.count()

    # ------------------------------------------------------------- write
    def add(self, kind: str, props: dict, eid: str | None = None) -> str:
        with self._lock:
            eid = eid or f"{kind}-{next(self._ids)}"
            self._props[eid] = dict(props)
            self._kind[eid] = kind
            for k, v in props.items():
                if isinstance(v, (str, int, bool)):
                    self._eq_index[k][v].add(eid)
            return eid

    def update(self, eid: str, props: dict):
        with self._lock:
            old = self._props.get(eid, {})
            for k, v in old.items():
                if isinstance(v, (str, int, bool)):
                    self._eq_index[k][v].discard(eid)
            old.update(props)
            self._props[eid] = old
            for k, v in old.items():
                if isinstance(v, (str, int, bool)):
                    self._eq_index[k][v].add(eid)

    def remove(self, eid: str) -> bool:
        """Drop an entity's row and index entries (cluster rebalance:
        a shard that no longer owns a key range sheds its copies).
        Returns whether the eid existed."""
        with self._lock:
            props = self._props.pop(eid, None)
            if props is None:
                return False
            self._kind.pop(eid, None)
            for k, v in props.items():
                if isinstance(v, (str, int, bool)):
                    self._eq_index[k][v].discard(eid)
            self._edges.pop(eid, None)
            return True

    def connect(self, src: str, rel: str, dst: str):
        with self._lock:
            self._edges[src].append((rel, dst))

    # -------------------------------------------------------------- read
    def get(self, eid: str) -> dict:
        with self._lock:
            return dict(self._props.get(eid, {}))

    def neighbors(self, eid: str, rel: str | None = None) -> list[str]:
        with self._lock:
            return [d for r, d in self._edges.get(eid, []) if rel is None or r == rel]

    def find_ids(self, kind: str | None = None,
             constraints: dict | None = None) -> list[str]:
        """Conjunctive constraint evaluation with index-accelerated seeds."""
        with self._lock:
            constraints = constraints or {}
            candidates: set | None = None
            # seed from the most selective equality index
            for prop, cons in constraints.items():
                terms = _parse_terms(cons)
                for op, val in terms:
                    if op == "==" and prop in self._eq_index:
                        s = set(self._eq_index[prop].get(val, set()))
                        candidates = s if candidates is None else candidates & s
            if candidates is None:
                candidates = set(self._props)
            out = []
            for eid in candidates:
                if kind and self._kind.get(eid) != kind:
                    continue
                props = self._props[eid]
                if all(_OPS[op](props.get(prop), val)
                       for prop, cons in constraints.items()
                       for op, val in _parse_terms(cons)):
                    out.append(eid)
            return sorted(out)

    def count(self) -> int:
        with self._lock:
            return len(self._props)


def _parse_terms(cons) -> list[tuple[str, Any]]:
    """["==", v] | [">=", a, "<=", b] | ["in", [...]] -> [(op, val), ...]"""
    if not isinstance(cons, (list, tuple)):
        return [("==", cons)]
    terms = []
    i = 0
    while i < len(cons):
        op = cons[i]
        if op not in _OPS:
            raise ValueError(f"bad constraint op {op!r}")
        terms.append((op, cons[i + 1]))
        i += 2
    return terms
