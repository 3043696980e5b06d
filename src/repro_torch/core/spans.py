"""Spans and counters inside the engine: where a query's time goes,
layer by layer, at a cost small enough to leave on.

One :class:`SpanRecorder` per engine.  ``with rec.span(name, qid):``
adds one count (``n`` with ``rec.span(name, qid, n)``, for a block
that does the work of ``n``) and the block's ``time.perf_counter()``
duration to ``name``'s totals; ``rec.add(name, seconds, n)`` does the
same for an interval that starts on one thread and ends on another (an
entity's wait in the device backend's inbox); ``rec.count(name, n)``
keeps a plain counter.  ``rec.snapshot()`` returns a fresh dict,
``{"spans": {name: [count, seconds]}, "counters": {name: n}}``, so a
reader may keep it and take differences of two.

While ``torch.profiler`` records, a span also opens a range named
``name`` (``torch.autograd._record_function_with_args_enter``, what
``torch.profiler.record_function`` opens, with the query ids as integer
arguments): the span then lies on the profiler's timeline beside the
device's kernels, nested in the enclosing range of its thread, and a
profile that records shapes keeps each range's query ids as its
``concrete_inputs``.  With the profiler off that call is skipped (a
range costs about 13 us on a host CPU, a span about 2 us).

The engine's recorder is the one its own threads write to.  A model
UDF's route is registered process-wide and runs on the device
backend's worker, so the backend makes its engine's recorder the
thread's current one while it runs a group (:func:`using`), and the
route records into :func:`current`, which is :data:`NULL` (records
nothing) outside any engine."""
from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


def _range_args(qid) -> tuple:
    """A span's query ids as the range's arguments: an int for each id
    of digits (the engine's), the id itself otherwise."""
    if qid is None:
        return ()
    ids = qid if isinstance(qid, (set, frozenset, list, tuple)) else (qid,)
    args = [int(q) if str(q).isdigit() else q for q in ids]
    return tuple(sorted(args, key=lambda q: (isinstance(q, str), q)))


class _Span:
    __slots__ = ("_rec", "_name", "_qid", "_n", "_t0", "_range")

    def __init__(self, rec, name, qid, n):
        self._rec = rec
        self._name = name
        self._qid = qid
        self._n = n

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.autograd._record_function_with_args_enter(
                self._name, *_range_args(self._qid))
        else:
            self._range = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        if self._range is not None:
            torch.autograd._record_function_with_args_exit(self._range)
        self._rec.add(self._name, seconds, self._n)
        return False


class SpanRecorder:
    """Totals of named spans and counters, updated under one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: dict[str, list] = {}        # guarded-by: _lock
        self._counters: dict[str, int] = {}      # guarded-by: _lock

    def span(self, name: str, qid=None, n: int = 1) -> _Span:
        """A context manager timing its block into ``name`` as ``n``
        counts; ``qid`` is the query's id, or a set of ids (a device
        group's)."""
        return _Span(self, name, qid, n)

    def add(self, name: str, seconds: float, n: int = 1) -> None:
        with self._lock:
            tot = self._spans.get(name)
            if tot is None:
                self._spans[name] = [n, seconds]
            else:
                tot[0] += n
                tot[1] += seconds

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return {"spans": {k: list(v) for k, v in self._spans.items()},
                    "counters": dict(self._counters)}


class _NullRecorder:
    """Records nothing: the recorder of a thread outside any engine."""

    _NOOP = contextlib.nullcontext()

    def span(self, name: str, qid=None):
        return self._NOOP

    def count(self, name: str, n: int = 1) -> None:
        pass


NULL = _NullRecorder()
_local = threading.local()


def current():
    """The recorder the calling thread records into (:data:`NULL`
    outside :func:`using`)."""
    return getattr(_local, "rec", NULL)


@contextlib.contextmanager
def using(rec):
    """Makes ``rec`` the calling thread's current recorder in the block."""
    prev = getattr(_local, "rec", NULL)
    _local.rec = rec
    try:
        yield rec
    finally:
        _local.rec = prev
