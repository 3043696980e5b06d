"""Fault tolerance for the query path: error taxonomy, deterministic
fault injection, heartbeats and failure detection.

The :class:`TransientError` / :class:`PermanentError` taxonomy is
threaded through the dispatch stack (``core/remote.py``,
``query/dispatch.py``, ``query/device_backend.py``), and the seeded
:class:`FaultInjector` deterministically injects crash-before-reply,
latency spikes, error replies, server death mid-batch, and silent hangs
into any offload :class:`~repro_torch.query.dispatch.Backend` and into
:class:`~repro_torch.core.remote.RemoteServer`.  The
:class:`HeartbeatMonitor` below detects the silent deaths.

:class:`TrainSupervisor` is the training side's checkpoint/restart
loop, for a train state whole or sharded over a mesh.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Optional


# --------------------------------------------------------- error taxonomy
class TransientError(RuntimeError):
    """A failure worth retrying: the same request may succeed on another
    attempt or another server (injected faults, flaky transport, a
    server that died mid-request).  The retry machinery in
    ``RemoteServerPool.handle_response`` retries these (and, for
    backward compatibility, any *untyped* exception) up to
    ``max_retries`` with bounded exponential backoff."""


class PermanentError(RuntimeError):
    """A deterministic failure: retrying the same request would fail the
    same way (a malformed op, a contract violation).  Skips retries AND
    the final-attempt native fallback — degradation cannot rescue a
    request that is wrong, only one that is unlucky."""


class NoLiveServersError(TransientError):
    """Every remote server is dead.  Transient — servers can scale back
    out — but unroutable right now; the event loop converts it into a
    per-entity failure or a native fallback instead of letting it kill
    the dispatch thread."""


class DeadlineExceeded(PermanentError):
    """A retry would outlive its query's deadline budget.  Permanent by
    classification: the client has already timed out, so neither another
    attempt nor a (slower) native fallback can produce a visible
    result."""


class ShardLostError(TransientError):
    """An engine shard died holding the only copy of its key range
    (``replica_factor=1``, or every replica holder is down too).
    Transient — the shard can be replaced and re-fed — but the query
    that needed those entities cannot be completed now; the cluster
    scatter fails the affected query with this instead of hanging on a
    barrier that will never drain.  With ``replica_factor >= 2`` the
    gather layer re-drives the dead shard's work on the replica holders
    and the client never sees this error."""


# ----------------------------------------------------- fault injection
@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault decision.  ``kind`` is one of
    :data:`FaultInjector.KINDS`; ``latency_s`` is set for latency
    spikes."""
    kind: str
    latency_s: float = 0.0


class FaultInjector:
    """Deterministic, seeded fault injection for the dispatch stack.

    Each injection *site* (``"remote:3"``, ``"backend:device"``, ...)
    owns an independent ``random.Random`` stream seeded from
    ``(seed, site)``, so a given seed replays the same fault sequence
    per site bit-for-bit regardless of what other sites do.  Sites call
    :meth:`decide` once per unit of work; the returned fault (or None)
    is a pure function of (seed, site, call index) plus any scripted
    faults registered with :meth:`at`.

    Fault kinds:

    - ``"latency"`` — a latency spike: the site sleeps ``latency_s``
      extra before serving.
    - ``"error"``   — an error reply: the request fails with a
      :class:`TransientError` without executing.
    - ``"crash"``   — crash-before-reply: the work is lost and the
      caller sees the same ``server_died`` signal a killed server
      emits, but the server itself survives.
    - ``"die"``     — server death mid-batch: the server marks itself
      dead; its in-service and queued requests are re-queued by the
      pool's retry path.
    - ``"hang"``    — silent death: the server stops replying *and*
      stops heartbeating without any error signal — only the
      :class:`HeartbeatMonitor` (or straggler reissue) can detect it.

    ``death_budget`` bounds the total ``die`` + ``hang`` faults across
    all sites, so a storm cannot kill the last live server.
    """

    KINDS = ("error", "crash", "latency", "die", "hang")

    def __init__(self, seed: int = 0, *,
                 error_rate: float = 0.0,
                 crash_rate: float = 0.0,
                 latency_rate: float = 0.0,
                 latency_s: float = 0.05,
                 die_rate: float = 0.0,
                 hang_rate: float = 0.0,
                 death_budget: int = 1):
        rates = {"error": error_rate, "crash": crash_rate,
                 "latency": latency_rate, "die": die_rate,
                 "hang": hang_rate}
        for kind, r in rates.items():
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"{kind}_rate must be in [0, 1], got {r!r}")
        if sum(rates.values()) > 1.0:
            raise ValueError(
                f"fault rates must sum to <= 1.0, got {sum(rates.values())}")
        self.seed = seed
        self.rates = rates
        self.latency_s = latency_s
        self._death_budget = max(0, death_budget)
        self._lock = threading.Lock()
        self._streams: dict[str, random.Random] = {}
        self._calls: dict[str, int] = {}
        self._scripted: dict[tuple[str, int], Fault] = {}
        self.decisions = 0
        self.injected = {k: 0 for k in self.KINDS}
        self.suppressed_deaths = 0

    def at(self, site: str, call_index: int, kind: str,
           latency_s: float | None = None) -> "FaultInjector":
        """Script an exact fault: the ``call_index``-th :meth:`decide`
        at ``site`` (0-based) returns ``kind`` regardless of the random
        stream.  Returns self for chaining."""
        if kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"known: {self.KINDS}")
        with self._lock:
            self._scripted[(site, call_index)] = Fault(
                kind, latency_s if latency_s is not None else self.latency_s)
        return self

    def _draw_locked(self, site: str) -> Optional[Fault]:
        rng = self._streams.get(site)
        if rng is None:
            # string seeding is version-2 deterministic (unlike hash())
            rng = self._streams[site] = random.Random(f"{self.seed}/{site}")
        u = rng.random()
        edge = 0.0
        for kind in self.KINDS:
            edge += self.rates[kind]
            if u < edge:
                return Fault(kind, self.latency_s)
        return None

    def decide(self, site: str) -> Optional[Fault]:
        """The fault to inject for this unit of work at ``site``, or
        None.  Thread-safe; one deterministic stream per site."""
        with self._lock:
            idx = self._calls.get(site, 0)
            self._calls[site] = idx + 1
            self.decisions += 1
            fault = self._scripted.pop((site, idx), None)
            if fault is None:
                fault = self._draw_locked(site)
            if fault is not None and fault.kind in ("die", "hang"):
                if self._death_budget <= 0:
                    self.suppressed_deaths += 1
                    return None
                self._death_budget -= 1
            if fault is not None:
                self.injected[fault.kind] += 1
            return fault

    def stats(self) -> dict:
        with self._lock:
            return {"decisions": self.decisions,
                    "injected": dict(self.injected),
                    "suppressed_deaths": self.suppressed_deaths,
                    "death_budget_left": self._death_budget}


class HeartbeatMonitor:
    """Tracks worker liveness; ``on_failure`` fires once per lost worker."""

    def __init__(self, workers: list[str], timeout_s: float = 5.0,
                 on_failure: Optional[Callable[[str], None]] = None):
        self.timeout_s = timeout_s
        self.on_failure = on_failure or (lambda w: None)
        self._last: dict[str, float] = {w: time.monotonic() for w in workers}
        self._dead: set[str] = set()
        self._lock = threading.Lock()

    def register(self, worker: str):
        """Add a worker after construction (elastic scale-out)."""
        with self._lock:
            self._dead.discard(worker)
            self._last[worker] = time.monotonic()

    def beat(self, worker: str):
        with self._lock:
            if worker not in self._dead:
                self._last[worker] = time.monotonic()

    def check(self) -> list[str]:
        """Returns newly-dead workers."""
        now = time.monotonic()
        newly = []
        with self._lock:
            for w, t in self._last.items():
                if w not in self._dead and now - t > self.timeout_s:
                    self._dead.add(w)
                    newly.append(w)
        for w in newly:
            self.on_failure(w)
        return newly

    def alive(self) -> list[str]:
        with self._lock:
            return [w for w in self._last if w not in self._dead]

    def last_beats(self) -> dict[str, float]:
        """Snapshot of each worker's last beat time (monotonic)."""
        with self._lock:
            return dict(self._last)



class TrainSupervisor:
    """Checkpoint-every-N + restart-from-latest orchestration.  With a
    ``layout`` (``sharding.Layout`` of the train state) the state is
    this rank's shards: a save gathers the full leaves on every rank and
    rank 0 writes them, in the layout either package restores; a resume
    reads the full leaves and keeps this rank's shards."""

    def __init__(self, ckpt_dir: str, save_every: int = 50, keep: int = 3,
                 layout=None):
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.keep = keep
        self.layout = layout

    def maybe_save(self, step: int, state) -> str | None:
        """Every rank calls it (a sharded save gathers); only rank 0
        writes."""
        # deferred import: the query-path fault layer above must not pay
        # for the checkpoint stack at import time
        from repro_torch.checkpoint import save_checkpoint
        from repro_torch.launch.mesh import rank
        if step % self.save_every or step <= 0:
            return None
        if self.layout is not None:
            state = self.layout.full(state)
        if rank() != 0:
            return None
        return save_checkpoint(self.ckpt_dir, step, state, keep=self.keep)

    def resume(self, template):
        """Returns (state, start_step); fresh start if no checkpoint.  The
        restored leaves land on the template's devices."""
        from repro_torch.checkpoint import latest_step, restore_checkpoint
        step = latest_step(self.ckpt_dir)
        if step is None:
            return template, 0
        state, step = restore_checkpoint(self.ckpt_dir, template)
        if self.layout is not None:
            state = self.layout.local(state)
        return state, int(step)
