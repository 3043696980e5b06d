"""Per-backend health tracking for the dispatch router (PR 7).

Every backend the :class:`~repro_torch.query.dispatch.BackendRouter` can place
work on gets a :class:`CircuitBreaker`: error-rate and latency EWMAs fed
by the event loop's per-attempt outcomes, driving the classic three-state
machine

    closed ──(error EWMA >= threshold, >= min_samples)──> open
    open ──(open_s elapsed)──> half-open
    half-open ──(probe succeeds)──> closed
    half-open ──(probe fails)──> open

surfaced to the router two ways:

- :meth:`CircuitBreaker.routable` — an *open* breaker prices the backend
  at infinity (the DP cannot place work there); *half-open* admits at
  most ``half_open_probes`` placements per round, so recovery is probed
  with a trickle instead of the full fan-out;
- :meth:`CircuitBreaker.penalty` — a multiplicative cost penalty
  ``1 / (1 - err_ewma)`` while closed, so routing *drains* away from a
  degrading backend before the breaker trips.  Exactly ``1.0`` at a
  zero error EWMA: a healthy engine's routing is unchanged by enabling
  the registry.

The native backend's breaker is constructed with ``can_open=False`` —
native is the degradation target of last resort (it can run every op),
so it must never price itself unroutable.
"""
from __future__ import annotations

import threading
import time

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """One backend's health state machine.  All transitions happen under
    the breaker's lock; ``clock`` is injectable so tests drive the
    open -> half-open timer deterministically."""

    def __init__(self, name: str, *,
                 failure_threshold: float = 0.5,
                 min_samples: int = 5,
                 open_s: float = 1.0,
                 half_open_probes: int = 2,
                 alpha: float = 0.2,
                 can_open: bool = True,
                 clock=time.monotonic):
        if not 0.0 < failure_threshold <= 1.0:
            raise ValueError(f"failure_threshold must be in (0, 1], "
                             f"got {failure_threshold!r}")
        self.name = name
        self.failure_threshold = failure_threshold
        self.min_samples = max(1, min_samples)
        self.open_s = open_s
        self.half_open_probes = max(1, half_open_probes)
        self.alpha = alpha
        self.can_open = can_open
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED             # guarded-by: _lock
        self._err = 0.0                  # error EWMA   # guarded-by: _lock
        self._lat: float | None = None   # latency EWMA  # guarded-by: _lock
        self._samples = 0                # guarded-by: _lock
        self._opened_at = 0.0            # guarded-by: _lock
        self._probes = 0                 # half-open round  # guarded-by: _lock
        self.trips = 0                   # guarded-by: _lock
        self.recoveries = 0              # guarded-by: _lock

    # ------------------------------------------------------- transitions
    def _tick_locked(self):
        if self._state is OPEN and \
                self._clock() - self._opened_at >= self.open_s:
            self._state = HALF_OPEN
            self._probes = 0

    def _trip_locked(self):
        self._state = OPEN
        self._opened_at = self._clock()
        self._probes = 0
        self.trips += 1

    # ---------------------------------------------------------- recording
    def record_success(self, latency_s: float | None = None):
        with self._lock:
            self._tick_locked()
            self._samples += 1
            self._err *= (1.0 - self.alpha)
            if latency_s is not None:
                self._lat = (latency_s if self._lat is None else
                             (1.0 - self.alpha) * self._lat
                             + self.alpha * latency_s)
            if self._state is HALF_OPEN:
                # the probe came back: the backend recovered
                self._state = CLOSED
                self._err = 0.0
                self._probes = 0
                self.recoveries += 1

    def record_failure(self):
        with self._lock:
            self._tick_locked()
            self._samples += 1
            self._err = (1.0 - self.alpha) * self._err + self.alpha
            if not self.can_open:
                return
            if self._state is HALF_OPEN:
                self._trip_locked()      # probe failed: back to open
            elif self._state is CLOSED \
                    and self._samples >= self.min_samples \
                    and self._err >= self.failure_threshold:
                self._trip_locked()

    # ------------------------------------------------------- router reads
    def routable(self) -> bool:
        """Whether the router may place work here right now.  Open:
        no.  Half-open: only while probe slots remain this round."""
        with self._lock:
            self._tick_locked()
            if self._state is CLOSED:
                return True
            if self._state is OPEN:
                return False
            return self._probes < self.half_open_probes

    def note_probe(self):
        """A placement was routed here; consumes a probe slot when
        half-open (no-op otherwise)."""
        with self._lock:
            self._tick_locked()
            if self._state is HALF_OPEN:
                self._probes += 1

    def penalty(self) -> float:
        """Multiplicative cost penalty from the error EWMA.  Exactly 1.0
        at zero errors, so enabling health tracking never perturbs a
        healthy engine's routing."""
        with self._lock:
            err = min(self._err, 0.95)
        return 1.0 / (1.0 - err)

    def state(self) -> str:
        with self._lock:
            self._tick_locked()
            return self._state

    def stats(self) -> dict:
        with self._lock:
            self._tick_locked()
            return {"state": self._state,
                    "error_ewma": self._err,
                    "latency_ewma_s": self._lat,
                    "samples": self._samples,
                    "trips": self.trips,
                    "recoveries": self.recoveries}


class HealthRegistry:
    """The engine's breaker per routable backend.  Unknown names answer
    neutrally (routable, penalty 1.0, records dropped) so stub backends
    in tests need no registration."""

    def __init__(self, names, *, never_open=("native",),
                 clock=time.monotonic, **breaker_kwargs):
        self._never_open = tuple(never_open)
        self._clock = clock
        self._breaker_kwargs = dict(breaker_kwargs)
        # register()/remove() run on user threads (cluster shard
        # join/leave) while router and gather threads read — a bare
        # dict would let stats() iterate mid-insert
        self._reg_lock = threading.Lock()
        self._breakers = {}              # guarded-by: _reg_lock
        for n in names:
            self.register(n)

    def register(self, name: str) -> CircuitBreaker:
        """Add a breaker for a backend that joined after construction
        (cluster shard join), built with the registry's own breaker
        parameters so every member runs the same health policy.
        Idempotent: an existing breaker (and its accumulated EWMAs) is
        kept."""
        with self._reg_lock:
            b = self._breakers.get(name)
            if b is None:
                b = CircuitBreaker(name,
                                   can_open=name not in self._never_open,
                                   clock=self._clock,
                                   **self._breaker_kwargs)
                self._breakers[name] = b
            return b

    def remove(self, name: str):
        """Forget a departed backend's breaker (cluster shard leave);
        unknown names answer neutrally again afterwards."""
        with self._reg_lock:
            self._breakers.pop(name, None)

    def get(self, name: str) -> CircuitBreaker | None:
        with self._reg_lock:
            return self._breakers.get(name)

    def record_success(self, name: str, latency_s: float | None = None):
        b = self.get(name)
        if b is not None:
            b.record_success(latency_s)

    def record_failure(self, name: str):
        b = self.get(name)
        if b is not None:
            b.record_failure()

    def routable(self, name: str) -> bool:
        b = self.get(name)
        return True if b is None else b.routable()

    def note_probe(self, name: str):
        b = self.get(name)
        if b is not None:
            b.note_probe()

    def penalty(self, name: str) -> float:
        b = self.get(name)
        return 1.0 if b is None else b.penalty()

    def stats(self) -> dict:
        # snapshot under the registry lock; per-breaker stats() takes
        # each breaker's own lock outside it (no nested acquisition)
        with self._reg_lock:
            members = sorted(self._breakers.items())
        return {n: b.stats() for n, b in members}
