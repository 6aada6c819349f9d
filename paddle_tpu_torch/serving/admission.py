"""Admission control: the robustness half of the serving engine.

A TPU serving frontend dies in one of three boring ways: an unbounded
queue grows until the process OOMs, expired requests burn device time
computing answers nobody is waiting for, or shutdown races in-flight
work and strands callers on futures that never resolve.  This module
owns all three:

- **bounded queue + fast-reject load shedding** — `check()` raises
  `QueueFullError` *at submit time* when the engine is at capacity;
  the caller gets a structured rejection in microseconds instead of a
  timeout after seconds (the TF-Serving batching-queue contract),
- **per-request deadlines** — `deadline_for()` stamps an absolute
  monotonic deadline on each request; the batcher drops expired
  requests *before* dispatch (`DeadlineExceededError`), never after,
- **health/drain state machine** — CREATED → RUNNING ⇄ DEGRADED →
  DRAINING → STOPPED.  Draining stops admission immediately but lets
  queued work finish, so a rolling restart never drops accepted
  requests,
- **circuit breaker** — `failure_threshold` CONSECUTIVE executor
  failures flip RUNNING → DEGRADED: submits fast-reject with
  `CircuitOpenError` (no queueing, no device contact) until the
  cooldown elapses, then exactly ONE half-open probe request is
  admitted; its success closes the breaker (back to RUNNING), its
  failure re-opens it for another cooldown.  A dead executor thus
  costs each caller microseconds, not a queue-full timeout, and
  recovery is automatic.

All serving errors derive from `ServingError` and carry a structured
`details` dict (`as_dict()`), so a frontend can serialize rejections
without parsing message strings.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

# -- state machine values (strings, so health() dicts are json-ready) ---
CREATED = "created"
RUNNING = "running"
DEGRADED = "degraded"   # breaker open: shedding, probing for recovery
DRAINING = "draining"
STOPPED = "stopped"


class ServingError(RuntimeError):
    """Base for structured serving rejections.

    `details` is machine-readable; `as_dict()` is the wire form a
    frontend returns to the client (and what tests assert on).

    `retryable` marks errors a ROUTER may transparently resubmit on
    another replica: the request itself is fine, the replica that held
    it is not (executor crash, scheduler death, evacuation for a
    weight roll).  Client-side rejections (bucket miss, deadline,
    queue full) stay non-retryable — resubmitting them elsewhere would
    produce the same answer or violate the caller's deadline.
    """

    kind = "serving_error"
    retryable = False

    def __init__(self, message: str, **details: Any):
        super().__init__(message)
        self.details = details

    def as_dict(self) -> Dict[str, Any]:
        out = {"error": self.kind, "message": str(self),
               "retryable": self.retryable}
        out.update(self.details)
        return out


class QueueFullError(ServingError):
    """Load shed: the bounded queue is at capacity (fast-reject)."""

    kind = "queue_full"


class DeadlineExceededError(ServingError):
    """The request's deadline expired while queued; it was dropped
    before dispatch (no device time was spent on it)."""

    kind = "deadline_exceeded"


class ServingClosedError(ServingError):
    """Submitted to an engine that is not RUNNING (not started yet,
    draining, or stopped)."""

    kind = "serving_closed"


class CircuitOpenError(ServingError):
    """Fast-reject: the engine is DEGRADED (breaker open after
    consecutive executor failures) and this request is not the
    half-open probe."""

    kind = "circuit_open"


class ExecutorFailureError(ServingError):
    """The batch dispatch (executor call) failed; every future in the
    batch resolves with this structured wrapper around the raw error.
    Retryable: the batch's requests were never at fault — a router may
    replay them on another replica."""

    kind = "executor_failure"
    retryable = True


class WeightReloadError(ServingError):
    """A hot weight reload was refused or broke its contract: shape/
    dtype mismatch vs the live parameters (a same-shape swap is what
    guarantees zero recompiles), an attempt to swap under live
    generations without evacuating first, or an XLA compile observed
    during a fleet roll."""

    kind = "weight_reload"


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed → open → half-open).

    Deliberately mechanism-only: the AdmissionController maps breaker
    state onto the serving state machine, the engine reports dispatch
    outcomes.  `clock` is injectable so tests drive the cooldown
    deterministically.  Thread-safe.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5,
                 cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown_s <= 0:
            raise ValueError("cooldown_s must be > 0")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self.opens = 0          # lifetime transition counters (stats)
        self.closes = 0

    @property
    def state(self) -> str:
        return self._state

    def record_failure(self) -> bool:
        """One executor failure; True when this flips the breaker OPEN
        (from closed at threshold, or a failed half-open probe)."""
        with self._lock:
            self._consecutive_failures += 1
            should_open = (
                self._state == self.HALF_OPEN
                or (self._state == self.CLOSED
                    and self._consecutive_failures
                    >= self.failure_threshold))
            if should_open:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self.opens += 1
            return should_open

    def record_success(self) -> bool:
        """One executor success; True when this CLOSES an open/half-open
        breaker (recovery)."""
        with self._lock:
            self._consecutive_failures = 0
            if self._state in (self.OPEN, self.HALF_OPEN):
                self._state = self.CLOSED
                self._opened_at = None
                self.closes += 1
                return True
            return False

    def allow(self) -> bool:
        """May a request proceed right now?  CLOSED: yes.  OPEN: only
        once the cooldown elapsed — that request becomes THE half-open
        probe (state moves to HALF_OPEN so concurrent submits keep
        shedding until the probe resolves)."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN and (
                    self._clock() - self._opened_at >= self.cooldown_s):
                self._state = self.HALF_OPEN
                return True
            return False

    def cooldown_remaining_s(self) -> float:
        with self._lock:
            if self._opened_at is None:
                return 0.0
            return max(0.0, self.cooldown_s
                       - (self._clock() - self._opened_at))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "failure_threshold": self.failure_threshold,
                    "opens": self.opens, "closes": self.closes}


class AdmissionController:
    """Admission decisions + the health/drain state machine.

    The controller is deliberately free of queue mechanics: the batcher
    reports its in-flight count and the controller answers admit/reject,
    so the policy is testable without threads.
    """

    def __init__(self, queue_capacity: int,
                 default_deadline_ms: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None):
        if queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if default_deadline_ms is not None and default_deadline_ms <= 0:
            raise ValueError("default_deadline_ms must be > 0")
        self.queue_capacity = int(queue_capacity)
        self.default_deadline_ms = default_deadline_ms
        self.breaker = breaker
        self._state = CREATED
        self._lock = threading.Lock()

    # -- state machine --------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    def start(self):
        with self._lock:
            if self._state != CREATED:
                raise ServingClosedError(
                    f"cannot start from state {self._state!r}",
                    state=self._state)
            self._state = RUNNING

    def begin_drain(self):
        with self._lock:
            if self._state in (DRAINING, STOPPED):
                return  # drain is idempotent
            if self._state not in (RUNNING, DEGRADED):
                raise ServingClosedError(
                    f"cannot drain from state {self._state!r}",
                    state=self._state)
            self._state = DRAINING

    def finish_drain(self):
        with self._lock:
            self._state = STOPPED

    # -- circuit breaker ------------------------------------------------
    def record_dispatch_result(self, ok: bool) -> Optional[str]:
        """Feed one executor outcome to the breaker and mirror its
        state onto the serving state machine.  Returns "opened" /
        "closed" on a transition (the engine emits the matching
        serving_breaker_* event), else None."""
        if self.breaker is None:
            return None
        if ok:
            if self.breaker.record_success():
                with self._lock:
                    if self._state == DEGRADED:
                        self._state = RUNNING
                return "closed"
            return None
        if self.breaker.record_failure():
            with self._lock:
                if self._state == RUNNING:
                    self._state = DEGRADED
            return "opened"
        return None

    # -- admission ------------------------------------------------------
    def check(self, inflight: int):
        """Admit one request given the current in-flight count, or
        raise the structured rejection.  Called under the batcher's
        lock, so the count cannot race past capacity."""
        if self._state == DEGRADED:
            # breaker open: shed in microseconds UNLESS this request is
            # the half-open probe (capacity still applies to the probe)
            if not self.breaker.allow():
                raise CircuitOpenError(
                    "engine degraded: executor failing; request shed "
                    "(circuit open)", state=self._state,
                    breaker=self.breaker.snapshot(),
                    retry_after_s=round(
                        self.breaker.cooldown_remaining_s(), 3))
        elif self._state != RUNNING:
            raise ServingClosedError(
                f"engine is {self._state}; not accepting requests",
                state=self._state)
        if inflight >= self.queue_capacity:
            raise QueueFullError(
                f"queue at capacity ({self.queue_capacity}); request "
                "shed", capacity=self.queue_capacity, inflight=inflight)

    def deadline_for(self, deadline_ms: Optional[float],
                     now: Optional[float] = None) -> Optional[float]:
        """Absolute monotonic deadline for a request, or None when
        neither the request nor the engine sets one."""
        ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        if ms is None:
            return None
        if ms <= 0:
            raise ValueError("deadline_ms must be > 0")
        return (now if now is not None else time.monotonic()) + ms / 1e3

    def health(self, **extra: Any) -> Dict[str, Any]:
        out = {"state": self._state, "capacity": self.queue_capacity}
        if self.breaker is not None:
            out["breaker"] = self.breaker.snapshot()
        out.update(extra)
        return out
