"""Serving fleet: N engine replicas behind one health-checked router.

The port of paddle_tpu/serving/fleet.py: the layer that makes a replica
death invisible to callers.  One `Fleet` fronts N engine replicas (all
`ServingEngine` or all `DecodeEngine`; on one card they share its
default stream, each replica's dispatcher a thread of its own) behind a
single `submit()` surface:

- **health-scored, least-loaded routing** — every replica carries a
  fleet-side `CircuitBreaker` (injectable clock, the admission-plane
  idiom) fed by routed-request outcomes, plus the engine's own
  admission state and a last-success heartbeat; requests go to the
  healthy replica with the fewest outstanding requests.  A replica
  whose scheduler died is EJECTED (the poison idiom lifted across the
  process boundary: once marked dead it never routes again).
- **structured whole-fleet fast-reject** — when every replica sheds
  (queue full, breaker open, dead), `submit()` raises
  `FleetSaturatedError` in microseconds with per-replica evidence and
  a `retry_after_s` honoring the engines' `CircuitOpenError` cooldowns
  — the TF-Serving fast-reject contract at fleet scope.
- **deadline-budgeted retry + hedging** — failover resubmission runs
  under `resilience.watchdog.retry_call` (deterministic backoff,
  bounded by the request's remaining deadline); a request slower than
  `hedge_after_ms` gets ONE duplicate on a different replica, first
  result wins.  Only idempotent requests hedge — greedy decode and
  pure inference are; callers mark anything else `idempotent=False`.
- **failover for in-flight decode sessions** — when a replica dies or
  is ejected mid-generation, its requests come back as retryable
  `DecodeReplicaFailedError`s carrying requeue descriptors (the
  committed-token prefix included); the fleet resubmits them on a
  survivor and VERIFIES the regeneration reproduces the committed
  prefix token-for-token (greedy decode makes the whole output
  identical to an unkilled control engine: the preemption proof lifted
  across replicas; the decode engine's prefill row blocks keep a
  prompt's bits independent of its batch, ROADMAP C8).
- **hot weight reload** — `fleet.reload(ckpt_dir)` rolls new params
  through the replicas one at a time: the replica under roll is
  excluded from routing, its in-flight decode sessions evacuate to
  survivors, `io.load_sharded` lands the new arrays in the live
  engine's param dict (same shapes asserted ⇒ every warmed run stays
  warm — ZERO compiles, asserted fleet-wide over the roll), and every
  response is tagged with the `model_version` that produced it.
  No request is rejected during the roll; the other replicas carry the
  traffic.

Everything that crosses the fleet boundary is a structured
`ServingError` (`as_dict()`) and every state change is a
`serving_fleet_*` event through `observe.RunEventLog`; replica engines
stamp their own events with `replica_id` (RunEventLog.bind), so N
replicas sharing one process log stay attributable.

Metrics and alerts: `metrics_registry()` (the router collector, the
fleet-merged engine stats, request tracing), `start_metrics_server()`
and `enable_alerts()` (observe.fleet_rule_pack), all host-side.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..observe.events import RunEventLog
from ..observe.monitoring import LatencyHistogram, runtime_stats
from ..resilience.errors import RetriesExhaustedError
from ..resilience.watchdog import retry_call
from .admission import (DEGRADED, RUNNING, CircuitBreaker,
                        CircuitOpenError, DeadlineExceededError,
                        QueueFullError, ServingClosedError, ServingError,
                        WeightReloadError)
from .decode import DecodeEngine
from .stats import DecodeStats, ServingStats


class FleetSaturatedError(ServingError):
    """Every replica fast-rejected this request (queue full, breaker
    open, reloading, or dead).  Carries per-replica evidence and
    `retry_after_s` (the soonest any breaker cooldown elapses) so a
    frontend can back off precisely instead of hammering."""

    kind = "fleet_saturated"


class FleetClosedError(ServingError):
    """Submitted to a fleet that is closed (or not started)."""

    kind = "fleet_closed"


class FailoverParityError(ServingError):
    """LOUD: a failed-over request's regeneration did NOT reproduce the
    committed-token prefix the dead replica reported — the greedy
    token-identity invariant broke (weights diverged between replicas,
    or a non-greedy sampler was routed as idempotent)."""

    kind = "failover_parity"


class FleetResponse:
    """What a fleet future resolves to: the engine's result plus the
    routing provenance a caller needs to trust it — which replica
    served it, under which weight version, whether failover or hedging
    was involved, and (with tracing on) the trace_id plus the ordered
    replica hop chain, so "why was THIS request slow" is answerable
    from the response alone."""

    __slots__ = ("value", "replica_id", "model_version", "failovers",
                 "hedged", "attempts", "trace_id", "hops")

    def __init__(self, value, replica_id: int, model_version: int,
                 failovers: int, hedged: bool, attempts: int,
                 trace_id: Optional[str] = None,
                 hops: Sequence[int] = ()):
        self.value = value
        self.replica_id = replica_id
        self.model_version = model_version
        self.failovers = failovers
        self.hedged = hedged
        self.attempts = attempts
        self.trace_id = trace_id
        self.hops = list(hops)     # replica ids in attempt order

    @property
    def tokens(self):
        """Decode-fleet alias."""
        return self.value

    @property
    def outputs(self):
        """Serving-fleet alias."""
        return self.value

    def __repr__(self):
        return (f"FleetResponse(replica={self.replica_id}, "
                f"version={self.model_version}, "
                f"failovers={self.failovers}, hedged={self.hedged})")


class FleetConfig:
    """Routing/failover knobs.

    failure_threshold / cooldown_s: the per-replica fleet-side
        CircuitBreaker (consecutive routed-request failures open it;
        one half-open probe after the cooldown).  `clock` is
        injectable so tests drive cooldowns deterministically.
    max_failovers: per-request bound on requeue hops (a request
        bouncing between dying replicas must fail structured, not
        loop).
    failover_route_retries / retry_base_delay_s: the retry_call budget
        a FAILOVER resubmission gets when the fleet is momentarily
        saturated (e.g. the only survivor is mid-reload).  First
        submits never retry — fast-reject is the contract.
    hedge_after_ms: duplicate an idempotent request on a second
        replica when the first attempt is slower than this (None
        disables hedging).
    default_deadline_ms: per-request deadline when the caller sets
        none; the SAME budget bounds every failover hop.
    """

    def __init__(self, failure_threshold: int = 3,
                 cooldown_s: float = 2.0,
                 max_failovers: int = 3,
                 failover_route_retries: int = 6,
                 retry_base_delay_s: float = 0.05,
                 hedge_after_ms: Optional[float] = None,
                 default_deadline_ms: Optional[float] = None,
                 window: int = 256,
                 clock: Callable[[], float] = time.monotonic):
        if max_failovers < 0 or failover_route_retries < 0:
            raise ValueError("max_failovers/failover_route_retries >= 0")
        if hedge_after_ms is not None and hedge_after_ms <= 0:
            raise ValueError("hedge_after_ms must be > 0")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.max_failovers = int(max_failovers)
        self.failover_route_retries = int(failover_route_retries)
        self.retry_base_delay_s = float(retry_base_delay_s)
        self.hedge_after_ms = hedge_after_ms
        self.default_deadline_ms = default_deadline_ms
        self.window = int(window)
        self.clock = clock


class ReplicaHandle:
    """Fleet-side view of one engine replica: identity, load, the
    fleet breaker, and the health evidence routing scores on."""

    def __init__(self, replica_id: int, engine, config: FleetConfig):
        self.replica_id = int(replica_id)
        self.engine = engine
        self.breaker = CircuitBreaker(
            failure_threshold=config.failure_threshold,
            cooldown_s=config.cooldown_s, clock=config.clock)
        self.inflight = 0       # fleet-routed outstanding requests
        self.routed = 0         # lifetime routed count
        self.failures = 0       # lifetime retryable failures observed
        self.dead = False       # ejected: never routes again
        self.dead_reason: Optional[str] = None
        self.reloading = False  # mid-roll: excluded from routing
        self.last_ok_t: Optional[float] = None

    def routable(self) -> bool:
        return (not self.dead and not self.reloading
                and self.engine.admission.state in (RUNNING, DEGRADED))

    def score(self, clock: Callable[[], float]) -> Dict[str, Any]:
        out = {"replica_id": self.replica_id,
               "state": self.engine.admission.state,
               "breaker": self.breaker.snapshot(),
               "inflight": self.inflight, "routed": self.routed,
               "failures": self.failures, "dead": self.dead,
               "dead_reason": self.dead_reason,
               "reloading": self.reloading,
               "model_version": self.engine.model_version}
        if self.last_ok_t is not None:
            out["since_last_ok_s"] = round(clock() - self.last_ok_t, 3)
        return out


class FleetStats:
    """Fleet-level counters + end-to-end latency (the per-replica
    engine stats merge separately via ServingStats/DecodeStats.merge);
    thread-safe."""

    def __init__(self, window: int = 256):
        self._lock = threading.Lock()
        self.window = int(window)
        self.e2e_ms = LatencyHistogram()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.failovers = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.retries = 0          # failover route retries (backoff hits)
        self.saturated = 0        # whole-fleet fast-rejects
        self.ejects = 0
        self.reloads = 0          # per-replica swaps applied
        self.reload_pause_ms = 0.0
        self.parity_checked = 0   # failovers verified token-identical
        self.parity_failed = 0
        self._emitted_at = 0

    def _bump(self, field: str, by: float = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + by)

    def record_submit(self):
        self._bump("submitted")

    def record_failed(self):
        self._bump("failed")

    def record_failover(self):
        self._bump("failovers")

    def record_hedge(self):
        self._bump("hedges")

    def record_hedge_win(self):
        self._bump("hedge_wins")

    def record_retry(self):
        self._bump("retries")

    def record_saturated(self):
        self._bump("saturated")

    def record_eject(self):
        self._bump("ejects")

    def record_parity(self, ok: bool):
        self._bump("parity_checked")
        if not ok:
            self._bump("parity_failed")

    def record_reload(self, pause_ms: float):
        with self._lock:
            self.reloads += 1
            if pause_ms > self.reload_pause_ms:
                self.reload_pause_ms = float(pause_ms)

    def record_done(self, e2e_ms: float) -> bool:
        """True when this completion crosses a window boundary (the
        caller emits serving_fleet_window)."""
        self.e2e_ms.record(e2e_ms)
        with self._lock:
            self.completed += 1
            if self.completed - self._emitted_at >= self.window:
                self._emitted_at = self.completed
                return True
            return False

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {f: getattr(self, f) for f in (
                "submitted", "completed", "failed", "failovers",
                "hedges", "hedge_wins", "retries", "saturated",
                "ejects", "reloads", "parity_checked", "parity_failed")}
            out["reload_pause_ms"] = round(self.reload_pause_ms, 3)
        out["e2e_ms"] = self.e2e_ms.summary()
        return out


class _FleetRequest:
    """Router-side state of one logical request across attempts."""

    __slots__ = ("payload", "future", "deadline", "idempotent",
                 "t_submit", "lock", "resolved", "tried", "attempts",
                 "failovers", "hedges", "prefix", "trace", "hops",
                 "pending_failover")

    def __init__(self, payload: Dict[str, Any],
                 deadline: Optional[float], idempotent: bool,
                 trace=None):
        self.payload = payload
        self.future: Future = Future()
        self.deadline = deadline        # absolute time.monotonic()
        self.idempotent = bool(idempotent)
        self.t_submit = time.monotonic()
        self.lock = threading.Lock()
        self.resolved = False
        self.tried: set = set()         # replica ids attempted
        self.attempts = 0
        self.failovers = 0
        self.hedges = 0
        self.prefix: List[int] = []     # committed tokens from a failed
        #                                 attempt (parity evidence)
        self.trace = trace              # observe.reqtrace.RequestTrace
        self.hops: List[int] = []       # replica ids in attempt order
        # (t_detected, replica_id, reason) of a failover awaiting its
        # landing replica — closed into a `failover` span on requeue
        self.pending_failover: Optional[tuple] = None

    def remaining_ms(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return (self.deadline - time.monotonic()) * 1e3


class Fleet:
    """Router over N homogeneous engine replicas.

        engines = [DecodeEngine(DecoderLM(seed=0), cfg) for _ in range(2)]
        fleet = Fleet(engines, FleetConfig(hedge_after_ms=500)).start()
        fut = fleet.submit(prompt_ids, max_new_tokens=64)
        resp = fut.result()          # FleetResponse: .tokens, .replica_id,
        ...                          # .model_version, .failovers
        fleet.reload(ckpt_dir)       # rolling hot weight swap
        fleet.close()

    Engines may be pre-started or not (start() warms the cold ones,
    then resets every replica's post-warmup compile window so replica
    K's warmup never counts against replica 0's zero-compile
    contract).  All replicas must be the same kind; the fleet detects
    decode vs single-shot serving from the first engine.
    """

    def __init__(self, engines: Sequence, config: Optional[FleetConfig]
                 = None, event_log: Optional[RunEventLog] = None,
                 log_path: Optional[str] = None, tracer=None):
        """tracer: an observe.ReqTracer — every submit() carries one
        RequestTrace across routing, the replica's queue/dispatch
        boundaries, and any failover/hedge hops (one trace_id per
        logical request, observe pillar 7); responses then carry
        `trace_id` + `hops`.  Host-side only; None disables."""
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        self.config = config or FleetConfig()
        self.tracer = tracer
        decode = isinstance(engines[0], DecodeEngine)
        for e in engines:
            if isinstance(e, DecodeEngine) != decode:
                raise ValueError(
                    "mixed fleet: all replicas must be DecodeEngine or "
                    "all single-shot serving engines")
        self.kind = "decode" if decode else "serving"
        self._own_log = None
        if event_log is None and log_path is not None:
            event_log = self._own_log = RunEventLog(
                log_path, meta={"component": "serving_fleet"})
        self._event_log = event_log
        self.stats = FleetStats(window=self.config.window)
        self.replicas = [ReplicaHandle(i, e, self.config)
                         for i, e in enumerate(engines)]
        for h in self.replicas:
            h.engine.set_replica_id(h.replica_id)
            if event_log is not None and h.engine._event_log is None:
                bound = event_log.bind(replica_id=h.replica_id)
                h.engine._event_log = bound
                h.engine.stats._event_log = bound
        self.model_version = max(e.model_version for e in engines)
        self._lock = threading.Lock()
        self._closed = False
        self._started = False
        self._rolling = False
        self._metrics_registry = None
        self._metrics_server = None
        self.alert_engine = None       # opt-in (enable_alerts)
        self.flight_recorder = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "Fleet":
        """Warm every cold replica, then open the post-warmup
        zero-compile window for the WHOLE fleet at once."""
        for h in self.replicas:
            if not h.engine._started:
                h.engine.start()
        for h in self.replicas:
            h.engine.stats.reset_compile_base()
        self._started = True
        self._event("serving_fleet_start", fleet_kind=self.kind,
                    n_replicas=len(self.replicas),
                    model_version=self.model_version,
                    hedge_after_ms=self.config.hedge_after_ms,
                    max_failovers=self.config.max_failovers)
        return self

    def close(self, timeout_s: float = 60.0,
              close_replicas: bool = True):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if close_replicas:
            for h in self.replicas:
                h.engine.close(timeout_s)
        if self.alert_engine is not None:
            self.alert_engine.close()
        if self.flight_recorder is not None:
            self.flight_recorder.close()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        self._event("serving_fleet_close", **self.snapshot())
        if self._own_log is not None:
            self._own_log.close()

    def __enter__(self) -> "Fleet":
        return self.start() if not self._started else self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- observability --------------------------------------------------
    def _event(self, kind: str, **fields: Any):
        if self._event_log is not None:
            self._event_log.event(kind, **fields)

    def health(self) -> Dict[str, Any]:
        clock = self.config.clock
        scores = [h.score(clock) for h in self.replicas]
        return {"kind": self.kind, "closed": self._closed,
                "model_version": self.model_version,
                "healthy_replicas": sum(h.routable()
                                        for h in self.replicas),
                "replicas": scores}

    def merged_stats(self):
        """One ServingStats/DecodeStats holding every replica's
        telemetry, merged exactly (histogram bin-wise addition,
        counters summed) — the cross-replica aggregation surface."""
        agg = DecodeStats() if self.kind == "decode" else ServingStats()
        for h in self.replicas:
            agg.merge(h.engine.stats)
        return agg

    def metrics_registry(self):
        """The fleet's unified metrics surface: one
        MetricsRegistry holding the router collector (per-replica
        health/breaker gauges, failover/hedge counters), the
        fleet-MERGED engine stats (pulled via merged_stats at scrape
        time, so histograms aggregate exactly), the request tracer's
        phase histograms when tracing is on, and the process-wide
        runtime/process/memory collectors.  Built once, cached."""
        if self._metrics_registry is None:
            from ..observe.registry import (MetricsRegistry,
                                            fleet_collector,
                                            serving_stats_collector,
                                            standard_collectors,
                                            tracer_collector)

            reg = standard_collectors(MetricsRegistry())
            reg.register("fleet", fleet_collector(self))
            reg.register("serving",
                         serving_stats_collector(self.merged_stats,
                                                 scope="fleet"))
            if self.tracer is not None:
                reg.register("reqtrace",
                             tracer_collector(self.tracer))
            self._metrics_registry = reg
        return self._metrics_registry

    def start_metrics_server(self, host: str = "127.0.0.1",
                             port: int = 0):
        """Opt-in /metrics + /healthz endpoint over this fleet's
        registry (stdlib ThreadingHTTPServer; binds localhost unless
        told otherwise — the exposition carries per-replica health
        detail).  With `enable_alerts()` active the same server also
        answers /alerts.  port=0 picks an ephemeral port; read `.port`
        / `.url` off the returned MetricsServer.  Stopped by close()."""
        if self._metrics_server is not None:
            return self._metrics_server
        from ..observe.registry import MetricsServer

        self._metrics_server = MetricsServer(
            self.metrics_registry(), health_fn=self.health,
            host=host, port=port,
            alerts_fn=(self.alert_engine.state
                       if self.alert_engine is not None
                       else None)).start()
        return self._metrics_server

    def enable_alerts(self, rules=None, interval_s: float = 5.0,
                      flight_dir: Optional[str] = None,
                      recorder_config: Optional[Dict[str, Any]] = None,
                      start: bool = True, **pack_kw):
        """Opt into alerting on this fleet: an AlertEngine
        evaluating the serving-SLO pack (`observe.fleet_rule_pack` —
        error/failover/saturation burn + TTFT/TPOT/queue_wait p99; or
        explicit `rules`) over `metrics_registry()` every `interval_s`
        on a background thread.  `pack_kw` forwards to the pack
        (thresholds/windows).  With `flight_dir` a FlightRecorder
        writes a diagnostic bundle on every firing alert
        (`recorder_config` forwards rate/size bounds).  The `alerts`
        metric family joins /metrics and the /alerts route activates
        on the metrics server.  `start=False` skips the background
        thread (callers drive `alert_engine.evaluate()` — tests, and
        in-process scrapes).  Pure host: the alert thread only reads
        registry snapshots and launches nothing on the device.  Stopped
        by close()."""
        if self.alert_engine is not None:
            return self.alert_engine
        from ..observe.alerts import AlertEngine, fleet_rule_pack
        from ..observe.flightrec import FlightRecorder

        if rules is None:
            rules = fleet_rule_pack(self, **pack_kw)
        elif pack_kw:
            raise ValueError("pack_kw only applies to the default "
                             "rule pack")
        engine = AlertEngine(self.metrics_registry(), rules=rules,
                             interval_s=interval_s,
                             event_log=self._event_log)
        self.metrics_registry().register("alerts", engine.collector())
        if flight_dir is not None:
            self.flight_recorder = FlightRecorder(
                flight_dir, registry=self.metrics_registry(),
                event_log=self._event_log, tracer=self.tracer,
                **(recorder_config or {}))
            self.flight_recorder.attach_engine(engine)
        self.alert_engine = engine
        if self._metrics_server is not None:
            self._metrics_server.alerts_fn = engine.state
        if start:
            engine.start()
        return engine

    def snapshot(self) -> Dict[str, Any]:
        """Fleet counters + the merged per-replica engine telemetry
        (one dict, the serving_fleet_window wire form)."""
        out = self.stats.snapshot()
        out["engines"] = self.merged_stats().snapshot()
        out["post_warmup_compiles"] = \
            out["engines"]["post_warmup_compiles"]
        out["model_version"] = self.model_version
        out["healthy_replicas"] = sum(h.routable()
                                      for h in self.replicas)
        return out

    # -- request path ---------------------------------------------------
    def submit(self, request, *, max_new_tokens: int = 32,
               priority: int = 0, deadline_ms: Optional[float] = None,
               idempotent: bool = True) -> Future:
        """Route one request to the healthiest least-loaded replica;
        returns a Future of a FleetResponse.  Decode fleets take a
        prompt (1-D token array) plus max_new_tokens/priority;
        single-shot fleets take the per-example feed dict.  Raises the
        structured FleetSaturatedError synchronously when every replica
        sheds — a rejected request costs microseconds, never a
        timeout.  idempotent=False opts a request out of hedging AND
        transparent failover (its error surfaces instead)."""
        if self._closed or not self._started:
            raise FleetClosedError(
                "fleet is closed" if self._closed
                else "fleet not started", closed=self._closed)
        ms = (deadline_ms if deadline_ms is not None
              else self.config.default_deadline_ms)
        deadline = time.monotonic() + ms / 1e3 if ms else None
        if self.kind == "decode":
            payload = {"prompt": np.asarray(request),
                       "max_new_tokens": int(max_new_tokens),
                       "priority": int(priority)}
        else:
            payload = {"feed": request}
        trace = None
        if self.tracer is not None:
            trace = self.tracer.new_trace(f"fleet_{self.kind}")
            trace.fleet_owned = True  # engines add spans; WE finish it
        freq = _FleetRequest(payload, deadline, idempotent,
                             trace=trace)
        self.stats.record_submit()
        self._route_once(freq)
        if self.config.hedge_after_ms and freq.idempotent \
                and len(self.replicas) > 1:
            t = threading.Timer(self.config.hedge_after_ms / 1e3,
                                self._fire_hedge, args=(freq,))
            t.daemon = True
            t.start()
        return freq.future

    def generate(self, prompt, max_new_tokens: int = 32,
                 timeout_s: Optional[float] = None,
                 **kw) -> FleetResponse:
        """Synchronous submit()+result() convenience (decode fleets)."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           **kw).result(timeout_s)

    def infer(self, feed, timeout_s: Optional[float] = None,
              **kw) -> FleetResponse:
        """Synchronous submit()+result() convenience (serving fleets)."""
        return self.submit(feed, **kw).result(timeout_s)

    # -- routing --------------------------------------------------------
    def _engine_submit(self, handle: ReplicaHandle, freq: _FleetRequest,
                       remaining_ms: Optional[float]) -> Future:
        p = freq.payload
        if self.kind == "decode":
            return handle.engine.submit(
                p["prompt"], max_new_tokens=p["max_new_tokens"],
                priority=p["priority"], deadline_ms=remaining_ms,
                _trace=freq.trace)
        return handle.engine.submit(p["feed"],
                                    deadline_ms=remaining_ms,
                                    _trace=freq.trace)

    def _route_once(self, freq: _FleetRequest,
                    hedge: bool = False) -> ReplicaHandle:
        """One routing pass: try healthy replicas least-loaded-first
        (preferring ones this request has not attempted), accept the
        first that admits, raise FleetSaturatedError with per-replica
        evidence otherwise."""
        if self._closed:
            raise FleetClosedError("fleet is closed", closed=True)
        t_route = time.monotonic()
        remaining_ms = freq.remaining_ms()
        if remaining_ms is not None and remaining_ms <= 0:
            raise DeadlineExceededError(
                "request deadline expired before a replica could be "
                "(re)tried", attempts=freq.attempts,
                failovers=freq.failovers)
        with self._lock:
            avail = [h for h in self.replicas if h.routable()]
            fresh = [h for h in avail
                     if h.replica_id not in freq.tried]
            # a hedge duplicate on an already-tried replica is
            # pointless; a failover prefers a fresh replica but falls
            # back to a retried one rather than dropping the request
            candidates = fresh if (fresh or hedge) else avail
            candidates = sorted(
                candidates,
                key=lambda h: (h.inflight, h.routed, h.replica_id))
        reasons: List[Dict[str, Any]] = []
        retry_after: List[float] = []
        for h in candidates:
            if h.breaker.state != CircuitBreaker.CLOSED \
                    and not h.breaker.allow():
                reasons.append({"replica_id": h.replica_id,
                                "reject": "fleet_breaker_open"})
                retry_after.append(h.breaker.cooldown_remaining_s())
                continue
            try:
                fut = self._engine_submit(h, freq, remaining_ms)
            except (QueueFullError, CircuitOpenError,
                    ServingClosedError) as e:
                reasons.append({"replica_id": h.replica_id,
                                "reject": e.kind})
                ra = e.details.get("retry_after_s")
                if ra:
                    retry_after.append(float(ra))
                continue
            with self._lock:
                h.inflight += 1
                h.routed += 1
                freq.tried.add(h.replica_id)
                freq.attempts += 1
                freq.hops.append(h.replica_id)
            if freq.trace is not None:
                now = time.monotonic()
                freq.trace.add("route", t_route, now,
                               replica_id=h.replica_id, hedge=hedge)
                pf = freq.pending_failover
                if pf is not None and not hedge:
                    # the failover hop closes when the request LANDS
                    # on its next replica: one span from detection to
                    # requeue, naming the dead replica and the
                    # survivor — the hop chain a chrome export renders
                    # across replica rows
                    freq.pending_failover = None
                    t_det, dead_id, reason = pf
                    freq.trace.add("failover", t_det, now,
                                   from_replica=dead_id,
                                   to_replica=h.replica_id,
                                   reason=reason)
            fut.add_done_callback(
                lambda f, h=h: self._on_attempt_done(freq, h, f, hedge))
            return h
        self.stats.record_saturated()
        clock = self.config.clock
        err = FleetSaturatedError(
            f"all {len(self.replicas)} replica(s) shed this request "
            f"({len(candidates)} routable)",
            retry_after_s=(round(min(retry_after), 3)
                           if retry_after else None),
            rejects=reasons,
            replicas=[h.score(clock) for h in self.replicas])
        self._event("serving_fleet_saturated", **err.as_dict())
        raise err

    # -- attempt resolution ---------------------------------------------
    def _on_attempt_done(self, freq: _FleetRequest, h: ReplicaHandle,
                         fut: Future, hedge: bool):
        with self._lock:
            h.inflight -= 1
        exc = fut.exception()
        if freq.trace is not None:
            with freq.lock:
                already = freq.resolved
            if already:
                # a loser attempt (hedge or failover race) resolving
                # after the request did: its work is abandoned — the
                # marker tail-keeps the trace so a hedged request's
                # timeline shows both attempts
                freq.trace.point(
                    "abandoned", replica_id=h.replica_id,
                    error=None if exc is None else type(exc).__name__)
        if exc is None:
            h.breaker.record_success()
            h.last_ok_t = self.config.clock()
            self._finish_ok(freq, h, fut, hedge)
            return
        retryable = (isinstance(exc, ServingError)
                     and getattr(exc, "retryable", False))
        if not retryable:
            # client-side rejection (deadline, bucket miss): replaying
            # it elsewhere cannot help — surface it (hedge losses are
            # opportunistic and stay silent)
            if not hedge:
                self._finish_err(freq, exc)
            return
        evacuated = exc.details.get("reason") == "evacuated"
        if not evacuated:
            # an EVACUATION is a deliberate control action (weight
            # roll / manual eject), not evidence against the replica's
            # health — only real failures feed the breaker
            with self._lock:
                h.failures += 1
            h.breaker.record_failure()
            state = h.engine.admission.state
            if state not in (RUNNING, DEGRADED) and not h.dead:
                # the replica is not coming back on its own (scheduler
                # death drains admission): eject it from routing
                self._eject(h, reason=f"engine {state} after {exc.kind}")
        desc = exc.details.get("descriptor") or {}
        with freq.lock:
            if freq.resolved:
                return
            gen = desc.get("generated") or []
            if len(gen) > len(freq.prefix):
                freq.prefix = [int(t) for t in gen]
        if hedge:
            return  # the primary attempt owns failover
        if not freq.idempotent:
            self._finish_err(freq, exc)
            return
        freq.failovers += 1
        if freq.trace is not None and freq.pending_failover is None:
            freq.pending_failover = (time.monotonic(), h.replica_id,
                                     exc.kind)
        self.stats.record_failover()
        self._event("serving_fleet_failover",
                    replica_id=h.replica_id, reason=exc.kind,
                    committed_tokens=len(freq.prefix),
                    attempts=freq.attempts, failovers=freq.failovers)
        if freq.failovers > self.config.max_failovers:
            self._finish_err(freq, exc)
            return
        # the requeue runs on its OWN thread: this callback fires on
        # the failing engine's scheduler thread (future resolution is
        # inline), and the backoff sleeps below must never block a
        # scheduler that is mid-evacuation or mid-death
        t = threading.Thread(target=self._requeue, args=(freq,),
                             name="fleet-requeue", daemon=True)
        t.start()

    def _requeue(self, freq: _FleetRequest):
        """Deadline-budgeted requeue of an accepted request: an
        accepted request is never dropped because the fleet was
        saturated for a moment (e.g. the lone survivor is mid-reload)
        — retry_call's deterministic backoff until the deadline or the
        retry budget runs out."""
        try:
            retry_call(
                lambda: self._route_once(freq),
                retries=self.config.failover_route_retries,
                base_delay_s=self.config.retry_base_delay_s,
                max_delay_s=1.0,
                retry_on=(FleetSaturatedError,),
                on_retry=lambda _a, _e, _d: self.stats.record_retry())
        except RetriesExhaustedError as e2:
            last = e2.__cause__
            self._finish_err(freq, last if isinstance(last, ServingError)
                             else e2)
        except ServingError as e2:
            self._finish_err(freq, e2)

    def _finish_ok(self, freq: _FleetRequest, h: ReplicaHandle,
                   fut: Future, hedge: bool):
        with freq.lock:
            if freq.resolved:
                return
            freq.resolved = True
        value = fut.result()
        if self.kind == "decode" and freq.prefix:
            # the failover proof: the survivor's regeneration must
            # reproduce the dead replica's committed prefix exactly
            got = [int(t) for t in
                   np.asarray(value)[:len(freq.prefix)]]
            ok = got == freq.prefix
            self.stats.record_parity(ok)
            if not ok:
                err = FailoverParityError(
                    f"regenerated tokens diverged from the "
                    f"{len(freq.prefix)}-token committed prefix of the "
                    f"failed replica", expected=freq.prefix, got=got,
                    replica_id=h.replica_id)
                self._event("serving_fleet_failover",
                            replica_id=h.replica_id, parity="FAILED",
                            **err.details)
                self.stats.record_failed()
                if freq.trace is not None and self.tracer is not None:
                    self.tracer.finish(freq.trace, error=err)
                freq.future.set_exception(err)
                return
        if hedge:
            self.stats.record_hedge_win()
        if freq.trace is not None:
            freq.trace.point("complete", replica_id=h.replica_id,
                             failovers=freq.failovers,
                             hedged=freq.hedges > 0)
        resp = FleetResponse(
            value, replica_id=h.replica_id,
            model_version=getattr(fut, "model_version",
                                  h.engine.model_version),
            failovers=freq.failovers, hedged=freq.hedges > 0,
            attempts=freq.attempts,
            trace_id=(freq.trace.trace_id if freq.trace is not None
                      else None),
            hops=list(freq.hops))
        if freq.trace is not None and self.tracer is not None:
            self.tracer.finish(freq.trace)
        freq.future.set_result(resp)
        if self.stats.record_done(
                (time.monotonic() - freq.t_submit) * 1e3):
            self._event("serving_fleet_window", **self.snapshot())

    def _finish_err(self, freq: _FleetRequest, exc: BaseException):
        with freq.lock:
            if freq.resolved:
                return
            freq.resolved = True
        self.stats.record_failed()
        if freq.trace is not None and self.tracer is not None:
            self.tracer.finish(freq.trace, error=exc)
        freq.future.set_exception(exc)

    # -- hedging --------------------------------------------------------
    def _fire_hedge(self, freq: _FleetRequest):
        if self._closed or freq.resolved:
            return
        try:
            h = self._route_once(freq, hedge=True)
        except ServingError:
            return  # hedging is opportunistic; the primary stands
        with freq.lock:
            freq.hedges += 1
        if freq.trace is not None:
            freq.trace.point("hedge", replica_id=h.replica_id,
                             after_ms=self.config.hedge_after_ms)
        self.stats.record_hedge()
        self._event("serving_fleet_hedge", replica_id=h.replica_id,
                    after_ms=self.config.hedge_after_ms)

    # -- eject ----------------------------------------------------------
    def _eject(self, h: ReplicaHandle, reason: str):
        with self._lock:
            if h.dead:
                return
            h.dead = True
            h.dead_reason = reason
        self.stats.record_eject()
        self._event("serving_fleet_eject", replica_id=h.replica_id,
                    reason=reason,
                    healthy_replicas=sum(x.routable()
                                         for x in self.replicas))

    def eject(self, replica_id: int, reason: str = "manual"):
        """Remove one replica from routing (the poison idiom at fleet
        scope: an operator or external watchdog condemns a replica).
        In-flight decode sessions evacuate and fail over to survivors
        through the normal retryable-error path."""
        h = self.replicas[int(replica_id)]
        self._eject(h, reason)
        if self.kind == "decode":
            h.engine.evacuate()

    # -- hot weight reload ----------------------------------------------
    def reload(self, source, version: Optional[int] = None
               ) -> Dict[str, Any]:
        """Roll new weights through the replicas ONE AT A TIME; no
        request is rejected during the roll.  Per replica: exclude it
        from routing, evacuate its in-flight decode sessions (they
        fail over to the other replicas and regenerate
        token-identically), swap the params at its batch boundary
        (same shapes asserted), re-admit it.  The whole roll is
        asserted compile-free (runtime_stats delta) — a reload that
        builds a kernel or runs an unwarmed signature would stall
        serving and is a structured WeightReloadError, not a silent
        degradation."""
        if self._closed:
            raise FleetClosedError("fleet is closed", closed=True)
        with self._lock:
            if self._rolling:
                raise WeightReloadError(
                    "a reload roll is already in progress")
            self._rolling = True
        new_version = (self.model_version + 1 if version is None
                       else int(version))
        snap = runtime_stats.snapshot()
        t0 = time.perf_counter()
        self._event("serving_fleet_reload", phase="begin",
                    version=new_version)
        per: List[Dict[str, Any]] = []
        try:
            for h in self.replicas:
                if h.dead:
                    per.append({"replica_id": h.replica_id,
                                "skipped": h.dead_reason})
                    continue
                h.reloading = True
                try:
                    evacuated = 0
                    if self.kind == "decode":
                        evacuated = len(h.engine.evacuate())
                    info = h.engine.reload(source, version=new_version)
                finally:
                    h.reloading = False
                self.stats.record_reload(info["pause_ms"])
                self._event("serving_fleet_reload_replica",
                            replica_id=h.replica_id,
                            pause_ms=info["pause_ms"],
                            evacuated=evacuated, version=new_version)
                per.append({"replica_id": h.replica_id,
                            "pause_ms": info["pause_ms"],
                            "evacuated": evacuated})
            compiles = runtime_stats.delta(snap)["compiles"]
            if compiles:
                raise WeightReloadError(
                    f"{compiles} compile(s) observed during the roll — "
                    f"the same-shape zero-recompile contract broke",
                    compiles=compiles, version=new_version)
            self.model_version = new_version
            out = {"version": new_version, "replicas": per,
                   "compiles": 0,
                   "pause_ms_max": max(
                       [p.get("pause_ms", 0.0) for p in per] or [0.0]),
                   "seconds": round(time.perf_counter() - t0, 3)}
            self._event("serving_fleet_reload", phase="done",
                        version=new_version, compiles=0,
                        pause_ms_max=out["pause_ms_max"],
                        seconds=out["seconds"])
            return out
        finally:
            with self._lock:
                self._rolling = False
