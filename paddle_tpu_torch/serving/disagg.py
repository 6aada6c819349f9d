"""Disaggregated prefill/decode serving: the port of
paddle_tpu/serving/disagg.py, a phase-specialized fleet.

Prefill runs are long and compute-bound and stall every co-resident
decode slot's TPOT, while decode chunks are short and memory-bound.
This module splits the fleet by phase:

- **prefill workers** — `DecodeEngine(role="prefill")`: the bucketed
  prompt ladder runs prefill only; every joiner resolves AT the prefill
  boundary with a KV handoff package (pool pages gathered to host rows +
  the requeue descriptor).  Slots and pages recycle per run, so prefill
  TTFT is decoupled from decode occupancy.  On one card the prefill run
  goes through the flash forward kernel.
- **decode workers** — `DecodeEngine(role="decode")`: the chunked step
  loop (the paged attention kernel), admitting ONLY via
  `import_handoff()`.  Imported rows scatter into free pages of the
  worker's own pool through the fixed-shape `paged_import_rows`, so the
  decode worker never builds or warms anything after start: zero
  post-warmup compiles fleet-wide across any join, handoff or failover.
  Each decode worker's step runs take `step_row_block` = the prefill
  workers' slot count, so a decode worker with more slots gives each row
  the bits of a unified engine of the prefill workers' geometry (cuBLAS
  picks its float32 GEMM by the row count, the paged kernel its split
  plan by rows x heads: ROADMAP C8, C15).
- **DisaggFleet** — the phase router: `submit()` routes the prompt to
  the least-loaded prefill worker, relays the handoff package to a
  decode worker (the `kv_transfer` reqtrace span: from_replica ->
  to_replica, pages, bytes), and resolves the caller's future with the
  familiar `FleetResponse`.  Failover keeps the token-parity proof
  across the hop: a decode worker dying mid-generation re-prefills the
  raw prompt on any prefill worker (the pages died with the worker) and
  the regeneration must reproduce the committed prefix token for token;
  a prefill worker dying requeues the raw prompt.  Greedy decode, so the
  client-visible tokens equal an unkilled unified engine's.
- **Autoscaler** — a consumer of `AlertEngine.signals()`: prefill wait
  p99 firing adds a prefill worker, decode TPOT p99 firing adds a decode
  worker, sustained quiet removes one — all zero-reject (`add_worker`
  warms the newcomer while traffic flows on the others, then re-opens
  the fleet-wide zero-compile window; `remove_worker` evacuates in-flight
  sessions through the normal retryable-failover path).  Decisions are
  `autoscale_*` events and scrape as `disagg_*` metrics.

The handoff wire format is DecodeEngine's (serving/decode.py): rows copy
verbatim in pool dtype (int8 codes and scale sidecars bitwise, bf16 as
raw 2-byte records), `bytes` counts valid rows only, and rows past
`committed` are garbage the import drops (NumValid).  All workers share
one card and one process; each runs its own scheduler thread.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..observe.events import RunEventLog
from ..observe.monitoring import LatencyHistogram
from ..resilience.errors import RetriesExhaustedError
from ..resilience.watchdog import retry_call
from .admission import (DEGRADED, RUNNING, CircuitBreaker,
                        CircuitOpenError, DeadlineExceededError,
                        QueueFullError, ServingClosedError, ServingError)
from .decode import DecodeEngine
from .fleet import (FailoverParityError, FleetClosedError, FleetConfig,
                    FleetResponse, FleetSaturatedError, ReplicaHandle)
from .stats import DecodeStats

PREFILL = "prefill"
DECODE = "decode"
_PHASES = (PREFILL, DECODE)


class PhaseWorker(ReplicaHandle):
    """One phase-specialized replica: a ReplicaHandle that knows which
    side of the prefill/decode split it serves."""

    def __init__(self, replica_id: int, engine, config: FleetConfig,
                 phase: str):
        super().__init__(replica_id, engine, config)
        self.phase = phase

    def score(self, clock: Callable[[], float]) -> Dict[str, Any]:
        out = super().score(clock)
        out["phase"] = self.phase
        return out


class DisaggStats:
    """Router-level counters for the disaggregated fleet (per-worker
    engine stats merge separately via DecodeStats.merge); thread-safe."""

    def __init__(self, window: int = 256):
        self._lock = threading.Lock()
        self.window = int(window)
        self.e2e_ms = LatencyHistogram()
        # client-observed TTFT: submit -> the prefill worker's handoff
        # package (which carries the first token) — the JOINT metric
        # the bench compares against the unified fleet
        self.ttft_ms = LatencyHistogram()
        # export gather + router relay + import admission per hop
        self.handoff_ms = LatencyHistogram()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.handoffs = 0
        self.pages_transferred = 0
        self.bytes_transferred = 0
        self.prefill_failovers = 0
        self.decode_failovers = 0
        self.retries = 0
        self.saturated = 0
        self.ejects = 0
        self.parity_checked = 0
        self.parity_failed = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self._emitted_at = 0

    def _bump(self, field: str, by: float = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + by)

    def record_submit(self):
        self._bump("submitted")

    def record_failed(self):
        self._bump("failed")

    def record_ttft(self, ms: float):
        self.ttft_ms.record(ms)

    def record_handoff(self, pages: int, nbytes: int, ms: float):
        self.handoff_ms.record(ms)
        with self._lock:
            self.handoffs += 1
            self.pages_transferred += int(pages)
            self.bytes_transferred += int(nbytes)

    def record_failover(self, phase: str):
        self._bump(f"{phase}_failovers")

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

    def record_scale(self, direction: str):
        self._bump("scale_ups" if direction == "up" else "scale_downs")

    def record_done(self, e2e_ms: float) -> bool:
        """True when this completion crosses a window boundary (the
        caller emits serving_disagg_window)."""
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
                "submitted", "completed", "failed", "handoffs",
                "pages_transferred", "bytes_transferred",
                "prefill_failovers", "decode_failovers", "retries",
                "saturated", "ejects", "parity_checked",
                "parity_failed", "scale_ups", "scale_downs")}
        out["e2e_ms"] = self.e2e_ms.summary()
        out["ttft_ms"] = self.ttft_ms.summary()
        out["handoff_ms"] = self.handoff_ms.summary()
        return out


class _DisaggRequest:
    """Router-side state of one logical request across phases and
    failover attempts."""

    __slots__ = ("prompt", "max_new_tokens", "priority", "future",
                 "deadline", "t_submit", "lock", "resolved", "attempts",
                 "failovers", "prefix", "trace", "hops",
                 "tried_prefill", "tried_decode", "pending_failover",
                 "ttft_recorded")

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 priority: int, deadline: Optional[float], trace=None):
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.priority = int(priority)
        self.future: Future = Future()
        self.deadline = deadline        # absolute time.monotonic()
        self.t_submit = time.monotonic()
        self.lock = threading.Lock()
        self.resolved = False
        self.attempts = 0
        self.failovers = 0              # prefill + decode hops combined
        self.prefix: List[int] = []     # committed tokens from a failed
        #                                 decode attempt (parity proof)
        self.trace = trace
        self.hops: List[int] = []       # replica ids in attempt order
        self.tried_prefill: set = set()
        self.tried_decode: set = set()
        self.pending_failover: Optional[tuple] = None
        self.ttft_recorded = False      # only the FIRST handoff's TTFT

    def remaining_ms(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return (self.deadline - time.monotonic()) * 1e3


class DisaggFleet:
    """Phase router over prefill workers and decode workers.

        mk = lambda role: DecodeEngine(DecoderLM(seed=0), cfg, role=role)
        fleet = DisaggFleet([mk("prefill")], [mk("decode")]).start()
        resp = fleet.submit(prompt_ids, max_new_tokens=64).result()
        resp.tokens      # bit-identical to the unified engine (greedy)
        resp.hops        # [prefill_id, decode_id, ...]
        fleet.close()

    Engines must be constructed with the matching `role` and SHARED KV
    geometry (page_size / max_pages_per_slot / kv_dtype): the import's
    fixed (T_cap, C) row buffers are the export's output shape, and a
    bf16 pool's rows travel as raw 2-byte records the import views as its
    own pool's dtype, so a mismatch is rejected at construction.
    `prefill_factory` / `decode_factory` (zero-arg engine builders)
    enable `add_worker()` — the Autoscaler's zero-reject scale-up path.
    Decode workers take `step_row_block` = the first prefill worker's
    slot count (module docstring).
    """

    kind = "disagg"

    def __init__(self, prefill_engines, decode_engines,
                 config: Optional[FleetConfig] = None,
                 event_log: Optional[RunEventLog] = None,
                 log_path: Optional[str] = None, tracer=None,
                 prefill_factory: Optional[Callable[[], Any]] = None,
                 decode_factory: Optional[Callable[[], Any]] = None):
        if not prefill_engines or not decode_engines:
            raise ValueError("a disagg fleet needs at least one "
                             "prefill worker AND one decode worker")
        self.config = config or FleetConfig()
        self.tracer = tracer
        self._prefill_factory = prefill_factory
        self._decode_factory = decode_factory
        self._own_log = None
        if event_log is None and log_path is not None:
            event_log = self._own_log = RunEventLog(
                log_path, meta={"component": "serving_disagg"})
        self._event_log = event_log
        self.stats = DisaggStats(window=self.config.window)
        self._lock = threading.Lock()
        self._next_id = 0
        self.prefill: List[PhaseWorker] = []
        self.decode: List[PhaseWorker] = []
        self._geometry: Optional[tuple] = None
        self.step_row_block = prefill_engines[0].config.num_slots
        for e in prefill_engines:
            self._add_handle(e, PREFILL)
        for e in decode_engines:
            self._add_handle(e, DECODE)
        self.model_version = max(
            w.engine.model_version for w in self.workers())
        self._closed = False
        self._started = False
        self._metrics_registry = None
        self._metrics_server = None
        self.alert_engine = None
        self.flight_recorder = None

    # -- construction helpers -------------------------------------------
    def _check_geometry(self, engine):
        if not isinstance(engine, DecodeEngine):
            raise ValueError("disagg workers must be DecodeEngines")
        cfg = engine.config
        geo = (cfg.page_size, cfg.max_pages_per_slot, cfg.kv_dtype)
        if self._geometry is None:
            self._geometry = geo
        elif geo != self._geometry:
            raise ValueError(
                f"KV geometry mismatch: worker has (page_size, "
                f"max_pages_per_slot, kv_dtype)={geo}, fleet expects "
                f"{self._geometry} — the export/import row buffers "
                f"are fixed-shape and in pool dtype")

    def _add_handle(self, engine, phase: str) -> PhaseWorker:
        expected = PREFILL if phase == PREFILL else DECODE
        if getattr(engine, "role", None) != expected:
            raise ValueError(
                f"{phase} worker must be DecodeEngine(role="
                f"{expected!r}), got role={getattr(engine, 'role', None)!r}")
        self._check_geometry(engine)
        if phase == DECODE:
            engine.step_row_block = self.step_row_block
        h = PhaseWorker(self._next_id, engine, self.config, phase)
        self._next_id += 1
        engine.set_replica_id(h.replica_id)
        if self._event_log is not None and engine._event_log is None:
            bound = self._event_log.bind(replica_id=h.replica_id)
            engine._event_log = bound
            engine.stats._event_log = bound
        (self.prefill if phase == PREFILL else self.decode).append(h)
        return h

    def workers(self) -> List[PhaseWorker]:
        return self.prefill + self.decode

    def live_workers(self, phase: str) -> int:
        pool = self.prefill if phase == PREFILL else self.decode
        return sum(not h.dead for h in pool)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "DisaggFleet":
        """Warm every cold worker, then open the post-warmup
        zero-compile window for the WHOLE fleet at once."""
        for h in self.workers():
            if not h.engine._started:
                h.engine.start()
        for h in self.workers():
            h.engine.stats.reset_compile_base()
        self._started = True
        self._event("serving_disagg_start",
                    n_prefill=len(self.prefill),
                    n_decode=len(self.decode),
                    model_version=self.model_version,
                    max_failovers=self.config.max_failovers)
        return self

    def close(self, timeout_s: float = 60.0,
              close_replicas: bool = True):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if close_replicas:
            for h in self.workers():
                h.engine.close(timeout_s)
        if self.alert_engine is not None:
            self.alert_engine.close()
        if self.flight_recorder is not None:
            self.flight_recorder.close()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        self._event("serving_disagg_close", **self.snapshot())
        if self._own_log is not None:
            self._own_log.close()

    def __enter__(self) -> "DisaggFleet":
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
        return {"kind": self.kind, "closed": self._closed,
                "model_version": self.model_version,
                "healthy_prefill": sum(h.routable()
                                       for h in self.prefill),
                "healthy_decode": sum(h.routable()
                                      for h in self.decode),
                "prefill": [h.score(clock) for h in self.prefill],
                "decode": [h.score(clock) for h in self.decode]}

    def merged_stats(self, phase: Optional[str] = None) -> DecodeStats:
        """One DecodeStats holding every worker's telemetry (or one
        phase's), merged exactly — histogram bin-wise addition."""
        agg = DecodeStats()
        pool = (self.workers() if phase is None
                else (self.prefill if phase == PREFILL else self.decode))
        for h in pool:
            agg.merge(h.engine.stats)
        return agg

    def metrics_registry(self):
        """The disagg metrics surface: router counters + per-phase
        merged latency histograms (`disagg_*`), the fleet-merged
        engine stats (`serving_*`), request tracing, and the
        process-wide collectors.  Built once, cached."""
        if self._metrics_registry is None:
            from ..observe.registry import (MetricsRegistry,
                                            disagg_collector,
                                            serving_stats_collector,
                                            standard_collectors,
                                            tracer_collector)

            reg = standard_collectors(MetricsRegistry())
            reg.register("disagg", disagg_collector(self))
            reg.register("serving",
                         serving_stats_collector(self.merged_stats,
                                                 scope="disagg"))
            if self.tracer is not None:
                reg.register("reqtrace",
                             tracer_collector(self.tracer))
            self._metrics_registry = reg
        return self._metrics_registry

    def start_metrics_server(self, host: str = "127.0.0.1",
                             port: int = 0):
        """Opt-in /metrics + /healthz (+ /alerts) endpoint over this
        fleet's registry; binds localhost unless told otherwise."""
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
        """Alerts on the disagg fleet: an AlertEngine over
        `observe.disagg_rule_pack` (prefill wait p99 / decode TPOT p99
        / handoff p99 / compile tripwire) — the Autoscaler's signal
        source.  `start=False` lets tests (and the Autoscaler's
        manual-drive mode) call `alert_engine.evaluate()` themselves."""
        if self.alert_engine is not None:
            return self.alert_engine
        from ..observe.alerts import AlertEngine, disagg_rule_pack
        from ..observe.flightrec import FlightRecorder

        if rules is None:
            rules = disagg_rule_pack(self, **pack_kw)
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
        out = self.stats.snapshot()
        out["engines"] = self.merged_stats().snapshot()
        out["post_warmup_compiles"] = \
            out["engines"]["post_warmup_compiles"]
        out["model_version"] = self.model_version
        out["n_prefill"] = self.live_workers(PREFILL)
        out["n_decode"] = self.live_workers(DECODE)
        out["healthy_prefill"] = sum(h.routable() for h in self.prefill)
        out["healthy_decode"] = sum(h.routable() for h in self.decode)
        return out

    # -- request path ---------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 32,
               priority: int = 0,
               deadline_ms: Optional[float] = None) -> Future:
        """Route one prompt through the phase pipeline; returns a
        Future of a FleetResponse whose `.tokens` are bit-identical to
        the unified engine's greedy output.  Raises the structured
        FleetSaturatedError synchronously when every prefill worker
        sheds (the fast-reject contract); once ACCEPTED, a request is
        never dropped for momentary saturation — handoffs and
        failovers retry under the deadline budget."""
        if self._closed or not self._started:
            raise FleetClosedError(
                "disagg fleet is closed" if self._closed
                else "disagg fleet not started", closed=self._closed)
        ms = (deadline_ms if deadline_ms is not None
              else self.config.default_deadline_ms)
        deadline = time.monotonic() + ms / 1e3 if ms else None
        trace = None
        if self.tracer is not None:
            trace = self.tracer.new_trace("disagg")
            trace.fleet_owned = True
        dreq = _DisaggRequest(np.asarray(prompt), max_new_tokens,
                              priority, deadline, trace=trace)
        self.stats.record_submit()
        self._route_prefill(dreq)
        return dreq.future

    def generate(self, prompt, max_new_tokens: int = 32,
                 timeout_s: Optional[float] = None,
                 **kw) -> FleetResponse:
        """Synchronous submit()+result() convenience."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           **kw).result(timeout_s)

    # -- routing --------------------------------------------------------
    def _candidates(self, pool: List[PhaseWorker],
                    tried: set) -> List[PhaseWorker]:
        with self._lock:
            avail = [h for h in pool if h.routable()]
            fresh = [h for h in avail if h.replica_id not in tried]
            cands = fresh if fresh else avail
            return sorted(cands, key=lambda h: (h.inflight, h.routed,
                                                h.replica_id))

    def _route_phase(self, dreq: _DisaggRequest, phase: str,
                     attempt: Callable[[PhaseWorker, Optional[float]],
                                       Future],
                     done_cb) -> PhaseWorker:
        """One routing pass over one phase's workers: least-loaded
        first, preferring ones this request has not tried; accept the
        first that admits, raise FleetSaturatedError with per-worker
        evidence otherwise."""
        if self._closed:
            raise FleetClosedError("disagg fleet is closed",
                                   closed=True)
        t_route = time.monotonic()
        remaining_ms = dreq.remaining_ms()
        if remaining_ms is not None and remaining_ms <= 0:
            raise DeadlineExceededError(
                "request deadline expired before a worker could be "
                "(re)tried", attempts=dreq.attempts,
                failovers=dreq.failovers)
        pool = self.prefill if phase == PREFILL else self.decode
        tried = (dreq.tried_prefill if phase == PREFILL
                 else dreq.tried_decode)
        reasons: List[Dict[str, Any]] = []
        retry_after: List[float] = []
        for h in self._candidates(pool, tried):
            if h.breaker.state != CircuitBreaker.CLOSED \
                    and not h.breaker.allow():
                reasons.append({"replica_id": h.replica_id,
                                "reject": "fleet_breaker_open"})
                retry_after.append(h.breaker.cooldown_remaining_s())
                continue
            try:
                fut = attempt(h, remaining_ms)
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
                tried.add(h.replica_id)
                dreq.attempts += 1
                dreq.hops.append(h.replica_id)
            if dreq.trace is not None:
                now = time.monotonic()
                dreq.trace.add("route", t_route, now,
                               replica_id=h.replica_id, phase=phase)
                pf = dreq.pending_failover
                if pf is not None:
                    # the failover hop closes when the request LANDS
                    # on its next worker — one span from detection to
                    # requeue across the phase rows
                    dreq.pending_failover = None
                    t_det, dead_id, reason = pf
                    dreq.trace.add("failover", t_det, now,
                                   from_replica=dead_id,
                                   to_replica=h.replica_id,
                                   reason=reason)
            fut.add_done_callback(
                lambda f, h=h: done_cb(dreq, h, f))
            return h
        self.stats.record_saturated()
        clock = self.config.clock
        err = FleetSaturatedError(
            f"all {len(pool)} {phase} worker(s) shed this request",
            phase=phase,
            retry_after_s=(round(min(retry_after), 3)
                           if retry_after else None),
            rejects=reasons,
            replicas=[h.score(clock) for h in pool])
        self._event("serving_disagg_saturated", **err.as_dict())
        raise err

    def _route_prefill(self, dreq: _DisaggRequest) -> PhaseWorker:
        return self._route_phase(
            dreq, PREFILL,
            lambda h, rem: h.engine.submit(
                dreq.prompt, max_new_tokens=dreq.max_new_tokens,
                priority=dreq.priority, deadline_ms=rem,
                _trace=dreq.trace),
            self._on_prefill_done)

    def _route_decode(self, dreq: _DisaggRequest,
                      handoff: Dict[str, Any]) -> PhaseWorker:
        return self._route_phase(
            dreq, DECODE,
            lambda h, rem: h.engine.import_handoff(
                handoff, deadline_ms=rem, _trace=dreq.trace),
            self._on_decode_done)

    # -- phase completions ----------------------------------------------
    def _on_prefill_done(self, dreq: _DisaggRequest, h: PhaseWorker,
                         fut: Future):
        with self._lock:
            h.inflight -= 1
        exc = fut.exception()
        if exc is None:
            h.breaker.record_success()
            h.last_ok_t = self.config.clock()
            handoff = fut.result()
            # joint TTFT: the handoff package carries the first token,
            # so the client-observed first-token time is NOW (recorded
            # once — a failover's re-prefill does not reset it)
            if not dreq.ttft_recorded:
                dreq.ttft_recorded = True
                self.stats.record_ttft(
                    (time.monotonic() - dreq.t_submit) * 1e3)
            if handoff["done"]:
                # satisfied by its very first token (or eos): no pages
                # cross, the router resolves directly
                self._finish_ok(
                    dreq, h,
                    np.asarray(handoff["generated"], np.int32),
                    version=handoff["model_version"])
                return
            self._relay_handoff(dreq, handoff)
            return
        self._on_phase_error(dreq, h, exc, PREFILL)

    def _relay_handoff(self, dreq: _DisaggRequest,
                       handoff: Dict[str, Any]):
        """Hand the KV package to a decode worker.  Runs on the
        prefill worker's scheduler thread (future callbacks are
        inline), so a momentarily saturated decode side retries on a
        separate thread — never blocking the prefill scheduler."""
        t0 = time.monotonic()
        try:
            h2 = self._route_decode(dreq, handoff)
        except FleetSaturatedError:
            t = threading.Thread(
                target=self._requeue,
                args=(dreq, lambda: self._relay_handoff(dreq, handoff)),
                name="disagg-handoff-retry", daemon=True)
            t.start()
            return
        except ServingError as e:
            self._finish_err(dreq, e)
            return
        t1 = time.monotonic()
        if dreq.trace is not None:
            # no replica_id attr: the transfer is the ROUTER's hop and
            # draws on the router row, bridging the two phase rows
            dreq.trace.add("kv_transfer", t0, t1,
                           from_replica=handoff["from_replica"],
                           to_replica=h2.replica_id,
                           pages=handoff["n_pages"],
                           bytes=handoff["bytes"])
        ms = float(handoff.get("export_ms", 0.0)) + (t1 - t0) * 1e3
        self.stats.record_handoff(handoff["n_pages"],
                                  handoff["bytes"], ms)
        self._event("serving_disagg_handoff",
                    from_replica=handoff["from_replica"],
                    to_replica=h2.replica_id,
                    pages=handoff["n_pages"],
                    bytes=handoff["bytes"],
                    handoff_ms=round(ms, 3))

    def _on_decode_done(self, dreq: _DisaggRequest, h: PhaseWorker,
                        fut: Future):
        with self._lock:
            h.inflight -= 1
        exc = fut.exception()
        if exc is None:
            h.breaker.record_success()
            h.last_ok_t = self.config.clock()
            self._finish_ok(
                dreq, h, np.asarray(fut.result()),
                version=getattr(fut, "model_version",
                                h.engine.model_version))
            return
        self._on_phase_error(dreq, h, exc, DECODE)

    def _on_phase_error(self, dreq: _DisaggRequest, h: PhaseWorker,
                        exc: BaseException, phase: str):
        """Shared failover policy: retryable worker deaths re-prefill
        the RAW prompt (a dead decode worker's pages are gone — the
        prefill side rebuilds them; greedy ⇒ token-identical), bounded
        by max_failovers; anything else surfaces structured."""
        with dreq.lock:
            already = dreq.resolved
        if already:
            if dreq.trace is not None:
                dreq.trace.point(
                    "abandoned", replica_id=h.replica_id,
                    error=type(exc).__name__)
            return
        retryable = (isinstance(exc, ServingError)
                     and getattr(exc, "retryable", False))
        if not retryable:
            self._finish_err(dreq, exc)
            return
        evacuated = exc.details.get("reason") == "evacuated"
        if not evacuated:
            # an evacuation is a deliberate control action (scale-down
            # / manual eject), not evidence against worker health
            with self._lock:
                h.failures += 1
            h.breaker.record_failure()
            state = h.engine.admission.state
            if state not in (RUNNING, DEGRADED) and not h.dead:
                self._eject(h, reason=f"engine {state} after {exc.kind}")
        desc = exc.details.get("descriptor") or {}
        with dreq.lock:
            gen = desc.get("generated") or []
            if len(gen) > len(dreq.prefix):
                # the dead decode worker's committed tokens: the
                # regeneration must reproduce them exactly
                dreq.prefix = [int(t) for t in gen]
        dreq.failovers += 1
        if dreq.trace is not None and dreq.pending_failover is None:
            dreq.pending_failover = (time.monotonic(), h.replica_id,
                                     exc.kind)
        self.stats.record_failover(phase)
        self._event("serving_disagg_failover",
                    replica_id=h.replica_id, phase=phase,
                    reason=exc.kind,
                    committed_tokens=len(dreq.prefix),
                    attempts=dreq.attempts, failovers=dreq.failovers)
        if dreq.failovers > self.config.max_failovers:
            self._finish_err(dreq, exc)
            return
        # re-prefill from the raw prompt on a separate thread: this
        # callback fires on the dying engine's scheduler thread, and
        # the retry backoff must never block it
        t = threading.Thread(
            target=self._requeue,
            args=(dreq, lambda: self._route_prefill(dreq)),
            name="disagg-requeue", daemon=True)
        t.start()

    def _requeue(self, dreq: _DisaggRequest, route: Callable[[], Any]):
        """Deadline-budgeted requeue: an accepted request is never
        dropped because the fleet was saturated for a moment."""
        try:
            retry_call(
                route,
                retries=self.config.failover_route_retries,
                base_delay_s=self.config.retry_base_delay_s,
                max_delay_s=1.0,
                retry_on=(FleetSaturatedError,),
                on_retry=lambda _a, _e, _d: self.stats.record_retry())
        except RetriesExhaustedError as e2:
            last = e2.__cause__
            self._finish_err(dreq, last if isinstance(last, ServingError)
                             else e2)
        except ServingError as e2:
            self._finish_err(dreq, e2)

    # -- resolution -----------------------------------------------------
    def _finish_ok(self, dreq: _DisaggRequest, h: PhaseWorker,
                   tokens: np.ndarray, version: int):
        with dreq.lock:
            if dreq.resolved:
                return
            dreq.resolved = True
        if dreq.prefix:
            got = [int(t) for t in tokens[:len(dreq.prefix)]]
            ok = got == dreq.prefix
            self.stats.record_parity(ok)
            if not ok:
                err = FailoverParityError(
                    f"regenerated tokens diverged from the "
                    f"{len(dreq.prefix)}-token committed prefix of "
                    f"the failed worker", expected=dreq.prefix,
                    got=got, replica_id=h.replica_id)
                self._event("serving_disagg_failover",
                            replica_id=h.replica_id, parity="FAILED",
                            **err.details)
                self.stats.record_failed()
                if dreq.trace is not None and self.tracer is not None:
                    self.tracer.finish(dreq.trace, error=err)
                dreq.future.set_exception(err)
                return
        if dreq.trace is not None:
            dreq.trace.point("complete", replica_id=h.replica_id,
                             failovers=dreq.failovers)
        resp = FleetResponse(
            tokens, replica_id=h.replica_id,
            model_version=int(version),
            failovers=dreq.failovers, hedged=False,
            attempts=dreq.attempts,
            trace_id=(dreq.trace.trace_id if dreq.trace is not None
                      else None),
            hops=list(dreq.hops))
        if dreq.trace is not None and self.tracer is not None:
            self.tracer.finish(dreq.trace)
        dreq.future.set_result(resp)
        if self.stats.record_done(
                (time.monotonic() - dreq.t_submit) * 1e3):
            self._event("serving_disagg_window", **self.snapshot())

    def _finish_err(self, dreq: _DisaggRequest, exc: BaseException):
        with dreq.lock:
            if dreq.resolved:
                return
            dreq.resolved = True
        self.stats.record_failed()
        if dreq.trace is not None and self.tracer is not None:
            self.tracer.finish(dreq.trace, error=exc)
        dreq.future.set_exception(exc)

    # -- eject / scale --------------------------------------------------
    def _eject(self, h: PhaseWorker, reason: str):
        with self._lock:
            if h.dead:
                return
            h.dead = True
            h.dead_reason = reason
        self.stats.record_eject()
        self._event("serving_disagg_eject", replica_id=h.replica_id,
                    phase=h.phase, reason=reason)

    def add_worker(self, phase: str, engine=None) -> PhaseWorker:
        """Zero-reject scale-up: build (factory) and warm a new worker
        while traffic flows on the others, then re-open the fleet-wide
        post-warmup zero-compile window (the newcomer's warmup
        compiles bump the process-global counter; the reset keeps
        every worker's contract honest — the Fleet.start idiom)."""
        if phase not in _PHASES:
            raise ValueError(f"phase must be one of {_PHASES}")
        if self._closed:
            raise FleetClosedError("disagg fleet is closed",
                                   closed=True)
        if engine is None:
            factory = (self._prefill_factory if phase == PREFILL
                       else self._decode_factory)
            if factory is None:
                raise ValueError(
                    f"add_worker({phase!r}) needs a {phase}_factory "
                    f"(or an explicit engine)")
            engine = factory()
        h = self._add_handle(engine, phase)
        if not engine._started:
            engine.start()
        for w in self.workers():
            w.engine.stats.reset_compile_base()
        self.model_version = max(self.model_version,
                                 engine.model_version)
        self.stats.record_scale("up")
        self._event("serving_disagg_worker_join",
                    replica_id=h.replica_id, phase=phase,
                    n_prefill=self.live_workers(PREFILL),
                    n_decode=self.live_workers(DECODE))
        return h

    def remove_worker(self, phase: str,
                      replica_id: Optional[int] = None) -> int:
        """Zero-reject scale-down: retire one worker (the newest live
        one unless pinned), evacuate its in-flight sessions through
        the normal retryable-failover path (clients see nothing), and
        close its engine.  Refuses to remove the last worker of a
        phase."""
        if phase not in _PHASES:
            raise ValueError(f"phase must be one of {_PHASES}")
        pool = self.prefill if phase == PREFILL else self.decode
        with self._lock:
            live = [h for h in pool if not h.dead]
            if len(live) <= 1:
                raise ValueError(
                    f"refusing to remove the last live {phase} worker")
            if replica_id is None:
                h = live[-1]
            else:
                h = next((x for x in live
                          if x.replica_id == replica_id), None)
                if h is None:
                    raise ValueError(
                        f"no live {phase} worker {replica_id}")
            h.dead = True
            h.dead_reason = "scaled_down"
        h.engine.evacuate()
        h.engine.close()
        self.stats.record_scale("down")
        self._event("serving_disagg_worker_leave",
                    replica_id=h.replica_id, phase=phase,
                    reason="scaled_down",
                    n_prefill=self.live_workers(PREFILL),
                    n_decode=self.live_workers(DECODE))
        return h.replica_id


class Autoscaler:
    """SLO-driven per-phase scaling policy over a DisaggFleet, a
    consumer of `AlertEngine.signals()`.

        fleet.enable_alerts(start=False)
        scaler = Autoscaler(fleet, fleet.alert_engine,
                            max_workers={"prefill": 3, "decode": 3})
        scaler.evaluate()        # or scaler.start(interval_s=5)

    Policy (deliberately boring — hysteresis over flapping):
    - the phase's rule FIRING and the cooldown elapsed and headroom
      under `max_workers` → `add_worker(phase)` (zero-reject: the
      newcomer warms while traffic flows), an `autoscale_up` event;
    - the rule quiet for `quiet_s` straight and above `min_workers`
      and the cooldown elapsed → `remove_worker(phase)` (evacuation
      fails sessions over invisibly), an `autoscale_down` event.

    `clock` and the `signals=` override on evaluate() make every
    decision deterministic in tests; `evaluate()` returns the decision
    list for the same reason.
    """

    RULE_IDS = {PREFILL: "disagg_prefill_wait_p99",
                DECODE: "disagg_decode_tpot_p99"}

    def __init__(self, fleet: DisaggFleet, alert_engine=None, *,
                 rule_ids: Optional[Dict[str, str]] = None,
                 min_workers: Optional[Dict[str, int]] = None,
                 max_workers: Optional[Dict[str, int]] = None,
                 cooldown_s: float = 30.0, quiet_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 event_log: Optional[RunEventLog] = None):
        self.fleet = fleet
        self.alert_engine = alert_engine
        self.rule_ids = dict(self.RULE_IDS)
        if rule_ids:
            self.rule_ids.update(rule_ids)
        self.min_workers = {PREFILL: 1, DECODE: 1,
                            **(min_workers or {})}
        self.max_workers = {PREFILL: 4, DECODE: 4,
                            **(max_workers or {})}
        self.cooldown_s = float(cooldown_s)
        self.quiet_s = float(quiet_s)
        self.clock = clock
        self._event_log = (event_log if event_log is not None
                           else fleet._event_log)
        self._last_action: Dict[str, Optional[float]] = {
            PREFILL: None, DECODE: None}
        self._quiet_since: Dict[str, Optional[float]] = {
            PREFILL: None, DECODE: None}
        self.decisions: List[Dict[str, Any]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _event(self, kind: str, **fields: Any):
        if self._event_log is not None:
            self._event_log.event(kind, **fields)

    def _cooled(self, phase: str, now: float) -> bool:
        last = self._last_action[phase]
        return last is None or (now - last) >= self.cooldown_s

    def evaluate(self, now: Optional[float] = None,
                 signals: Optional[Dict[str, Dict[str, Any]]] = None
                 ) -> List[Dict[str, Any]]:
        """One policy pass; returns this pass's decisions (possibly
        empty).  `signals` defaults to the attached AlertEngine's
        current `signals()` — tests inject scripted dicts instead."""
        now = self.clock() if now is None else float(now)
        if signals is None:
            signals = (self.alert_engine.signals()
                       if self.alert_engine is not None else {})
        out: List[Dict[str, Any]] = []
        for phase in _PHASES:
            sig = signals.get(self.rule_ids[phase]) or {}
            firing = bool(sig.get("firing"))
            live = self.fleet.live_workers(phase)
            if firing:
                self._quiet_since[phase] = None
                if live < self.max_workers[phase] \
                        and self._cooled(phase, now):
                    h = self.fleet.add_worker(phase)
                    self._last_action[phase] = now
                    d = {"action": "up", "phase": phase,
                         "replica_id": h.replica_id,
                         "rule": self.rule_ids[phase],
                         "value": sig.get("value"),
                         "n_workers": live + 1}
                    self._event("autoscale_up", **d)
                    out.append(d)
                continue
            if self._quiet_since[phase] is None:
                self._quiet_since[phase] = now
                continue
            if (now - self._quiet_since[phase]) >= self.quiet_s \
                    and live > self.min_workers[phase] \
                    and self._cooled(phase, now):
                rid = self.fleet.remove_worker(phase)
                self._last_action[phase] = now
                self._quiet_since[phase] = now
                d = {"action": "down", "phase": phase,
                     "replica_id": rid,
                     "rule": self.rule_ids[phase],
                     "n_workers": live - 1}
                self._event("autoscale_down", **d)
                out.append(d)
        self.decisions.extend(out)
        return out

    def start(self, interval_s: float = 5.0) -> "Autoscaler":
        """Background policy loop (the simulated production mode);
        tests drive `evaluate()` manually instead."""
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:  # noqa: BLE001 — the policy must not die
                    pass

        self._thread = threading.Thread(target=loop, name="autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
