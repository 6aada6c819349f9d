"""ServingEngine: shape-bucketed dynamic batching over the Predictor.

The port of paddle_tpu/serving/engine.py.  Every novel input signature
costs the port a cold run (kernel builds, cuBLAS/cuDNN set-up), and a
frontend that lets request shapes leak into the program's runs pays it
again and again.  The engine closes the shape space up front:

- a **bounded bucket ladder** — batch sizes × (optionally) sequence
  lengths, `BucketConfig`.  Every dispatch is padded UP to the smallest
  bucket that fits, so the set of signatures the device ever sees is
  exactly the ladder, warmed at `start()` through
  `Predictor.compile_signature` (one run on zeros per bucket),
- **ragged requests ride the repo's padded-dense convention** — an
  input with a `<name>.seq_len` companion in the saved model's feed
  list is ragged on its leading (time) axis; the engine pads each
  request to the seq bucket and synthesizes the int32 companion with
  true lengths, so kernels mask padding exactly as in training
  (lod_level=1; nested lod_level=2 serving is rejected loudly),
- a request that fits NO bucket (wrong dense shape, over-long
  sequence) fails fast at submit() with a structured
  `BucketMissError` — it never occupies queue capacity and never
  reaches the device.

Steady state is therefore ZERO compiles (`observe.runtime_stats`: runs
at an unwarmed signature and kernel builds); a post-warmup compile is
emitted as a loud `serving_compile_post_warmup` event.

Threading: `submit()`/`infer()` are safe from any number of frontend
threads; one batcher worker owns dispatch (one dispatcher keeps the
device queue ordered and the occupancy story simple), and the
Predictor enters `torch.no_grad()` on that thread itself.

Metrics and alerts (observe/registry.py, alerts.py, flightrec.py):
`metrics_registry()`, the opt-in `start_metrics_server()` and
`enable_alerts()`, all host-side.

The memory gate (`memory_budget_bytes`): before the ladder's warmup,
start() runs the Predictor's program at batch 1 and 2 of every sequence
bucket under `no_grad`, each once unrecorded and once recorded
(observe/memory.py `measure_run`: the card's allocator, the ledger on
the CPU, the parameters and feeds counted in), extrapolates each
event's peak in batch (`fit_peaks`, as `plan_fit`) and raises
`BucketMemoryError` for a bucket predicted past the budget, the
reference's planner (paddle_tpu/serving/engine.py:647-731).  On the
card the budget is the card's own memory unless given.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..inference import AnalysisConfig, FeedSpec, Predictor
from ..observe.events import RunEventLog
from ..observe.monitoring import runtime_stats
from .admission import (AdmissionController, CircuitBreaker,
                        ExecutorFailureError, ServingError,
                        WeightReloadError)
from .batcher import DynamicBatcher, Request
from .stats import ServingStats


class BucketMissError(ServingError):
    """The request fits no configured shape bucket (structured: carries
    the offending input, its shape, and the allowed buckets)."""

    kind = "bucket_miss"


class BucketMemoryError(ServingError):
    """A configured bucket's PREDICTED peak memory exceeds the device
    budget (structured: the offending buckets with predicted bytes, the
    budget, the probe evidence).  The observe.memory fit planner that
    raises it comes with ROADMAP A step 11; the class is here for
    callers that catch it."""

    kind = "bucket_memory"


class BucketConfig:
    """The bounded shape ladder the engine is allowed to compile.

    batch_sizes: ascending batch buckets; the largest is also the
        batcher's max_batch_size.
    seq_lens: ascending sequence-length buckets for ragged inputs
        (None for dense-only models).
    max_buckets: hard cap on |batch_sizes| × |seq_lens| — warmup
        runs every combination, and an unbounded ladder is exactly the
        shape churn this subsystem exists to prevent.
    """

    def __init__(self, batch_sizes: Sequence[int] = (1, 2, 4, 8),
                 seq_lens: Optional[Sequence[int]] = None,
                 max_buckets: int = 32):
        self.batch_sizes = self._ladder("batch_sizes", batch_sizes)
        self.seq_lens = (self._ladder("seq_lens", seq_lens)
                         if seq_lens is not None else None)
        n = len(self.batch_sizes) * max(1, len(self.seq_lens or ()))
        if n > max_buckets:
            raise ValueError(
                f"{n} shape buckets exceed max_buckets={max_buckets}: "
                f"every bucket is a warmup run and a signature the "
                f"device keeps set-up for — thin the ladder or raise the "
                f"cap deliberately")
        self.n_buckets = n

    @staticmethod
    def _ladder(name: str, vals) -> Tuple[int, ...]:
        vals = tuple(int(v) for v in vals)
        if not vals or any(v < 1 for v in vals) \
                or list(vals) != sorted(set(vals)):
            raise ValueError(
                f"{name} must be ascending unique positive ints, "
                f"got {vals}")
        return vals

    @staticmethod
    def pick(ladder: Tuple[int, ...], need: int) -> Optional[int]:
        """Smallest bucket >= need (minimum padding waste), or None."""
        for v in ladder:
            if v >= need:
                return v
        return None


class ServingEngine:
    """Dynamic-batching serving endpoint over a saved inference model.

        engine = ServingEngine(model_dir,
                               example_feed={"x": np.zeros(16, "f4")},
                               buckets=BucketConfig((1, 2, 4, 8)))
        engine.start()                      # warmup: run the ladder
        y = engine.infer({"x": x})          # or submit() -> Future
        engine.close()                      # drain, then stop

    model: a saved-model dir (served on CUDAPlace(0)), an
        AnalysisConfig (which carries the place), or an existing
        Predictor.
    example_feed: one PER-EXAMPLE array per model input (no batch dim;
        ragged inputs use their natural (L, ...) shape) — the dtype and
        trailing-shape template requests are validated against.
    max_wait_ms: batch window — a request waits at most this long for
        co-batching before dispatching underfull.
    queue_capacity: bound on accepted-but-unresolved requests; beyond
        it submit() fast-rejects with QueueFullError (load shedding).
    default_deadline_ms: per-request deadline when the caller sets
        none; expired requests are dropped before dispatch.
    event_log / log_path: observe.RunEventLog (or a path to create
        one) for serving_* telemetry events.
    donate_feeds: accepted for the reference's signature; the port's
        eager runs have no executable to donate request buffers to.
    breaker: serving circuit breaker (admission.CircuitBreaker) —
        `breaker.failure_threshold` CONSECUTIVE dispatch failures flip
        admission to DEGRADED (submits fast-reject with a structured
        CircuitOpenError) until a half-open probe succeeds.  Default: a
        CircuitBreaker(failure_threshold=5, cooldown_s=5).  Pass
        breaker=False to disable.
    warmup_deadline_s: wall-clock budget for the start() bucket-ladder
        warmup (resilience.Deadline): a hung warmup (a kernel build)
        raises a structured WatchdogTimeout instead of stalling the
        rollout.
    tracer: an observe.ReqTracer — per-request tracing (observe
        pillar 7): every request carries a RequestTrace with host
        spans at the queue boundaries (queue_wait / batch_form /
        dispatch).  Purely host-side — zero extra device dispatches,
        zero retraces, identical step lowering (pinned by tests).
        None (default) disables tracing; a Fleet passes its own
        traces through `submit(_trace=...)` regardless.
    memory_budget_bytes: device memory budget the bucket ladder must
        fit (None: the card's memory; the CPU has none, and start()
        records `fit_plan = {"skipped": "no device budget known"}`);
        False skips validation entirely, as in the reference.
    """

    def __init__(self, model: Union[str, AnalysisConfig, Predictor],
                 example_feed: Dict[str, np.ndarray],
                 buckets: Optional[BucketConfig] = None,
                 max_wait_ms: float = 5.0, queue_capacity: int = 128,
                 default_deadline_ms: Optional[float] = None,
                 event_log: Optional[RunEventLog] = None,
                 log_path: Optional[str] = None,
                 stats_window: int = 256,
                 donate_feeds: Optional[bool] = None,
                 breaker: Union[CircuitBreaker, bool, None] = None,
                 warmup_deadline_s: Optional[float] = None,
                 memory_budget_bytes: Union[int, bool, None] = None,
                 tracer=None):
        # duck-typed: anything with run()/compile_signature() serves
        # (a resilience.FlakyPredictor proxy in chaos tests, a custom
        # wrapper in production)
        self.predictor = (model if isinstance(model, Predictor)
                          or (hasattr(model, "run")
                              and hasattr(model, "compile_signature"))
                          else Predictor(model))
        self.buckets = buckets or BucketConfig()
        feed_names = self.predictor.get_input_names()
        nested = [n for n in feed_names if n.endswith(".seq_len2")]
        if nested:
            raise NotImplementedError(
                f"nested (lod_level=2) serving inputs not supported: "
                f"{nested}")
        companions = {n for n in feed_names if n.endswith(".seq_len")}
        self._data_names = [n for n in feed_names
                            if n not in companions]
        self._ragged = {n for n in self._data_names
                        if f"{n}.seq_len" in companions}
        orphan = companions - {f"{n}.seq_len" for n in self._ragged}
        if orphan:
            raise ValueError(f"seq_len companions without a data input: "
                             f"{sorted(orphan)}")
        missing = set(self._data_names) - set(example_feed)
        if missing:
            raise ValueError(
                f"example_feed missing inputs: {sorted(missing)} "
                f"(model feeds: {self._data_names})")
        self._templates = {n: np.asarray(example_feed[n])
                           for n in self._data_names}
        if self._ragged and self.buckets.seq_lens is None:
            raise ValueError(
                f"model has ragged inputs {sorted(self._ragged)} but "
                f"BucketConfig has no seq_lens ladder")
        if not self._ragged and self.buckets.seq_lens is not None:
            raise ValueError(
                "BucketConfig.seq_lens given but the model has no "
                "ragged (.seq_len companion) inputs")
        for n in self._ragged:
            if self._templates[n].ndim < 1:
                raise ValueError(f"ragged input {n!r} example must have "
                                 f"a leading sequence axis")

        self._donate = bool(donate_feeds)

        self._own_log = None
        if event_log is None and log_path is not None:
            event_log = self._own_log = RunEventLog(
                log_path, meta={"component": "serving_engine"})
        self.stats = ServingStats(event_log=event_log,
                                  window=stats_window)
        self._event_log = event_log
        if breaker is None:
            breaker = CircuitBreaker(failure_threshold=5, cooldown_s=5.0)
        elif breaker is False:
            breaker = None
        self.warmup_deadline_s = warmup_deadline_s
        self.memory_budget_bytes = memory_budget_bytes
        self.tracer = tracer
        self.fit_plan: Optional[Dict[str, Any]] = None
        self.admission = AdmissionController(
            queue_capacity, default_deadline_ms=default_deadline_ms,
            breaker=breaker)
        self.batcher = DynamicBatcher(
            self._dispatch, self.admission,
            max_batch_size=self.buckets.batch_sizes[-1],
            max_wait_ms=max_wait_ms,
            on_deadline_miss=self._on_deadline_miss)
        self._started = False
        self._lock = threading.Lock()
        # fleet surface: replica identity + live weight version
        self.replica_id: Optional[int] = None
        self.model_version = 0
        # metrics and alerts (opt-in, standalone engines; fleets front
        # their own registry and alert engine instead)
        self._metrics_registry = None
        self._metrics_server = None
        self.alert_engine = None
        self.flight_recorder = None

    def set_replica_id(self, replica_id: int) -> None:
        """Name this engine as fleet replica `replica_id` and stamp the
        id on every event it (and its stats) emits — N replicas sharing
        one RunEventLog stay disambiguated."""
        self.replica_id = int(replica_id)
        if self._event_log is not None \
                and hasattr(self._event_log, "bind"):
            bound = self._event_log.bind(replica_id=self.replica_id)
            self._event_log = bound
            self.stats._event_log = bound

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "ServingEngine":
        """Warmup: run every bucket once, then open for traffic.  After
        this returns, steady-state serving performs zero compiles (any
        later one is a shape leak and is reported)."""
        with self._lock:
            if self._started:
                raise RuntimeError("engine already started")
            self._started = True
        if self._event_log is not None:
            self._event_log.event(
                "serving_start",
                buckets={"batch_sizes": list(self.buckets.batch_sizes),
                         "seq_lens": list(self.buckets.seq_lens)
                         if self.buckets.seq_lens else None},
                queue_capacity=self.admission.queue_capacity,
                max_wait_ms=self.batcher.max_wait_ms,
                inputs=self._data_names,
                ragged=sorted(self._ragged),
                donate_feeds=self._donate)
        snap = runtime_stats.snapshot()
        t0 = time.perf_counter()
        from ..resilience.watchdog import Deadline

        with Deadline(self.warmup_deadline_s or 0,
                      what="serving warmup (bucket-ladder runs)"):
            self._validate_memory_budget()
            for spec in self._bucket_specs():
                self.predictor.compile_signature(
                    spec, donate_feeds=self._donate)
        seconds = time.perf_counter() - t0
        delta = runtime_stats.delta(snap)
        self.stats.record_warmup(self.buckets.n_buckets,
                                 delta["compiles"],
                                 delta["compile_time_s"], seconds)
        self.admission.start()
        self.batcher.start()
        return self

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Graceful shutdown, phase 1: stop admission (new submits get
        ServingClosedError), flush open batch windows, wait for every
        accepted request to resolve.  Idempotent."""
        self.admission.begin_drain()
        ok = self.batcher.drain(timeout_s)
        if self._event_log is not None:
            self.stats.emit("serving_drain", drained=ok)
        return ok

    def close(self, timeout_s: float = 60.0):
        """drain() + stop the worker.  Every future an accepted request
        ever got is resolved by the time this returns — with a result,
        or with a structured ServingError."""
        if self.admission.state == "running":
            self.drain(timeout_s)
        self.batcher.shutdown(timeout_s)
        self.admission.finish_drain()
        if self.alert_engine is not None:
            self.alert_engine.close()
        if self.flight_recorder is not None:
            self.flight_recorder.close()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        if self._own_log is not None:
            self._own_log.close()

    def __enter__(self) -> "ServingEngine":
        return self.start() if not self._started else self

    def __exit__(self, *exc):
        self.close()
        return False

    def health(self) -> Dict[str, Any]:
        return self.admission.health(
            queue_depth=self.batcher.inflight,
            buckets=self.buckets.n_buckets,
            completed=self.stats.completed,
            executor_failures=self.stats.executor_failures,
            replica_id=self.replica_id,
            model_version=self.model_version,
            post_warmup_compiles=self.stats.post_warmup_compiles())

    # -- unified metrics export + alerts ---------------------------------
    def metrics_registry(self):
        """Standalone-engine metrics surface: this engine's stats (+
        tracer phases when tracing is on) joined with the process-wide
        runtime/process/memory collectors.  Built once, cached.
        Engines fronted by a Fleet use the fleet's registry instead
        (it merges replicas at scrape time)."""
        if self._metrics_registry is None:
            from ..observe.registry import (MetricsRegistry,
                                            serving_stats_collector,
                                            standard_collectors,
                                            tracer_collector)

            reg = standard_collectors(MetricsRegistry())
            reg.register("serving",
                         serving_stats_collector(self.stats,
                                                 scope="engine"))
            if self.tracer is not None:
                reg.register("reqtrace",
                             tracer_collector(self.tracer))
            self._metrics_registry = reg
        return self._metrics_registry

    def start_metrics_server(self, host: str = "127.0.0.1",
                             port: int = 0):
        """Opt-in /metrics + /healthz (+ /alerts with enable_alerts)
        endpoint for a standalone engine; binds localhost, port=0 =
        ephemeral.  Stopped by close()."""
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
        """Opt into alerting on a standalone engine: the
        `observe.serving_rule_pack` (e2e p99 / error-budget burn /
        post-warmup-compile tripwire; or explicit `rules`) evaluated
        over `metrics_registry()` on a background thread, with an
        optional FlightRecorder bundling diagnostics on every firing
        alert (`flight_dir`).  Pure host: the alert thread launches
        nothing on the device.  Stopped by close()."""
        if self.alert_engine is not None:
            return self.alert_engine
        from ..observe.alerts import AlertEngine, serving_rule_pack
        from ..observe.flightrec import FlightRecorder

        if rules is None:
            rules = serving_rule_pack(**pack_kw)
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

    # -- fleet surface: hot weight reload -------------------------------
    def reload(self, source, version: Optional[int] = None
               ) -> Dict[str, Any]:
        """Hot weight reload: swap the live predictor's device-resident
        parameters for same-shape arrays — the same-shape contract is
        asserted (that is what keeps every warmed bucket warm: ZERO
        compiles) and the swap is a single attribute rebind, so each
        dispatch runs wholly on the old or wholly on the new weights
        (the batcher worker reads the param dict once per run —
        drain-to-batch-boundary for free).  `source` is a sharded-checkpoint dir (io.load_sharded)
        or a name→array mapping.  Structured WeightReloadError on
        mismatch; the old weights keep serving."""
        t0 = time.perf_counter()
        params = self._materialize_params(source)
        live = self.predictor._params
        missing = sorted(set(live) - set(params))
        if missing:
            raise WeightReloadError(
                f"reload source missing {len(missing)} parameter(s): "
                f"{missing[:4]}{' ...' if len(missing) > 4 else ''}",
                replica_id=self.replica_id, missing=missing)
        mismatched = [
            {"name": n,
             "live": [list(live[n].shape), str(live[n].dtype)],
             "new": [list(params[n].shape), str(params[n].dtype)]}
            for n in live
            if (tuple(params[n].shape) != tuple(live[n].shape)
                or params[n].dtype != live[n].dtype)]
        if mismatched:
            raise WeightReloadError(
                f"{len(mismatched)} parameter(s) change shape/dtype — "
                f"a same-shape swap is the zero-recompile contract; "
                f"first: {mismatched[0]}",
                replica_id=self.replica_id, mismatched=mismatched)
        new_version = (self.model_version + 1 if version is None
                       else int(version))
        self.predictor._params = {n: params[n] for n in live}
        self.model_version = new_version
        pause_ms = (time.perf_counter() - t0) * 1e3
        self.stats.record_reload(pause_ms)
        if self._event_log is not None:
            self._event_log.event(
                "serving_reload", version=new_version,
                pause_ms=round(pause_ms, 3),
                source=source if isinstance(source, str) else "arrays")
        return {"version": new_version, "pause_ms": round(pause_ms, 3)}

    def _materialize_params(self, source) -> Dict[str, Any]:
        pred = self.predictor
        if isinstance(source, str):
            return load_sharded_params(source, pred._program,
                                       pred._params, pred.config.place)
        return device_params(source, pred._params, pred.device)

    def _breaker_event(self, kind: str, **fields):
        """serving_breaker_open/close: state-transition events a pager
        rule can key on."""
        if self._event_log is not None:
            self._event_log.event(
                kind, state=self.admission.state,
                breaker=self.admission.breaker.snapshot(), **fields)

    # -- request path ---------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray],
               deadline_ms: Optional[float] = None,
               _trace=None) -> Future:
        """Accept one request (PER-EXAMPLE feeds, no batch dim) and
        return a Future of its fetch list.  Raises BucketMissError /
        QueueFullError / ServingClosedError synchronously — a rejected
        request never occupies queue capacity.  `_trace`: a fleet
        router's RequestTrace to continue (the engine then only adds
        spans; the router owns the trace lifecycle)."""
        trace = _trace
        if trace is None and self.tracer is not None:
            trace = self.tracer.new_trace("serving")
        feeds, max_len = self._normalize(feed)
        deadline = self.admission.deadline_for(deadline_ms)
        req = Request(feeds, deadline=deadline, max_len=max_len,
                      trace=trace)
        try:
            self.batcher.submit(req)
        except ServingError as e:
            if e.kind == "queue_full":
                self.stats.record_shed()
            elif e.kind == "circuit_open":
                self.stats.record_circuit_reject()
            if trace is not None and not trace.fleet_owned \
                    and self.tracer is not None:
                trace.point("rejected", reject=e.kind,
                            replica_id=self.replica_id)
                self.tracer.finish(trace, error=e)
            raise
        self.stats.record_submit(self.batcher.queue_depth)
        return req.future

    def infer(self, feed: Dict[str, np.ndarray],
              deadline_ms: Optional[float] = None,
              timeout_s: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous submit()+result() convenience."""
        return self.submit(feed, deadline_ms=deadline_ms).result(
            timeout_s)

    # -- internals ------------------------------------------------------
    def _on_deadline_miss(self, req: Request):
        self.stats.record_deadline_miss()
        tr = req.trace
        if tr is not None and not tr.fleet_owned \
                and self.tracer is not None:
            tr.add("queue_wait", req.t_submit, time.monotonic(),
                   replica_id=self.replica_id, expired=True)
            self.tracer.finish(tr, error=RuntimeError(
                "deadline expired while queued"))

    def _normalize(self, feed: Dict[str, np.ndarray]
                   ) -> Tuple[Dict[str, np.ndarray], Optional[int]]:
        unknown = set(feed) - set(self._data_names)
        if unknown:
            raise ValueError(
                f"unknown inputs {sorted(unknown)}; model feeds are "
                f"{self._data_names} (seq_len companions are "
                f"synthesized by the engine)")
        missing = set(self._data_names) - set(feed)
        if missing:
            raise ValueError(f"missing inputs: {sorted(missing)}")
        out: Dict[str, np.ndarray] = {}
        max_len: Optional[int] = None
        for n in self._data_names:
            tpl = self._templates[n]
            v = np.asarray(feed[n])
            if v.dtype != tpl.dtype:
                v = v.astype(tpl.dtype)  # serving frontends send f64
            if n in self._ragged:
                if v.ndim != tpl.ndim or v.shape[1:] != tpl.shape[1:]:
                    raise BucketMissError(
                        f"ragged input {n!r}: got shape {v.shape}, "
                        f"want (L,) + {tpl.shape[1:]}",
                        input=n, got_shape=list(v.shape),
                        want_tail=list(tpl.shape[1:]))
                length = v.shape[0]
                if length < 1:
                    raise BucketMissError(
                        f"ragged input {n!r} is empty", input=n,
                        got_shape=list(v.shape))
                if BucketConfig.pick(self.buckets.seq_lens,
                                     length) is None:
                    self.stats.record_bucket_miss()
                    raise BucketMissError(
                        f"ragged input {n!r} length {length} exceeds "
                        f"the largest seq bucket "
                        f"{self.buckets.seq_lens[-1]}",
                        input=n, length=length,
                        seq_lens=list(self.buckets.seq_lens))
                max_len = length if max_len is None \
                    else max(max_len, length)
            elif v.shape != tpl.shape:
                self.stats.record_bucket_miss()
                raise BucketMissError(
                    f"input {n!r}: got shape {v.shape}, bucketed "
                    f"shapes require the per-example template "
                    f"{tpl.shape}", input=n, got_shape=list(v.shape),
                    want_shape=list(tpl.shape))
            out[n] = v
        return out, max_len

    def _spec_for(self, bs: int, sl: Optional[int]):
        """FeedSpec feed spec of one (batch, seq) bucket."""
        spec: Dict[str, FeedSpec] = {}
        for n, tpl in self._templates.items():
            if n in self._ragged:
                shape = (bs, sl) + tpl.shape[1:]
                spec[f"{n}.seq_len"] = FeedSpec((bs,), np.int32)
            else:
                shape = (bs,) + tpl.shape
            spec[n] = FeedSpec(shape, tpl.dtype)
        return spec

    def _bucket_specs(self):
        """FeedSpec feed specs for every ladder combination."""
        for bs in self.buckets.batch_sizes:
            for sl in (self.buckets.seq_lens or (None,)):
                yield self._spec_for(bs, sl)

    def _validate_memory_budget(self):
        """Predict every bucket's peak memory BEFORE the ladder warmup
        and raise a structured BucketMemoryError for impossible buckets
        (the reference's planner, paddle_tpu/serving/engine.py:647-731).

        Inference peak is affine in batch at a fixed seq bucket, so two
        small probe runs per seq bucket (batch 1 and 2, observe.memory
        `fit_peaks`) predict the whole batch ladder.  Records the
        prediction table in `self.fit_plan`; tags it skipped when no
        budget is known (the CPU without an explicit budget)."""
        budget = self.memory_budget_bytes
        if budget is False:
            return
        from ..observe.memory import (PLAN_FIT_REL_TOL,
                                      device_memory_budget, fit_peaks)

        if budget is None or budget is True:
            budget = device_memory_budget(self.predictor.device)
        if not budget:
            self.fit_plan = {"skipped": "no device budget known",
                             "budget_bytes": None}
            return
        probe_bs = tuple(b for b in (1, 2)
                         if b <= self.buckets.batch_sizes[-1]) or (1,)
        buckets_plan: List[Dict[str, Any]] = []
        for sl in (self.buckets.seq_lens or (None,)):
            rows, _fit = fit_peaks(
                lambda b: self._probe(self._spec_for(b, sl)),
                self.buckets.batch_sizes, probe_bs)
            buckets_plan += [
                {"batch_size": r["size"], "seq_len": sl,
                 "predicted_peak_bytes": r["predicted_peak_bytes"],
                 "exact": r["exact"],
                 "fits": r["predicted_peak_bytes"] <= budget}
                for r in rows]
        bad = [r for r in buckets_plan if not r["fits"]]
        self.fit_plan = {
            "budget_bytes": int(budget),
            "probe_batches": list(probe_bs),
            "rel_tol": PLAN_FIT_REL_TOL,
            "buckets": buckets_plan,
        }
        if self._event_log is not None:
            self._event_log.event("serving_memory_plan", **self.fit_plan)
        if bad:
            raise BucketMemoryError(
                f"{len(bad)}/{len(buckets_plan)} configured buckets "
                f"predicted to exceed the device memory budget "
                f"({budget / 1e9:.2f} GB): "
                + ", ".join(f"bs{r['batch_size']}"
                            + (f"/seq{r['seq_len']}"
                               if r['seq_len'] else "")
                            + f"≈{r['predicted_peak_bytes'] / 1e9:.2f}GB"
                            for r in bad[:4])
                + (" ..." if len(bad) > 4 else ""),
                budget_bytes=int(budget),
                offending_buckets=bad,
                probe_batches=list(probe_bs),
                plan=buckets_plan)

    def _probe(self, spec):
        """One recorded Predictor run on zeros of `spec`, its parameters
        and feeds counted in (observe/memory.py `measure_run`), after
        one unrecorded run: the workspaces and algorithm choices a new
        shape makes once fall before the window."""
        from ..observe.memory import measure_run

        pred = self.predictor
        feeds = pred.zero_feeds(spec)
        resident = dict(pred._params)
        resident.update(feeds)
        with torch.no_grad():
            pred._infer(pred._params, feeds)
            return measure_run(lambda: pred._infer(pred._params, feeds),
                               pred.device, resident)

    def _dispatch(self, requests: Sequence[Request]):
        """Batcher callback: pad to the smallest fitting bucket,
        dispatch ONE program run, demux outputs to futures."""
        t_form = time.monotonic()  # queue_wait ends / batch_form begins
        n = len(requests)
        bucket_b = BucketConfig.pick(self.buckets.batch_sizes, n)
        assert bucket_b is not None, (n, self.buckets.batch_sizes)
        bucket_s = None
        if self._ragged:
            need = max(r.max_len for r in requests)
            bucket_s = BucketConfig.pick(self.buckets.seq_lens, need)
            assert bucket_s is not None, (need, self.buckets.seq_lens)

        feed: Dict[str, np.ndarray] = {}
        elems_real = elems_padded = 0.0
        for name, tpl in self._templates.items():
            if name in self._ragged:
                arr = np.zeros((bucket_b, bucket_s) + tpl.shape[1:],
                               dtype=tpl.dtype)
                # pad rows get length 1, not 0: a zero-length row can
                # divide-by-zero inside masked kernels (avg pools), and
                # its output is discarded at demux anyway
                lens = np.ones((bucket_b,), np.int32)
                for i, r in enumerate(requests):
                    v = r.feeds[name]
                    arr[i, :v.shape[0]] = v
                    lens[i] = v.shape[0]
                feed[name] = arr
                feed[f"{name}.seq_len"] = lens
                row = float(np.prod(tpl.shape[1:], dtype=np.float64)
                            or 1.0)
                elems_real += sum(
                    r.feeds[name].shape[0] for r in requests) * row
                elems_padded += bucket_b * bucket_s * row
            else:
                arr = np.zeros((bucket_b,) + tpl.shape, dtype=tpl.dtype)
                for i, r in enumerate(requests):
                    arr[i] = r.feeds[name]
                feed[name] = arr
                row = float(tpl.size or 1.0)
                elems_real += n * row
                elems_padded += bucket_b * row
        version = self.model_version  # the weights this batch runs on
        t_disp = time.monotonic()     # batch_form ends / dispatch begins
        for r in requests:
            if r.trace is not None:
                r.trace.add("queue_wait", r.t_submit, t_form,
                            replica_id=self.replica_id)
                r.trace.add("batch_form", t_form, t_disp,
                            replica_id=self.replica_id, batch=n,
                            bucket=bucket_b)
        t0 = time.perf_counter()
        try:
            if self.replica_id is not None:
                # fleet chaos points (resilience.chaos): an armed kill
                # raises here and rides the REAL dispatch-failure path
                # below — the batch fails with the structured retryable
                # wrapper a router fails over
                from ..resilience import chaos

                chaos.delaypoint(f"replica:{self.replica_id}:delay")
                chaos.failpoint(f"replica:{self.replica_id}:kill")
            outs = self.predictor.run(feed)
        except BaseException as e:
            # one executor outcome per dispatch feeds the breaker; the
            # batcher resolves every future in the batch with the
            # structured wrapper raised here (never silently dropped)
            self.stats.record_executor_failure()
            if self.admission.record_dispatch_result(False) == "opened":
                self._breaker_event("serving_breaker_open",
                                    failed_batch_size=n)
            err = ExecutorFailureError(
                f"executor dispatch failed for batch of {n}: "
                f"{type(e).__name__}: {e}",
                error_type=type(e).__name__, batch_size=n)
            t_err = time.monotonic()
            for r in requests:
                if r.trace is not None:
                    r.trace.add("dispatch", t_disp, t_err,
                                replica_id=self.replica_id, batch=n,
                                error=type(e).__name__)
                    if not r.trace.fleet_owned \
                            and self.tracer is not None:
                        self.tracer.finish(r.trace, error=err)
            raise err from e
        exec_ms = (time.perf_counter() - t0) * 1e3
        t_done = time.monotonic()
        for r in requests:
            if r.trace is not None:
                r.trace.add("dispatch", t_disp, t_done,
                            replica_id=self.replica_id, batch=n)
        if self.admission.record_dispatch_result(True) == "closed":
            self._breaker_event("serving_breaker_close")
        self.stats.record_batch(n, bucket_b, elems_real, elems_padded,
                                exec_ms)
        now = time.monotonic()
        for i, r in enumerate(requests):
            # fetches are batch-major; anything without a leading batch
            # axis (a scalar metric) is handed back whole
            res = [o[i] if (getattr(o, "ndim", 0) >= 1
                            and o.shape[0] == bucket_b) else o
                   for o in outs]
            r.future.model_version = version
            r.future.set_result(res)
            self.stats.record_done((now - r.t_submit) * 1e3)
            if r.trace is not None and not r.trace.fleet_owned \
                    and self.tracer is not None:
                self.tracer.finish(r.trace)
        self.stats.maybe_emit()


def device_params(source, live: Dict[str, Any], device) -> Dict[str, Any]:
    """Reload source mapping -> name -> tensor on `device` for the names
    of `live`: a torch tensor moves there as it is, anything else goes
    through convert.params_from_arrays (64-bit names narrow to 32 bits,
    as at load).  Names `live` lacks are dropped; shapes and dtypes are
    the caller's check."""
    from ..convert import params_from_arrays

    out = {}
    for n, v in dict(source).items():
        if n not in live or v is None:
            continue
        if isinstance(v, torch.Tensor):
            out[n] = v.to(device)
        else:
            out.update(params_from_arrays({n: v}, device))
    return out


def load_sharded_params(dirname: str, program, live: Dict[str, Any],
                        place) -> Dict[str, Any]:
    """A sharded checkpoint (io.load_sharded: either package's) of the
    names of `live` that are vars of `program`, loaded onto `place`'s
    device in a fresh scope."""
    from .. import io as fluid_io
    from ..core.executor import Executor, Scope, scope_guard

    block = program.global_block()
    scope = Scope()
    with scope_guard(scope):
        fluid_io.load_sharded(Executor(place), dirname,
                              main_program=program,
                              vars=[block.var(n) for n in live
                                    if n in block.vars])
    return {n: v for n, v in scope.vars.items()
            if v is not None and n in live}
