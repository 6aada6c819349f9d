"""The metrics export plane: the port of paddle_tpu/observe/registry.py.

A pull-model registry joining the snapshot surfaces the serving and
training layers already keep (DecodeStats/ServingStats, the fleets'
router counters, runtime_stats, StepTelemetry, the goodput ledger,
request tracing) into one scrapeable surface:

- **MetricsRegistry**: named collectors (zero-argument callables
  returning `MetricFamily` lists) registered per component; `collect()`
  pulls every collector AT SCRAPE TIME (nothing is double-counted,
  nothing goes stale; a raising collector is isolated and reported as
  `observe_collector_up 0` instead of killing the scrape).
- **adapter collectors** over the existing snapshot surfaces — nothing
  re-instruments: `serving_stats_collector`, `fleet_collector`,
  `disagg_collector`, `runtime_collector`, `telemetry_collector`,
  `gang_collector`, `memory_collector`, `tracer_collector`,
  `goodput_collector`, `recovery_collector`, `process_collector`.
- **exposition**: `snapshot()` (a JSON-able dict) and
  `prometheus_text()` (text format 0.0.4).  Histograms are
  `LatencyHistogram`s mapped exactly onto cumulative `le` buckets: the
  log-spaced bin upper edges become the `le` values (milliseconds,
  families named `*_ms`).
- **MetricsServer**: an opt-in stdlib ThreadingHTTPServer serving
  `/metrics`, `/healthz` and (with an AlertEngine) `/alerts`.  Binds
  127.0.0.1 by default: the exposition carries operational detail.

The metric NAMES are the reference's (the alert rule packs key on them);
the values are the port's own counts.  `runtime_xla_compiles_total`
counts the kernel builds (observe/monitoring.py: the port's compiles),
the trace, build and retrace counters stay 0 (the port traces nothing),
and `memory_collector` reads torch.cuda's peak and the card's total
memory, reporting `memory_stats_available 0` on a process that never
initialised CUDA.  Every collector is host-side Python over counters and
histograms: a scrape launches nothing on the device.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .memory import device_memory_budget
from .monitoring import LatencyHistogram, peak_memory_bytes, runtime_stats

_KINDS = ("counter", "gauge", "histogram")
_PROCESS_T0 = time.monotonic()


class MetricFamily:
    """One named metric with labeled samples.

    counter/gauge samples: (labels dict, float value).
    histogram samples: (labels dict, {"buckets": [(le_ms, cum)...],
    "count": n, "sum_ms": s}) — captured from a LatencyHistogram at
    collect time, cumulative and exact.
    """

    def __init__(self, name: str, kind: str, help: str = ""):
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got "
                             f"{kind!r}")
        if not name or not all(c.isalnum() or c == "_" for c in name):
            raise ValueError(f"metric name must be [A-Za-z0-9_]+, got "
                             f"{name!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.samples: List[Tuple[Dict[str, Any], Any]] = []

    def add(self, value, **labels: Any) -> "MetricFamily":
        if value is None:
            return self  # a surface that reports None just has no sample
        if self.kind == "histogram":
            raise ValueError("use add_histogram for histogram families")
        self.samples.append((labels, float(value)))
        return self

    def add_histogram(self, hist: LatencyHistogram, **labels: Any
                      ) -> "MetricFamily":
        if self.kind != "histogram":
            raise ValueError(f"{self.name} is a {self.kind}, not a "
                             f"histogram")
        buckets = hist.cumulative_buckets()
        with hist._lock:
            count, total = hist.count, hist.sum_ms
        self.samples.append((labels, {"buckets": buckets,
                                      "count": count,
                                      "sum_ms": total}))
        return self


def counter(name: str, help: str = "", value=None, **labels
            ) -> MetricFamily:
    fam = MetricFamily(name, "counter", help)
    if value is not None:
        fam.add(value, **labels)
    return fam


def gauge(name: str, help: str = "", value=None, **labels
          ) -> MetricFamily:
    fam = MetricFamily(name, "gauge", help)
    if value is not None:
        fam.add(value, **labels)
    return fam


def histogram(name: str, help: str = "",
              hist: Optional[LatencyHistogram] = None, **labels
              ) -> MetricFamily:
    fam = MetricFamily(name, "histogram", help)
    if hist is not None:
        fam.add_histogram(hist, **labels)
    return fam


class MetricsRegistry:
    """Pull-model registry: collectors run at scrape time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._collectors: Dict[str, Callable[[], Sequence[MetricFamily]]] \
            = {}

    def register(self, name: str,
                 collector: Callable[[], Sequence[MetricFamily]]
                 ) -> "MetricsRegistry":
        """Register (or replace) one named collector.  Replacement is
        deliberate: a Fleet re-registering after a restart must not
        accumulate dead collectors."""
        with self._lock:
            self._collectors[name] = collector
        return self

    def unregister(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def collector_names(self) -> List[str]:
        with self._lock:
            return sorted(self._collectors)

    def collect(self) -> List[MetricFamily]:
        """Run every collector; a raising collector contributes
        nothing but flips its `observe_collector_up` gauge to 0 — one
        sick subsystem must not take down the whole scrape."""
        with self._lock:
            collectors = list(self._collectors.items())
        out: List[MetricFamily] = []
        up = gauge("observe_collector_up",
                   "1 when the named collector scraped cleanly")
        for name, fn in sorted(collectors):
            try:
                fams = list(fn())
            except Exception:  # noqa: BLE001 — isolation is the contract
                up.add(0, collector=name)
                continue
            up.add(1, collector=name)
            out.extend(fams)
        out.append(up)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: {family: {"kind", "help", "samples":
        [{"labels", "value"|...histogram fields}]}} — the
        `observe.metrics_snapshot()` wire form."""
        out: Dict[str, Any] = {}
        for fam in self.collect():
            entry = out.setdefault(fam.name, {"kind": fam.kind,
                                              "help": fam.help,
                                              "samples": []})
            for labels, value in fam.samples:
                if fam.kind == "histogram":
                    entry["samples"].append({
                        "labels": labels, "count": value["count"],
                        "sum_ms": round(value["sum_ms"], 3),
                        "buckets": [[round(le, 6), c]
                                    for le, c in value["buckets"]]})
                else:
                    entry["samples"].append({"labels": labels,
                                             "value": value})
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for fam in self.collect():
            if fam.help:
                lines.append(f"# HELP {fam.name} "
                             f"{_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, value in fam.samples:
                if fam.kind == "histogram":
                    for le, cum in value["buckets"]:
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_fmt_labels(labels, le=_fmt_num(le))}"
                            f" {cum}")
                    lines.append(f"{fam.name}_bucket"
                                 f"{_fmt_labels(labels, le='+Inf')}"
                                 f" {value['count']}")
                    lines.append(f"{fam.name}_sum{_fmt_labels(labels)}"
                                 f" {_fmt_num(value['sum_ms'])}")
                    lines.append(f"{fam.name}_count"
                                 f"{_fmt_labels(labels)}"
                                 f" {value['count']}")
                else:
                    lines.append(f"{fam.name}{_fmt_labels(labels)} "
                                 f"{_fmt_num(value)}")
        return "\n".join(lines) + "\n"


def _fmt_num(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: Any) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_labels(labels: Dict[str, Any], **extra: str) -> str:
    items = {**labels, **extra}
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


# ---------------------------------------------------------------------------
# Adapter collectors over the existing snapshot surfaces
# ---------------------------------------------------------------------------

# snapshot keys that are levels, not lifetime counts (everything else
# integral in a ServingStats/DecodeStats snapshot is a counter)
_STATS_GAUGE_KEYS = {"max_queue_depth", "post_warmup_compiles",
                     "peak_pages_in_use", "batch_occupancy",
                     "padding_waste", "slot_occupancy",
                     "kv_page_utilization", "reload_pause_ms",
                     "exec_per_req_ms", "model_version",
                     "healthy_replicas"}
# histogram attributes by stats class duck-type
_STATS_HIST_ATTRS = ("e2e_ms", "exec_ms", "ttft_ms", "tpot_ms")


def serving_stats_collector(stats, **labels: Any
                            ) -> Callable[[], List[MetricFamily]]:
    """Adapter over a ServingStats/DecodeStats object (or a zero-arg
    callable returning one, e.g. `fleet.merged_stats` so the fleet
    aggregation happens AT scrape time).  Families are `serving_<key>`
    (+`_total` on counters); latency surfaces become exact histograms."""

    def collect() -> List[MetricFamily]:
        obj = stats() if callable(stats) else stats
        fams: List[MetricFamily] = []
        snap = obj.snapshot()
        for key, val in sorted(snap.items()):
            if isinstance(val, dict) or val is None:
                continue  # histograms ride below; warmup dict skipped
            if key in _STATS_GAUGE_KEYS:
                fams.append(gauge(f"serving_{key}",
                                  f"serving stats gauge {key}",
                                  val, **labels))
            elif isinstance(val, bool):
                continue
            else:
                fams.append(counter(f"serving_{key}_total",
                                    f"serving stats counter {key}",
                                    val, **labels))
        # the generic loop skips dict values, so the speculation
        # section (DecodeStats with speculate_k set) gets explicit
        # families — the accept-rate gauge is what speculate_rule_pack
        # alerts on
        spec = snap.get("speculation")
        if isinstance(spec, dict):
            fams.append(gauge("serving_speculation_k",
                              "configured speculative draft length",
                              spec["speculate_k"], **labels))
            for key in ("verify_dispatches", "drafted_tokens",
                        "accepted_tokens", "emitted_tokens"):
                fams.append(counter(
                    f"serving_speculation_{key}_total",
                    f"speculative decoding counter {key}",
                    spec[key], **labels))
            if spec["accept_rate"] is not None:
                fams.append(gauge(
                    "serving_speculation_accept_rate",
                    "accepted drafts over drafts scored",
                    spec["accept_rate"], **labels))
            if spec["speculation_efficiency"] is not None:
                fams.append(gauge(
                    "serving_speculation_efficiency",
                    "tokens committed over verify rows paid",
                    spec["speculation_efficiency"], **labels))
            hist = counter("serving_speculation_accept_hist_total",
                           "slot-verify rounds by accepted count")
            for a, n in enumerate(spec["accept_hist"]):
                hist.add(n, accepted=str(a), **labels)
            fams.append(hist)
        for attr in _STATS_HIST_ATTRS:
            h = getattr(obj, attr, None)
            if isinstance(h, LatencyHistogram):
                fams.append(histogram(f"serving_{attr}",
                                      f"serving latency {attr}",
                                      h, **labels))
        return fams

    return collect


def fleet_collector(fleet) -> Callable[[], List[MetricFamily]]:
    """Router-level counters + per-replica health/breaker gauges.
    The merged engine telemetry is a separate serving_stats_collector
    over `fleet.merged_stats` — register both (Fleet.metrics_registry
    does)."""

    def collect() -> List[MetricFamily]:
        kind = fleet.kind
        snap = fleet.stats.snapshot()
        fams: List[MetricFamily] = []
        for key in ("submitted", "completed", "failed", "failovers",
                    "hedges", "hedge_wins", "retries", "saturated",
                    "ejects", "reloads", "parity_checked",
                    "parity_failed"):
            fams.append(counter(f"fleet_{key}_total",
                                f"fleet router counter {key}",
                                snap[key], kind=kind))
        fams.append(gauge("fleet_reload_pause_ms",
                          "worst single replica reload pause",
                          snap["reload_pause_ms"], kind=kind))
        fams.append(gauge("fleet_model_version",
                          "live weight version", fleet.model_version,
                          kind=kind))
        fams.append(gauge("fleet_healthy_replicas",
                          "replicas currently routable",
                          sum(h.routable() for h in fleet.replicas),
                          kind=kind))
        up = gauge("fleet_replica_up", "1 when the replica is routable")
        inflight = gauge("fleet_replica_inflight",
                         "fleet-routed outstanding requests")
        brk = gauge("fleet_replica_breaker_open",
                    "1 when the fleet-side breaker is not closed")
        routed = counter("fleet_replica_routed_total",
                         "lifetime routed requests")
        failures = counter("fleet_replica_failures_total",
                           "lifetime retryable failures observed")
        for h in fleet.replicas:
            lbl = {"replica_id": h.replica_id}
            up.add(1 if h.routable() else 0, **lbl)
            inflight.add(h.inflight, **lbl)
            brk.add(0 if h.breaker.state == "closed" else 1, **lbl)
            routed.add(h.routed, **lbl)
            failures.add(h.failures, **lbl)
        fams += [up, inflight, brk, routed, failures]
        fams.append(histogram("fleet_e2e_ms",
                              "fleet end-to-end request latency",
                              fleet.stats.e2e_ms, kind=kind))
        return fams

    return collect


def disagg_collector(dfleet) -> Callable[[], List[MetricFamily]]:
    """Disaggregated-fleet adapter (serving/disagg.py): phase-router
    counters, the KV-transfer accounting, per-worker health gauges,
    and the PER-PHASE merged latency histograms
    (`disagg_prefill_wait_ms` / `disagg_decode_tpot_ms`) the
    disagg_rule_pack — and through it the Autoscaler — keys on."""

    def collect() -> List[MetricFamily]:
        snap = dfleet.stats.snapshot()
        fams: List[MetricFamily] = []
        for key in ("submitted", "completed", "failed", "handoffs",
                    "pages_transferred", "bytes_transferred",
                    "retries", "saturated", "ejects",
                    "parity_checked", "parity_failed", "scale_ups",
                    "scale_downs"):
            fams.append(counter(f"disagg_{key}_total",
                                f"disagg router counter {key}",
                                snap[key]))
        failovers = counter("disagg_failovers_total",
                            "worker deaths failed over, per phase")
        failovers.add(snap["prefill_failovers"], phase="prefill")
        failovers.add(snap["decode_failovers"], phase="decode")
        fams.append(failovers)
        workers = gauge("disagg_workers", "live workers per phase")
        healthy = gauge("disagg_healthy_workers",
                        "routable workers per phase")
        for phase in ("prefill", "decode"):
            pool = dfleet.prefill if phase == "prefill" \
                else dfleet.decode
            workers.add(sum(not h.dead for h in pool), phase=phase)
            healthy.add(sum(h.routable() for h in pool), phase=phase)
        fams += [workers, healthy]
        up = gauge("disagg_worker_up", "1 when the worker is routable")
        inflight = gauge("disagg_worker_inflight",
                         "router-outstanding requests per worker")
        for h in dfleet.workers():
            lbl = {"replica_id": h.replica_id, "phase": h.phase}
            up.add(1 if h.routable() else 0, **lbl)
            inflight.add(h.inflight, **lbl)
        fams += [up, inflight]
        fams.append(gauge("disagg_model_version", "live weight version",
                          dfleet.model_version))
        fams.append(histogram("disagg_e2e_ms",
                              "disagg end-to-end request latency",
                              dfleet.stats.e2e_ms))
        fams.append(histogram("disagg_ttft_ms",
                              "joint client-observed time to first "
                              "token (submit -> handoff package)",
                              dfleet.stats.ttft_ms))
        fams.append(histogram("disagg_handoff_ms",
                              "KV-page hop: export + relay + import "
                              "admission", dfleet.stats.handoff_ms))
        fams.append(histogram("disagg_prefill_wait_ms",
                              "prefill workers' merged TTFT (queue "
                              "wait + prefill dispatch)",
                              dfleet.merged_stats("prefill").ttft_ms))
        dec = dfleet.merged_stats("decode")
        fams.append(histogram("disagg_decode_tpot_ms",
                              "decode workers' merged time per output "
                              "token", dec.tpot_ms))
        spec = dec.snapshot().get("speculation")
        if isinstance(spec, dict):
            # decode phase speculates; mirror the per-engine families
            # under the disagg_ prefix so one dashboard covers both
            fams.append(gauge("disagg_speculation_k",
                              "configured speculative draft length",
                              spec["speculate_k"], phase="decode"))
            for key in ("verify_dispatches", "drafted_tokens",
                        "accepted_tokens", "emitted_tokens"):
                fams.append(counter(
                    f"disagg_speculation_{key}_total",
                    f"speculative decoding counter {key}",
                    spec[key], phase="decode"))
            if spec["accept_rate"] is not None:
                fams.append(gauge("disagg_speculation_accept_rate",
                                  "accepted drafts over drafts scored",
                                  spec["accept_rate"], phase="decode"))
            if spec["speculation_efficiency"] is not None:
                fams.append(gauge(
                    "disagg_speculation_efficiency",
                    "tokens committed over verify rows paid",
                    spec["speculation_efficiency"], phase="decode"))
        return fams

    return collect


def runtime_collector() -> Callable[[], List[MetricFamily]]:
    """observe.runtime_stats: compiles (the port's kernel builds and
    unwarmed serving signatures), dispatches; the reference's family
    names."""

    def collect() -> List[MetricFamily]:
        s = runtime_stats.snapshot()
        return [
            counter("runtime_xla_compiles_total",
                    "compiles (kernel builds)", s["compiles"]),
            counter("runtime_xla_compile_seconds_total",
                    "total compile wall time",
                    s["compile_time_s"]),
            counter("runtime_step_builds_total",
                    "executor step fns traced (0: nothing is traced)",
                    s["builds"]),
            counter("runtime_retraces_total",
                    "step re-traces from feed signature changes "
                    "(0: nothing is traced)", s["retraces"]),
            counter("runtime_dispatches_total",
                    "Executor.run dispatches", s["dispatches"]),
            counter("runtime_dispatch_seconds_total",
                    "host enqueue time", s["dispatch_time_s"]),
        ]

    return collect


def telemetry_collector(fetch: Callable[[], Any], **labels: Any
                        ) -> Callable[[], List[MetricFamily]]:
    """Training-side adapter: `fetch` returns the latest StepTelemetry
    (or None before the first window) — contrib.Trainer passes
    `lambda: trainer.last_telemetry`.  Per-group numerics (pillar 6)
    become `training_group_*{group=...}` gauges."""

    def collect() -> List[MetricFamily]:
        tel = fetch()
        if tel is None:
            return [gauge("training_telemetry_windows",
                          "telemetry windows fetched", 0, **labels)]
        fams = [
            gauge("training_telemetry_windows",
                  "telemetry windows fetched", 1, **labels),
            counter("training_steps_total", "steps in the last window",
                    tel.steps, **labels),
            gauge("training_loss_last", "last step loss",
                  tel.loss_last, **labels),
            gauge("training_loss_mean", "window mean loss",
                  tel.loss_mean, **labels),
            gauge("training_grad_norm_last", "last step grad norm",
                  tel.grad_norm_last, **labels),
            gauge("training_update_norm_last", "last step update norm",
                  tel.update_norm_last, **labels),
            gauge("training_loss_scale", "dynamic loss scale",
                  tel.loss_scale, **labels),
            counter("training_nonfinite_grad_steps_total",
                    "window steps with non-finite grads",
                    tel.nonfinite_grad_steps, **labels),
            counter("training_nonfinite_loss_steps_total",
                    "window steps with non-finite loss",
                    tel.nonfinite_loss_steps, **labels),
            counter("training_skipped_update_steps_total",
                    "guard-skipped optimizer updates",
                    tel.skipped_update_steps, **labels),
        ]
        if tel.groups:
            for field in ("grad_norm", "param_norm", "update_ratio"):
                fam = gauge(f"training_group_{field}",
                            f"per parameter-group {field} "
                            f"(observe pillar 6)")
                for gname, vals in sorted(tel.groups.items()):
                    if field in vals:
                        fam.add(vals[field], group=gname, **labels)
                fams.append(fam)
        return fams

    return collect


def gang_collector(skew: Callable[[], Dict[str, Any]], **labels: Any
                   ) -> Callable[[], List[MetricFamily]]:
    """Gang heartbeat adapter: `skew` returns a
    resilience.health.HealthMonitor.skew() dict (per-rank steps/rates,
    max lag, slow ranks)."""

    def collect() -> List[MetricFamily]:
        s = skew()
        steps = gauge("gang_rank_steps",
                      "last heartbeat step counter per rank")
        rates = gauge("gang_rank_step_rate",
                      "heartbeat-derived steps/s per rank")
        for r, v in sorted((s.get("steps") or {}).items()):
            steps.add(v, rank=r, **labels)
        for r, v in sorted((s.get("rates") or {}).items()):
            rates.add(v, rank=r, **labels)
        fams = [steps, rates]
        fams.append(gauge("gang_max_lag_steps",
                          "max step lag across ranks",
                          s.get("max_lag_steps"), **labels))
        fams.append(gauge("gang_median_step_rate",
                          "median per-rank step rate",
                          s.get("median_rate"), **labels))
        slow = s.get("slow_ranks")
        fams.append(gauge("gang_slow_ranks",
                          "ranks lagging the median beyond the slow "
                          "factor",
                          len(slow) if slow is not None else None,
                          **labels))
        return fams

    return collect


def memory_collector() -> Callable[[], List[MetricFamily]]:
    """Device memory peak vs budget: torch.cuda's peak allocation and
    the card's total memory (observe/memory.py `device_memory_budget`).  A process that never initialised CUDA
    contributes the availability gauge only (0)."""

    def collect() -> List[MetricFamily]:
        peak = peak_memory_bytes()
        budget = device_memory_budget()
        fams = [gauge("memory_stats_available",
                      "1 when the backend reports allocator stats",
                      1 if peak is not None else 0)]
        fams.append(gauge("memory_peak_bytes",
                          "peak bytes the caching allocator handed out",
                          peak))
        fams.append(gauge("memory_budget_bytes",
                          "device memory budget", budget))
        return fams

    return collect


def tracer_collector(tracer, **labels: Any
                     ) -> Callable[[], List[MetricFamily]]:
    """Pillar-7 request-tracing adapter: tracer lifecycle counters plus
    the exact per-phase latency histograms
    (`reqtrace_phase_ms{phase=...}`)."""

    def collect() -> List[MetricFamily]:
        s = tracer.snapshot()
        fams = [
            counter("reqtrace_started_total", "traces started",
                    s["started"], **labels),
            counter("reqtrace_finished_total", "traces finished",
                    s["finished"], **labels),
            counter("reqtrace_kept_total", "traces kept in the ring",
                    s["kept"], **labels),
            counter("reqtrace_tail_kept_total",
                    "traces kept only by a tail criterion "
                    "(slow/error/failover/...)", s["tail_kept"],
                    **labels),
            counter("reqtrace_errors_total", "traces finished in error",
                    s["errors"], **labels),
            gauge("reqtrace_ring_size", "kept traces resident",
                  s["ring_size"], **labels),
            gauge("reqtrace_sample_rate", "head sampling rate",
                  s["sample_rate"], **labels),
        ]
        phase_fam = MetricFamily("reqtrace_phase_ms", "histogram",
                                 "span duration per phase")
        for phase, h in sorted(tracer.phase_histograms().items()):
            phase_fam.add_histogram(h, phase=phase, **labels)
        fams.append(phase_fam)
        return fams

    return collect


def goodput_collector(fetch: Callable[[], Any], **labels: Any
                      ) -> Callable[[], List[MetricFamily]]:
    """Pillar-8 adapter: `fetch` returns a GoodputLedger.report()
    dict (or None before a ledger exists) — contrib.Trainer passes
    `lambda: trainer.goodput()`.  Fractions become
    `goodput_fraction{category=...}` gauges, badput seconds become
    per-category counters, and effective_mfu rides when the report
    carries an MFU."""

    def collect() -> List[MetricFamily]:
        rep = fetch()
        if rep is None:
            return [gauge("goodput_available",
                          "1 when a goodput ledger is reporting", 0,
                          **labels)]
        fams = [
            gauge("goodput_available",
                  "1 when a goodput ledger is reporting", 1, **labels),
            counter("goodput_wall_seconds_total",
                    "ledger-accounted wall clock", rep["wall_s"],
                    **labels),
            gauge("goodput_fraction_good",
                  "useful-step share of wall clock (the goodput)",
                  rep["goodput"], **labels),
            counter("goodput_steps_total", "useful steps accounted",
                    rep["steps"], **labels),
            counter("goodput_replay_steps_total",
                    "steps re-executed after restarts (badput)",
                    rep["replay_steps"], **labels),
        ]
        frac = gauge("goodput_fraction",
                     "wall-clock share per exclusive category "
                     "(observe pillar 8)")
        badput = counter("goodput_badput_seconds_total",
                         "non-step wall seconds per category")
        for cat, v in sorted(rep["fractions"].items()):
            frac.add(v, category=cat, **labels)
        for cat, v in sorted(rep["categories_s"].items()):
            if cat != "step":
                badput.add(v, category=cat, **labels)
        fams += [frac, badput]
        fams.append(gauge("goodput_mean_step_seconds",
                          "mean accounted step time",
                          rep.get("mean_step_s"), **labels))
        fams.append(gauge("goodput_effective_mfu",
                          "headline MFU x goodput fraction",
                          rep.get("effective_mfu"), **labels))
        fams.append(gauge("goodput_straggler_est_seconds",
                          "heartbeat-skew straggler estimate "
                          "(informational, overlaps steps)",
                          rep.get("straggler_est_s"), **labels))
        return fams

    return collect


def recovery_collector(fetch: Callable[[], Any], **labels: Any
                       ) -> Callable[[], List[MetricFamily]]:
    """Divergence-autopilot adapter: `fetch` returns the
    RecoveryController.snapshot() dict (or None when no autopilot is
    attached) — contrib.Trainer registers it as the "recovery" source.
    The rollback counter is what trainer_rule_pack's
    `train_recovery_rollbacks` rule watches."""

    def collect() -> List[MetricFamily]:
        snap = fetch()
        if snap is None:
            return [gauge("recovery_autopilot_enabled",
                          "1 when a divergence autopilot is attached",
                          0, **labels)]
        return [
            gauge("recovery_autopilot_enabled",
                  "1 when a divergence autopilot is attached", 1,
                  **labels),
            counter("recovery_rollbacks_total",
                    "in-process rollbacks to a verified-good serial",
                    snap["rollbacks"], **labels),
            gauge("recovery_rollback_budget",
                  "max rollbacks before the run halts",
                  snap["budget"], **labels),
            gauge("recovery_halted",
                  "1 after a TrainingDivergedError halt",
                  snap["halted"], **labels),
            gauge("recovery_skip_streak",
                  "consecutive poisoned steps in the current streak",
                  snap["skip_streak"], **labels),
            counter("recovery_quarantined_batches_total",
                    "batches quarantined (rollback windows + "
                    "admission rejects)",
                    snap["quarantined_batches"], **labels),
            counter("recovery_quarantine_windows_total",
                    "quarantined data windows recorded",
                    snap["quarantine_windows"], **labels),
            gauge("recovery_verified_serials",
                  "verified-good checkpoint serials available as "
                  "rollback anchors",
                  snap["verified_serials"], **labels),
        ]

    return collect


def process_collector() -> Callable[[], List[MetricFamily]]:
    """Process-level basics (stdlib only)."""

    def collect() -> List[MetricFamily]:
        fams = [gauge("process_uptime_seconds",
                      "seconds since observe.registry import",
                      time.monotonic() - _PROCESS_T0),
                gauge("process_threads", "live python threads",
                      threading.active_count())]
        try:
            import resource

            rss_kb = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss
            fams.append(gauge("process_max_rss_bytes",
                              "peak resident set size",
                              rss_kb * 1024))
        except Exception:  # noqa: BLE001 — platform-dependent
            pass
        return fams

    return collect


# ---------------------------------------------------------------------------
# Default registry + module-level snapshot
# ---------------------------------------------------------------------------

def standard_collectors(registry: MetricsRegistry) -> MetricsRegistry:
    """Register the always-available process-wide collectors."""
    registry.register("runtime", runtime_collector())
    registry.register("process", process_collector())
    registry.register("memory", memory_collector())
    return registry


default_registry = standard_collectors(MetricsRegistry())


def metrics_snapshot(registry: Optional[MetricsRegistry] = None
                     ) -> Dict[str, Any]:
    """One consistent pull over every registered collector (the
    process-default registry unless one is given)."""
    return (registry or default_registry).snapshot()


# ---------------------------------------------------------------------------
# The opt-in HTTP endpoint
# ---------------------------------------------------------------------------

class MetricsServer:
    """stdlib ThreadingHTTPServer exposing /metrics + /healthz (+
    /alerts when an alerts_fn is attached).

        srv = MetricsServer(registry, health_fn=fleet.health).start()
        ...  # scrape http://127.0.0.1:{srv.port}/metrics
        srv.close()

    `alerts_fn` (observe pillar 9) returns the AlertEngine.state()
    JSON served on /alerts; it is read per-request, so attaching an
    engine AFTER the server started (`srv.alerts_fn = engine.state`)
    works — /alerts answers 404 until then.  Binds 127.0.0.1 by
    default (`host=` to override deliberately — the exposition carries
    operational detail).  port=0 picks an ephemeral port, read back
    from `.port`.
    """

    def __init__(self, registry: MetricsRegistry,
                 health_fn: Optional[Callable[[], Dict[str, Any]]]
                 = None, host: str = "127.0.0.1", port: int = 0,
                 alerts_fn: Optional[Callable[[], Dict[str, Any]]]
                 = None):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API
                route = self.path.split("?")[0]
                if route == "/metrics":
                    body = server_ref.registry.prometheus_text() \
                        .encode("utf-8")
                    ctype = ("text/plain; version=0.0.4; "
                             "charset=utf-8")
                elif route == "/healthz":
                    health = ({"ok": True}
                              if server_ref.health_fn is None
                              else server_ref.health_fn())
                    body = json.dumps(
                        health, default=str).encode("utf-8")
                    ctype = "application/json"
                elif route == "/alerts" \
                        and server_ref.alerts_fn is not None:
                    body = json.dumps(
                        server_ref.alerts_fn(),
                        default=str).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet: scrapes are periodic
                pass

        self.registry = registry
        self.health_fn = health_fn
        self.alerts_fn = alerts_fn
        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"metrics-server:{self.port}", daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
