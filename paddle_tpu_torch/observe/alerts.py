"""SLO alert engine: the port of paddle_tpu/observe/alerts.py.

Declarative rules evaluated over `MetricsRegistry` snapshots, on demand
(`evaluate()`) or on a background host thread.  The engine only ever
calls `registry.snapshot()`, whose collectors read host-side counters
and histograms, so it launches nothing on the device and changes no
program the step runs.

Rule taxonomy:

- **ThresholdRule** — value vs a fixed target, with optional `window_s`
  turning a cumulative counter into a per-second rate first.  `clear`
  gives hysteresis: a firing rule only un-breaches once the value
  crosses the clear threshold (not merely the firing one).
- **BurnRateRule** — multi-window error-budget burn for ratio SLOs
  (bad/total counters): fires only when the burn factor exceeds the
  threshold over BOTH the long and the short window.
- **AnomalyRule** — z-score vs a rolling baseline (loss spikes,
  grad-norm excursions, throughput regression via `rate=True`).  The
  baseline stops absorbing samples while the rule fires.

Every rule walks a pending -> firing -> resolved state machine gated by
`for_duration_s` and `resolve_duration_s`; transitions emit registered
`alert_*` events into the `RunEventLog`, the engine exports an `alerts`
collector family for `/metrics`, serves a JSON view on the `/alerts`
route, and `signals()` returns the rule-id -> {firing, value, target}
map the disagg `Autoscaler` consumes.

`fleet_rule_pack` / `trainer_rule_pack` / `serving_rule_pack` /
`disagg_rule_pack` are the default packs `Fleet.enable_alerts()` /
`Trainer.enable_alerts()` / `ServingEngine.enable_alerts()` /
`DisaggFleet.enable_alerts()` install; `speculate_rule_pack` watches a
speculative engine's accept rate.  The rules key on the reference's
metric names (observe/registry.py).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .registry import MetricFamily, MetricsRegistry, counter, gauge

ALERT_STATES = ("inactive", "pending", "firing")
_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


# ---------------------------------------------------------------------------
# Reading values out of a MetricsRegistry snapshot
# ---------------------------------------------------------------------------

def snapshot_value(snapshot: Dict[str, Any], family: str,
                   labels: Optional[Dict[str, Any]] = None,
                   percentile: Optional[float] = None
                   ) -> Optional[float]:
    """Extract one scalar from a `MetricsRegistry.snapshot()` dict.

    `labels` filters samples (subset match).  For histogram families
    `percentile` (0-100) is read off the cumulative buckets — the same
    log-bin edges Prometheus scrapes, so an alert threshold and a
    dashboard query agree bin for bin.  Counters with several matching
    samples sum (the Prometheus aggregation); gauges average.  Returns
    None when the family/sample does not exist yet — "no data", which
    the state machine treats as neither breach nor clear.
    """
    fam = snapshot.get(family)
    if fam is None:
        return None
    want = labels or {}
    matched = [s for s in fam["samples"]
               if all(str(s["labels"].get(k)) == str(v)
                      for k, v in want.items())]
    if not matched:
        return None
    if fam["kind"] == "histogram":
        if percentile is None:
            raise ValueError(
                f"{family} is a histogram; pass percentile=")
        # samples with several label sets (e.g. reqtrace phases) were
        # narrowed by `labels`; merge what remains cumulatively
        count = sum(s["count"] for s in matched)
        if count == 0:
            return None
        target = max(1, math.ceil(count * percentile / 100.0))
        seen = 0
        edges: Dict[float, int] = {}
        for s in matched:
            prev = 0
            for le, cum in s["buckets"]:
                edges[le] = edges.get(le, 0) + (cum - prev)
                prev = cum
        for le in sorted(edges):
            seen += edges[le]
            if seen >= target:
                return float(le)
        return float(max(edges)) if edges else None
    vals = [s["value"] for s in matched]
    if fam["kind"] == "counter":
        return float(sum(vals))
    return float(sum(vals) / len(vals))


class MetricSelector:
    """Declarative pointer into a snapshot: family + label filter +
    optional histogram percentile."""

    def __init__(self, family: str,
                 labels: Optional[Dict[str, Any]] = None,
                 percentile: Optional[float] = None):
        self.family = family
        self.labels = dict(labels) if labels else None
        self.percentile = percentile

    def __call__(self, snapshot: Dict[str, Any]) -> Optional[float]:
        return snapshot_value(snapshot, self.family, self.labels,
                              self.percentile)

    def __repr__(self):
        parts = [self.family]
        if self.labels:
            parts.append(str(self.labels))
        if self.percentile is not None:
            parts.append(f"p{self.percentile:g}")
        return "MetricSelector(" + ", ".join(parts) + ")"


def _as_value_fn(source) -> Callable[[Dict[str, Any]], Optional[float]]:
    if isinstance(source, str):
        return MetricSelector(source)
    if callable(source):
        return source
    raise TypeError(f"rule source must be a family name, a "
                    f"MetricSelector, or a callable; got {source!r}")


class _RateTracker:
    """Windowed per-second rate of a cumulative counter: keeps (t,
    value) samples and differences against the newest sample at least
    `window_s` old (falling back to the oldest held) — two samples
    minimum, else no data."""

    def __init__(self, window_s: float):
        self.window_s = float(window_s)
        self._hist: deque = deque()

    def rate(self, now: float, value: Optional[float]
             ) -> Optional[float]:
        if value is None:
            return None
        self._hist.append((now, value))
        # keep the newest sample older than the window as the
        # reference; drop anything older than that
        ref_i = 0
        for i, (t, _) in enumerate(self._hist):
            if t <= now - self.window_s:
                ref_i = i
            else:
                break
        for _ in range(ref_i):
            self._hist.popleft()
        if len(self._hist) < 2:
            return None
        t0, v0 = self._hist[0]
        if now <= t0:
            return None
        return (value - v0) / (now - t0)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

class AlertRule:
    """Base rule: subclasses implement `observe(snapshot, now)` →
    (value, breach, cleared); the base walks the pending → firing →
    resolved state machine with `for_duration_s` / `resolve_duration_s`
    gating.  A None value is "no data": the state is held, never
    advanced (missing metrics must not fire OR resolve anything)."""

    def __init__(self, rule_id: str, description: str = "",
                 severity: str = "page", for_duration_s: float = 0.0,
                 resolve_duration_s: float = 0.0,
                 target: Optional[float] = None):
        if not rule_id:
            raise ValueError("rule_id is required")
        self.id = rule_id
        self.description = description
        self.severity = severity
        self.for_duration_s = float(for_duration_s)
        self.resolve_duration_s = float(resolve_duration_s)
        self.target = target
        self.state = "inactive"
        self.value: Optional[float] = None
        self.since: Optional[float] = None       # state entry time
        self.fired_count = 0
        self.transitions = 0
        self._breach_since: Optional[float] = None
        self._clear_since: Optional[float] = None

    # subclasses override
    def observe(self, snapshot: Dict[str, Any], now: float
                ) -> Tuple[Optional[float], bool, bool]:
        raise NotImplementedError

    def step(self, snapshot: Dict[str, Any], now: float
             ) -> Optional[str]:
        """One evaluation; returns the transition event kind emitted
        ('alert_pending' / 'alert_firing' / 'alert_resolved') or
        None."""
        value, breach, cleared = self.observe(snapshot, now)
        self.value = value
        if value is None:
            return None  # no data: hold state
        transition = None
        if self.state in ("inactive",):
            if breach:
                self._breach_since = (self._breach_since
                                      if self._breach_since is not None
                                      else now)
                if now - self._breach_since >= self.for_duration_s:
                    self.state = "firing"
                    self.since = now
                    self.fired_count += 1
                    transition = "alert_firing"
                elif self.state != "pending":
                    self.state = "pending"
                    self.since = now
                    transition = "alert_pending"
            else:
                self._breach_since = None
        elif self.state == "pending":
            if breach:
                if now - self._breach_since >= self.for_duration_s:
                    self.state = "firing"
                    self.since = now
                    self.fired_count += 1
                    transition = "alert_firing"
            else:
                self._breach_since = None
                self.state = "inactive"
                self.since = now
        elif self.state == "firing":
            if cleared:
                self._clear_since = (self._clear_since
                                     if self._clear_since is not None
                                     else now)
                if now - self._clear_since >= self.resolve_duration_s:
                    self.state = "inactive"
                    self.since = now
                    self._breach_since = None
                    self._clear_since = None
                    transition = "alert_resolved"
            else:
                self._clear_since = None
        if transition:
            self.transitions += 1
        return transition

    @property
    def firing(self) -> bool:
        return self.state == "firing"

    def as_dict(self) -> Dict[str, Any]:
        return {"id": self.id, "state": self.state,
                "firing": self.firing, "value": self.value,
                "target": self.target, "severity": self.severity,
                "description": self.description, "since": self.since,
                "fired_count": self.fired_count}


class ThresholdRule(AlertRule):
    """value `op` threshold, with optional counter→rate conversion and
    a hysteresis `clear` threshold.

        ThresholdRule("ttft_p99",
                      MetricSelector("serving_ttft_ms", percentile=99),
                      op=">", threshold=500.0, clear=400.0,
                      for_duration_s=30.0)
        ThresholdRule("compile_storm", "runtime_retraces_total",
                      op=">", threshold=0.2, window_s=60.0)  # retraces/s
    """

    def __init__(self, rule_id: str, source, op: str = ">",
                 threshold: float = 0.0,
                 clear: Optional[float] = None,
                 window_s: Optional[float] = None, **kw):
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}")
        kw.setdefault("target", float(threshold))
        super().__init__(rule_id, **kw)
        self.value_fn = _as_value_fn(source)
        self.op = op
        self.threshold = float(threshold)
        self.clear = float(clear) if clear is not None else None
        self._rate = _RateTracker(window_s) if window_s else None

    def observe(self, snapshot, now):
        raw = self.value_fn(snapshot)
        value = (self._rate.rate(now, raw) if self._rate is not None
                 else raw)
        if value is None:
            return None, False, False
        breach = _OPS[self.op](value, self.threshold)
        if self.clear is None:
            return value, breach, not breach
        # hysteresis: clearing requires crossing the clear threshold
        # in the non-breach direction, not merely un-breaching
        cleared = not _OPS[self.op](value, self.clear)
        return value, breach, cleared


class BurnRateRule(AlertRule):
    """Multi-window error-budget burn over a bad/total counter pair.

    bad_ratio(w) = Δbad / Δtotal over window w; burn = bad_ratio/slo.
    Breaches when burn >= `burn_factor` over BOTH `long_window_s` and
    `short_window_s`; clears when the short window drops back under.
    Reported value = the long-window burn factor."""

    def __init__(self, rule_id: str, bad, total, slo: float,
                 burn_factor: float = 1.0,
                 long_window_s: float = 300.0,
                 short_window_s: float = 30.0, **kw):
        if slo <= 0:
            raise ValueError("slo must be a positive bad-event budget "
                             "fraction")
        kw.setdefault("target", float(burn_factor))
        super().__init__(rule_id, **kw)
        self.bad_fn = _as_value_fn(bad)
        self.total_fn = _as_value_fn(total)
        self.slo = float(slo)
        self.burn_factor = float(burn_factor)
        self.windows = {"long": float(long_window_s),
                        "short": float(short_window_s)}
        self._hist: deque = deque()

    def _burn(self, now: float, window_s: float) -> Optional[float]:
        ref = None
        for t, bad, tot in self._hist:
            if t <= now - window_s:
                ref = (t, bad, tot)
            else:
                break
        if ref is None:
            ref = self._hist[0]
        t0, bad0, tot0 = ref
        cur_t, cur_bad, cur_tot = self._hist[-1]
        if cur_t <= t0 or cur_tot <= tot0:
            return None  # no traffic in the window: no data
        return ((cur_bad - bad0) / (cur_tot - tot0)) / self.slo

    def observe(self, snapshot, now):
        bad = self.bad_fn(snapshot)
        tot = self.total_fn(snapshot)
        if bad is None or tot is None:
            return None, False, False
        self._hist.append((now, bad, tot))
        horizon = now - max(self.windows.values())
        while len(self._hist) > 2 and self._hist[1][0] <= horizon:
            self._hist.popleft()
        burns = {name: self._burn(now, w)
                 for name, w in self.windows.items()}
        if burns["long"] is None:
            return None, False, False
        breach = all(b is not None and b >= self.burn_factor
                     for b in burns.values())
        cleared = (burns["short"] is None
                   or burns["short"] < self.burn_factor)
        return burns["long"], breach, cleared


class AnomalyRule(AlertRule):
    """z-score vs a rolling baseline of this rule's own past samples.

    direction: "above" (loss spike), "below" (throughput regression),
    or "both" (grad-norm excursion).  `rate=True` differences a
    cumulative counter into a per-second rate first (`window_s` sets
    the differencing window).  The baseline stops absorbing samples
    while firing, so a sustained anomaly cannot normalize itself.
    Reported value = the z-score."""

    def __init__(self, rule_id: str, source, z: float = 4.0,
                 direction: str = "above", min_samples: int = 5,
                 baseline: int = 64, rate: bool = False,
                 window_s: float = 30.0, min_std: float = 1e-9, **kw):
        if direction not in ("above", "below", "both"):
            raise ValueError("direction must be above/below/both")
        kw.setdefault("target", float(z))
        super().__init__(rule_id, **kw)
        self.value_fn = _as_value_fn(source)
        self.z = float(z)
        self.direction = direction
        self.min_samples = int(min_samples)
        self.min_std = float(min_std)
        self._rate = _RateTracker(window_s) if rate else None
        self._baseline: deque = deque(maxlen=int(baseline))
        self.sample: Optional[float] = None  # last raw sample

    def observe(self, snapshot, now):
        raw = self.value_fn(snapshot)
        value = (self._rate.rate(now, raw) if self._rate is not None
                 else raw)
        if value is None:
            return None, False, False
        self.sample = value
        if len(self._baseline) < self.min_samples:
            self._baseline.append(value)
            return 0.0, False, True
        mean = sum(self._baseline) / len(self._baseline)
        var = (sum((v - mean) ** 2 for v in self._baseline)
               / len(self._baseline))
        std = max(math.sqrt(var), self.min_std)
        score = (value - mean) / std
        if self.direction == "above":
            breach = score > self.z
        elif self.direction == "below":
            breach = score < -self.z
        else:
            breach = abs(score) > self.z
        if not (breach or self.state == "firing"):
            self._baseline.append(value)
        zval = (abs(score) if self.direction == "both"
                else score if self.direction == "above" else -score)
        return zval, breach, not breach


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class AlertEngine:
    """Evaluates rules over `registry.snapshot()` — synchronously via
    `evaluate()` or on a background daemon thread (`start()`).

    - transitions emit `alert_pending`/`alert_firing`/`alert_resolved`
      events into `event_log` (registered kinds, strict-mode clean);
    - `collector()` is the `alerts` MetricFamily source for /metrics
      (register it on the same registry — it reads rule state, it does
      not re-evaluate);
    - `state()` is the `/alerts` JSON body; `signals()` the autoscaler
      view (rule id → firing + value vs target);
    - `add_firing_hook(fn)`: fn(rule, record) runs on every firing
      transition (the FlightRecorder attaches here).

    Pure host: the only data source is the registry snapshot — nothing
    is launched on the device from this thread."""

    def __init__(self, registry: MetricsRegistry,
                 rules: Sequence[AlertRule] = (),
                 interval_s: float = 5.0, event_log=None,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.interval_s = float(interval_s)
        self.event_log = event_log
        self.clock = clock
        self._lock = threading.RLock()
        self._rules: Dict[str, AlertRule] = {}
        self._firing_hooks: List[Callable[[AlertRule, Dict[str, Any]],
                                          None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.evaluations = 0
        self.last_eval_ts: Optional[float] = None
        self.eval_errors = 0
        for r in rules:
            self.add_rule(r)

    # -- rule management ------------------------------------------------
    def add_rule(self, rule: AlertRule) -> "AlertEngine":
        with self._lock:
            if rule.id in self._rules:
                raise ValueError(f"duplicate rule id {rule.id!r}")
            self._rules[rule.id] = rule
        return self

    def remove_rule(self, rule_id: str) -> None:
        with self._lock:
            self._rules.pop(rule_id, None)

    @property
    def rules(self) -> List[AlertRule]:
        with self._lock:
            return [self._rules[k] for k in sorted(self._rules)]

    def add_firing_hook(self, fn: Callable[[AlertRule, Dict[str, Any]],
                                           None]) -> None:
        with self._lock:
            self._firing_hooks.append(fn)

    # -- evaluation -----------------------------------------------------
    def evaluate(self, now: Optional[float] = None,
                 snapshot: Optional[Dict[str, Any]] = None
                 ) -> List[Tuple[AlertRule, str]]:
        """One pass: pull a snapshot, step every rule, emit transition
        events, run firing hooks.  Returns [(rule, transition), ...]
        for this pass.  `now`/`snapshot` are injectable for tests and
        replay."""
        now = self.clock() if now is None else now
        if snapshot is None:
            try:
                snapshot = self.registry.snapshot()
            except Exception:  # noqa: BLE001 — a sick registry must not
                self.eval_errors += 1  # kill the alert thread
                return []
        transitions: List[Tuple[AlertRule, str]] = []
        with self._lock:
            rules = list(self._rules.values())
            hooks = list(self._firing_hooks)
        for rule in rules:
            try:
                kind = rule.step(snapshot, now)
            except Exception:  # noqa: BLE001 — one bad rule is isolated
                self.eval_errors += 1
                continue
            if kind is None:
                continue
            record = {"rule": rule.id, "state": rule.state,
                      "value": rule.value, "target": rule.target,
                      "severity": rule.severity,
                      "description": rule.description}
            transitions.append((rule, kind))
            if self.event_log is not None:
                try:
                    self.event_log.event(kind, **record)
                except Exception:  # noqa: BLE001
                    pass
            if kind == "alert_firing":
                for fn in hooks:
                    try:
                        fn(rule, dict(record))
                    except Exception:  # noqa: BLE001 — hooks are
                        pass           # best-effort diagnostics
        with self._lock:
            self.evaluations += 1
            self.last_eval_ts = time.time()
        return transitions

    # -- background thread ----------------------------------------------
    def start(self) -> "AlertEngine":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                self.evaluate()

        self._thread = threading.Thread(
            target=loop, name="alert-engine", daemon=True)
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "AlertEngine":
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- views -----------------------------------------------------------
    def firing(self) -> List[str]:
        return [r.id for r in self.rules if r.firing]

    def signals(self) -> Dict[str, Dict[str, Any]]:
        """The autoscaler-facing view: rule id → firing bool + current
        value vs target (+ state/severity).  A scaling policy consumes
        exactly this (serving/disagg.py `Autoscaler`)."""
        return {r.id: {"firing": r.firing, "state": r.state,
                       "value": r.value, "target": r.target,
                       "severity": r.severity}
                for r in self.rules}

    def state(self) -> Dict[str, Any]:
        """The `/alerts` route body: full rule detail + engine
        counters."""
        rules = [r.as_dict() for r in self.rules]
        return {"firing": [r["id"] for r in rules if r["firing"]],
                "rules": rules,
                "evaluations": self.evaluations,
                "eval_errors": self.eval_errors,
                "interval_s": self.interval_s,
                "running": self.running,
                "last_eval_ts": self.last_eval_ts}

    def collector(self) -> Callable[[], List[MetricFamily]]:
        """The `alerts` family source for /metrics — reads rule state
        (set by the engine's own cadence), never re-evaluates, so
        registering it on the engine's OWN registry cannot recurse."""

        def collect() -> List[MetricFamily]:
            rules = self.rules
            firing = gauge("alerts_firing",
                           "1 while the rule is in the firing state")
            value = gauge("alerts_value",
                          "last evaluated rule value")
            target = gauge("alerts_target", "rule threshold/target")
            fired = counter("alerts_fired_total",
                            "lifetime firing transitions")
            for r in rules:
                lbl = {"rule": r.id, "severity": r.severity}
                firing.add(1 if r.firing else 0, **lbl)
                value.add(r.value, **lbl)
                target.add(r.target, **lbl)
                fired.add(r.fired_count, **lbl)
            return [firing, value, target, fired,
                    counter("alerts_evaluations_total",
                            "alert evaluation passes",
                            self.evaluations),
                    gauge("alerts_rules", "registered rules",
                          len(rules))]

        return collect


# ---------------------------------------------------------------------------
# Default rule packs
# ---------------------------------------------------------------------------

def fleet_rule_pack(fleet=None, *, ttft_p99_ms: float = 2000.0,
                    tpot_p99_ms: float = 200.0,
                    queue_wait_p99_ms: float = 1000.0,
                    error_slo: float = 0.01,
                    failover_window_s: float = 60.0,
                    failover_rate_per_s: float = 0.0,
                    saturated_window_s: float = 60.0,
                    for_duration_s: float = 0.0,
                    resolve_duration_s: float = 0.0
                    ) -> List[AlertRule]:
    """The serving-SLO pack `Fleet.enable_alerts()` installs.

    - `fleet_error_rate`: multiwindow burn of failed/submitted vs the
      `error_slo` budget (the paging rule).
    - `fleet_failover_rate`: ANY failover inside the window fires (a
      replica died mid-request; default threshold 0/s means one event
      trips it, and the rule resolves once the window slides past).
    - `fleet_saturated`: whole-fleet sheds observed in the window.
    - `fleet_replicas_down`: healthy_replicas below the fleet size.
    - TTFT / TPOT / queue_wait p99 thresholds from the decode-stats and
      reqtrace histograms (rules stay silent — "no data" — on fleets
      without those surfaces)."""
    kw = {"for_duration_s": for_duration_s,
          "resolve_duration_s": resolve_duration_s}
    rules = [
        BurnRateRule(
            "fleet_error_rate",
            MetricSelector("fleet_failed_total"),
            MetricSelector("fleet_submitted_total"),
            slo=error_slo, burn_factor=1.0,
            long_window_s=max(failover_window_s * 5, 300.0),
            short_window_s=failover_window_s,
            description="client-visible failure budget burning",
            **kw),
        ThresholdRule(
            "fleet_failover_rate",
            MetricSelector("fleet_failovers_total"),
            op=">", threshold=failover_rate_per_s,
            window_s=failover_window_s,
            description="in-flight requests are failing over "
                        "(a replica died mid-request)", **kw),
        ThresholdRule(
            "fleet_saturated",
            MetricSelector("fleet_saturated_total"),
            op=">", threshold=0.0, window_s=saturated_window_s,
            description="whole-fleet saturation fast-rejects",
            **kw),
        ThresholdRule(
            "serving_ttft_p99",
            MetricSelector("serving_ttft_ms", percentile=99),
            op=">", threshold=ttft_p99_ms,
            clear=ttft_p99_ms * 0.8,
            description="time-to-first-token p99 over SLO", **kw),
        ThresholdRule(
            "serving_tpot_p99",
            MetricSelector("serving_tpot_ms", percentile=99),
            op=">", threshold=tpot_p99_ms,
            clear=tpot_p99_ms * 0.8,
            description="time-per-output-token p99 over SLO", **kw),
        ThresholdRule(
            "serving_queue_wait_p99",
            MetricSelector("reqtrace_phase_ms",
                           labels={"phase": "queue_wait"},
                           percentile=99),
            op=">", threshold=queue_wait_p99_ms,
            clear=queue_wait_p99_ms * 0.8,
            description="admission queue wait p99 over SLO "
                        "(the autoscaler's scale-up signal)", **kw),
    ]
    if fleet is not None:
        rules.append(ThresholdRule(
            "fleet_replicas_down",
            MetricSelector("fleet_healthy_replicas"),
            op="<", threshold=float(len(fleet.replicas)),
            description="at least one replica is not routable",
            severity="ticket", **kw))
    return rules


def serving_rule_pack(*, e2e_p99_ms: float = 1000.0,
                      error_slo: float = 0.01,
                      window_s: float = 60.0,
                      for_duration_s: float = 0.0,
                      resolve_duration_s: float = 0.0
                      ) -> List[AlertRule]:
    """Single-engine pack (`ServingEngine.enable_alerts()`): e2e p99,
    error-budget burn over rejected+failed, and the post-warmup
    compile tripwire (ANY compile after warmup is a bug — the
    zero-compile contract as an alert)."""
    kw = {"for_duration_s": for_duration_s,
          "resolve_duration_s": resolve_duration_s}

    def bad(snapshot):
        vals = [snapshot_value(snapshot, f"serving_{k}_total")
                for k in ("shed", "circuit_rejects",
                          "executor_failures", "deadline_misses")]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    return [
        ThresholdRule(
            "serving_e2e_p99",
            MetricSelector("serving_e2e_ms", percentile=99),
            op=">", threshold=e2e_p99_ms, clear=e2e_p99_ms * 0.8,
            description="end-to-end latency p99 over SLO", **kw),
        BurnRateRule(
            "serving_error_rate", bad,
            MetricSelector("serving_submitted_total"),
            slo=error_slo, burn_factor=1.0,
            long_window_s=max(window_s * 5, 300.0),
            short_window_s=window_s,
            description="reject+failure budget burning", **kw),
        ThresholdRule(
            "serving_post_warmup_compiles",
            MetricSelector("serving_post_warmup_compiles"),
            op=">", threshold=0.0,
            description="a shape leaked past the bucket ladder "
                        "(zero-compile contract broken)", **kw),
    ]


def disagg_rule_pack(fleet=None, *,
                     prefill_wait_p99_ms: float = 1000.0,
                     tpot_p99_ms: float = 200.0,
                     handoff_p99_ms: float = 250.0,
                     error_slo: float = 0.01,
                     window_s: float = 60.0,
                     for_duration_s: float = 0.0,
                     resolve_duration_s: float = 0.0
                     ) -> List[AlertRule]:
    """The phase-split SLO pack `DisaggFleet.enable_alerts()` installs
    — and the Autoscaler's signal source (serving/disagg.py): each
    phase scales on ITS rule, which is exactly why the pack is split
    by phase instead of reusing the joint fleet pack.

    - `disagg_prefill_wait_p99`: the prefill workers' merged TTFT
      histogram (queue wait + bucketed prefill dispatch) — the
      scale-UP-prefill signal.
    - `disagg_decode_tpot_p99`: the decode workers' merged
      time-per-output-token — the scale-UP-decode signal.
    - `disagg_handoff_p99`: export gather + router relay + import
      admission per KV hop (a slow transfer plane is its own
      pathology, not a capacity one — severity ticket).
    - `disagg_error_rate`: client-visible failure budget burn.
    - `serving_post_warmup_compiles`: ANY recompile after warmup
      anywhere in the fleet (the zero-compile contract as an alert).
    """
    kw = {"for_duration_s": for_duration_s,
          "resolve_duration_s": resolve_duration_s}
    return [
        ThresholdRule(
            "disagg_prefill_wait_p99",
            MetricSelector("disagg_prefill_wait_ms", percentile=99),
            op=">", threshold=prefill_wait_p99_ms,
            clear=prefill_wait_p99_ms * 0.8,
            description="prefill-side wait p99 over SLO (the "
                        "autoscaler's scale-up-prefill signal)", **kw),
        ThresholdRule(
            "disagg_decode_tpot_p99",
            MetricSelector("disagg_decode_tpot_ms", percentile=99),
            op=">", threshold=tpot_p99_ms,
            clear=tpot_p99_ms * 0.8,
            description="decode-side TPOT p99 over SLO (the "
                        "autoscaler's scale-up-decode signal)", **kw),
        ThresholdRule(
            "disagg_handoff_p99",
            MetricSelector("disagg_handoff_ms", percentile=99),
            op=">", threshold=handoff_p99_ms,
            clear=handoff_p99_ms * 0.8, severity="ticket",
            description="KV-page handoff latency p99 over SLO",
            **kw),
        BurnRateRule(
            "disagg_error_rate",
            MetricSelector("disagg_failed_total"),
            MetricSelector("disagg_submitted_total"),
            slo=error_slo, burn_factor=1.0,
            long_window_s=max(window_s * 5, 300.0),
            short_window_s=window_s,
            description="client-visible failure budget burning",
            **kw),
        ThresholdRule(
            "serving_post_warmup_compiles",
            MetricSelector("serving_post_warmup_compiles"),
            op=">", threshold=0.0,
            description="a recompile leaked past warmup somewhere in "
                        "the fleet (zero-compile contract broken)",
            **kw),
    ]


def speculate_rule_pack(*, min_accept_rate: float = 0.3,
                        min_efficiency: float = 0.0,
                        for_duration_s: float = 0.0,
                        resolve_duration_s: float = 0.0
                        ) -> List[AlertRule]:
    """Speculative-decoding health pack.

    - `serving_speculation_accept_low`: the cumulative accept rate
      dropped under `min_accept_rate`.  Below that floor the verify
      rows mostly score rejected drafts — the engine is paying the
      folded-batch cost of speculation without the multi-token wins,
      and a sequential engine (or a better drafter / smaller k) would
      serve the same stream faster.  Severity ticket: it is a
      throughput regression, not an outage.
    - `serving_speculation_efficiency_low` (opt-in via
      `min_efficiency` > 0): committed tokens over verify rows paid —
      the same signal normalized per row, useful when comparing
      different k settings across replicas.

    Rules stay silent ("no data") until the engine has scored drafts,
    so installing the pack on a non-speculative fleet is harmless.
    """
    kw = {"for_duration_s": for_duration_s,
          "resolve_duration_s": resolve_duration_s}
    rules = [
        ThresholdRule(
            "serving_speculation_accept_low",
            MetricSelector("serving_speculation_accept_rate"),
            op="<", threshold=min_accept_rate,
            clear=min_accept_rate * 1.2, severity="ticket",
            description="speculative accept rate under floor (drafts "
                        "mostly rejected — speculation is costing "
                        "throughput instead of buying it)", **kw),
    ]
    if min_efficiency > 0.0:
        rules.append(ThresholdRule(
            "serving_speculation_efficiency_low",
            MetricSelector("serving_speculation_efficiency"),
            op="<", threshold=min_efficiency,
            clear=min_efficiency * 1.2, severity="ticket",
            description="committed tokens per verify row under floor",
            **kw))
    return rules


def trainer_rule_pack(*, goodput_floor: float = 0.5,
                      loss_spike_z: float = 6.0,
                      grad_norm_z: float = 6.0,
                      throughput_drop_z: float = 4.0,
                      retrace_rate_per_s: float = 0.05,
                      retrace_window_s: float = 120.0,
                      gang_max_lag_steps: float = 50.0,
                      for_duration_s: float = 0.0,
                      resolve_duration_s: float = 0.0
                      ) -> List[AlertRule]:
    """The training-health pack `Trainer.enable_alerts()` installs.

    - `train_goodput_drop`: goodput fraction below the floor (ledger).
    - `train_throughput_regression`: steps/s z-score below the rolling
      baseline (AnomalyRule over the goodput step counter rate).
    - `train_loss_spike` / `train_grad_norm_anomaly`: z-score
      excursions of the pillar-6 telemetry window means.
    - `train_nonfinite`: any non-finite grad/loss step in the window.
    - `train_compile_storm`: retraces/s over budget — the
      feed-signature-drift storm (runtime_stats counter rate).
    - `gang_skew`: heartbeat step lag beyond the straggler budget
      (silent without a gang).
    - `train_recovery_rollbacks`: the divergence autopilot recovered
      in-run (ticket severity — nobody was paged, which is the point;
      silent without an autopilot)."""
    kw = {"for_duration_s": for_duration_s,
          "resolve_duration_s": resolve_duration_s}

    def nonfinite(snapshot):
        g = snapshot_value(snapshot,
                           "training_nonfinite_grad_steps_total")
        lo = snapshot_value(snapshot,
                            "training_nonfinite_loss_steps_total")
        vals = [v for v in (g, lo) if v is not None]
        return sum(vals) if vals else None

    return [
        ThresholdRule(
            "train_goodput_drop",
            MetricSelector("goodput_fraction_good"),
            op="<", threshold=goodput_floor,
            clear=min(goodput_floor * 1.2, 1.0),
            description="useful-step share of wall clock below "
                        "floor", **kw),
        AnomalyRule(
            "train_throughput_regression",
            MetricSelector("goodput_steps_total"),
            z=throughput_drop_z, direction="below", rate=True,
            description="steps/s regressed vs the rolling baseline",
            **kw),
        AnomalyRule(
            "train_loss_spike",
            MetricSelector("training_loss_mean"),
            z=loss_spike_z, direction="above",
            description="window-mean loss spiked vs baseline", **kw),
        AnomalyRule(
            "train_grad_norm_anomaly",
            MetricSelector("training_grad_norm_last"),
            z=grad_norm_z, direction="both",
            description="grad-norm excursion vs baseline", **kw),
        ThresholdRule(
            "train_nonfinite", nonfinite,
            op=">", threshold=0.0, window_s=retrace_window_s,
            description="non-finite grads/loss observed "
                        "(see nonfinite_provenance for the op)",
            **kw),
        ThresholdRule(
            "train_compile_storm",
            MetricSelector("runtime_retraces_total"),
            op=">", threshold=retrace_rate_per_s,
            window_s=retrace_window_s,
            description="step retrace storm (feed signature drift)",
            **kw),
        ThresholdRule(
            "gang_skew",
            MetricSelector("gang_max_lag_steps"),
            op=">", threshold=gang_max_lag_steps,
            clear=gang_max_lag_steps * 0.5,
            description="a rank lags the gang beyond the straggler "
                        "budget", severity="ticket", **kw),
        ThresholdRule(
            "train_recovery_rollbacks",
            MetricSelector("recovery_rollbacks_total"),
            op=">", threshold=0.0,
            description="the divergence autopilot rolled back to a "
                        "verified-good checkpoint (recovered in-run; "
                        "see recovery_rollback/data_quarantine "
                        "events for the window)",
            severity="ticket", **kw),
    ]
