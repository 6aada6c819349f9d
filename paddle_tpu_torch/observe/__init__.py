"""Observability: structured run events, runtime accounting,
per-request tracing, device-side step telemetry and numerics, the
wall-clock goodput ledger, and the metrics and alerts plane (the
registry and its /metrics server, the AlertEngine and its rule packs,
the FlightRecorder).  The reference's cost, memory and trace modules
are ROADMAP A step 11."""

from .alerts import (AlertEngine, AlertRule, AnomalyRule,  # noqa: F401
                     BurnRateRule, MetricSelector, ThresholdRule,
                     disagg_rule_pack, fleet_rule_pack,
                     serving_rule_pack, snapshot_value,
                     speculate_rule_pack, trainer_rule_pack)
from .events import (ALERT_EVENTS, DECODE_EVENTS,  # noqa: F401
                     DISAGG_EVENTS, FEED_EVENTS, FLEET_EVENTS,
                     FLIGHT_EVENTS, GANG_EVENTS, GOODPUT_EVENTS,
                     NUMERICS_EVENTS, RESILIENCE_EVENTS, SERVING_EVENTS,
                     BoundEventLog, RunEventLog, git_sha, new_run_id,
                     read_events, register_event_kinds, set_strict_kinds)
from .flightrec import FlightRecorder  # noqa: F401
from .goodput import (CATEGORIES as GOODPUT_CATEGORIES,  # noqa: F401
                      GoodputLedger, format_goodput_table,
                      goodput_report)
from .metrics import (TELEMETRY_VAR, StepTelemetry,  # noqa: F401
                      enable_telemetry, fetch_telemetry, init_telemetry,
                      telemetry_enabled)
from .monitoring import (LatencyHistogram, RuntimeStats,  # noqa: F401
                         peak_memory_bytes, runtime_stats)
from .numerics import (GROUP_NAMES, enable_numerics,  # noqa: F401
                       format_numerics_table, group_of,
                       join_first_nonfinite, numerics_enabled,
                       numerics_report, param_groups,
                       worst_update_ratio)
from .registry import (MetricFamily, MetricsRegistry,  # noqa: F401
                       MetricsServer, default_registry,
                       disagg_collector, fleet_collector,
                       gang_collector, goodput_collector,
                       memory_collector, metrics_snapshot,
                       process_collector, recovery_collector,
                       runtime_collector,
                       serving_stats_collector, standard_collectors,
                       telemetry_collector, tracer_collector)
from .reqtrace import (TAIL_KEEP_MARKS, ReqTracer,  # noqa: F401
                       RequestTrace, Span, new_trace_id)


class TelemetryConfig:
    """How contrib.Trainer publishes telemetry (reference:
    paddle_tpu/observe/__init__.py TelemetryConfig).

    interval: fetch the device accumulator every N steps (the
        "device-accumulate, periodic-fetch" cadence — never per-step).
    log_path: write telemetry windows to this JSONL file (a
        RunEventLog is created per training run).
    event_log: alternatively, an existing RunEventLog to emit into.
    numerics: also enable observe pillar 6 on the train program —
        per-layer (named parameter group) training dynamics riding the
        same accumulator, and first-nonfinite op provenance; a window
        that latched a poisoned step additionally emits a
        `nonfinite_provenance` event through the RunEventLog.
    max_log_bytes: size-bound the JSONL log created from `log_path`
        (RunEventLog max_bytes rotation); None = unbounded.
    """

    def __init__(self, interval: int = 10, log_path=None, event_log=None,
                 numerics: bool = False, max_log_bytes=None):
        if interval < 1:
            raise ValueError("telemetry interval must be >= 1")
        self.interval = int(interval)
        self.log_path = log_path
        self.event_log = event_log
        self.numerics = bool(numerics)
        self.max_log_bytes = max_log_bytes
