"""Observability: structured run events, runtime accounting,
per-request tracing, device-side step telemetry and numerics, the
wall-clock goodput ledger, and the metrics and alerts plane (the
registry and its /metrics server, the AlertEngine and its rule packs,
the FlightRecorder), and the cost, memory and trace planes: a recorded
step's per-op flops and bytes (`op_cost_table`, `program_costs`; the
hand-written kernels' through their cost registry), its memory ledger
and the fit planner (`memory_report`, `memory_timeline`, `plan_fit`),
and the per-op time table of a `torch.profiler` trace
(`op_time_table`).  The health plane is ROADMAP A step 11b."""

from . import cost  # noqa: F401
from . import memory  # noqa: F401
from . import trace  # noqa: F401
from .alerts import (AlertEngine, AlertRule, AnomalyRule,  # noqa: F401
                     BurnRateRule, MetricSelector, ThresholdRule,
                     disagg_rule_pack, fleet_rule_pack,
                     serving_rule_pack, snapshot_value,
                     speculate_rule_pack, trainer_rule_pack)
from .cost import (bucket_summary, copyish_instructions,  # noqa: F401
                   device_peaks, flash_boundary_layout,
                   format_cost_table, layout_byte_share, op_cost_table,
                   program_costs, total_costs)
from .events import (ALERT_EVENTS, DECODE_EVENTS,  # noqa: F401
                     DISAGG_EVENTS, FEED_EVENTS, FLEET_EVENTS,
                     FLIGHT_EVENTS, GANG_EVENTS, GOODPUT_EVENTS,
                     NUMERICS_EVENTS, RESILIENCE_EVENTS, SERVING_EVENTS,
                     SPECULATE_EVENTS, BoundEventLog, RunEventLog, git_sha, new_run_id,
                     read_events, register_event_kinds, set_strict_kinds)
from .flightrec import FlightRecorder  # noqa: F401
from .goodput import (CATEGORIES as GOODPUT_CATEGORIES,  # noqa: F401
                      GoodputLedger, format_goodput_table,
                      goodput_report)
from .memory import (BUCKETS, DEVICE_HBM_BYTES,  # noqa: F401
                     PLAN_FIT_REL_TOL, device_memory_budget,
                     export_chrome_trace, format_memory_table,
                     memory_report, memory_table, memory_timeline,
                     plan_fit, resident_state_bytes,
                     sharded_memory_report, step_mem_breakdown)
from .metrics import (TELEMETRY_VAR, StepTelemetry,  # noqa: F401
                      enable_telemetry, fetch_telemetry, init_telemetry,
                      telemetry_enabled)
from .monitoring import (LatencyHistogram, RuntimeStats,  # noqa: F401
                         device_memory_stats, peak_memory_bytes,
                         runtime_stats)
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
from .trace import (fluid_op_of, format_op_table,  # noqa: F401
                    instr_time_table, op_time_table)


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
