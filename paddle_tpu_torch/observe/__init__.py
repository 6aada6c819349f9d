"""Observability: structured run events, runtime accounting,
per-request tracing, device-side step telemetry and numerics, and the
wall-clock goodput ledger (the jax-free part of paddle_tpu/observe that
the serving and training slices use)."""

from .events import (DECODE_EVENTS, FEED_EVENTS,  # noqa: F401
                     FLEET_EVENTS, GANG_EVENTS, GOODPUT_EVENTS,
                     NUMERICS_EVENTS, RESILIENCE_EVENTS, SERVING_EVENTS,
                     BoundEventLog, RunEventLog, read_events)
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
from .reqtrace import ReqTracer, RequestTrace, Span  # noqa: F401


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
    max_log_bytes: size-bound the JSONL log created from `log_path`;
        RunEventLog's rotation raises until ROADMAP A step 11, so only
        None (unbounded) works today.
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
