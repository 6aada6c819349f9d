"""Observability: structured run events, runtime accounting,
per-request tracing, device-side step telemetry and numerics (the
jax-free part of paddle_tpu/observe that the serving and training
slices use)."""

from .events import RunEventLog  # noqa: F401
from .metrics import (TELEMETRY_VAR, StepTelemetry,  # noqa: F401
                      enable_telemetry, fetch_telemetry, init_telemetry,
                      telemetry_enabled)
from .monitoring import LatencyHistogram, runtime_stats  # noqa: F401
from .numerics import (GROUP_NAMES, enable_numerics,  # noqa: F401
                       format_numerics_table, group_of,
                       join_first_nonfinite, numerics_enabled,
                       numerics_report, param_groups,
                       worst_update_ratio)
from .reqtrace import ReqTracer, RequestTrace, Span  # noqa: F401
