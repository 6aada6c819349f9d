"""Observability: structured run events, runtime accounting and
per-request tracing (the jax-free part of paddle_tpu/observe that the
serving slice uses)."""

from .events import RunEventLog  # noqa: F401
from .monitoring import LatencyHistogram, runtime_stats  # noqa: F401
from .reqtrace import ReqTracer, RequestTrace, Span  # noqa: F401
