"""Serving: the continuous-batching decode engine over a paged KV cache
(the port of paddle_tpu/serving, role "unified")."""

from .admission import (AdmissionController, CircuitBreaker,  # noqa: F401
                        CircuitOpenError, DeadlineExceededError,
                        ExecutorFailureError, QueueFullError,
                        ServingClosedError, ServingError)
from .decode import (DecodeBucketMissError, DecodeConfig,  # noqa: F401
                     DecodeEngine, DecodeReplicaFailedError, PagePool)
from .stats import DecodeStats  # noqa: F401
