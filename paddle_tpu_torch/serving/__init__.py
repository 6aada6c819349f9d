"""Serving: the continuous-batching decode engine over a paged KV cache
(the port of paddle_tpu/serving, role "unified"), with speculative
decoding (`speculate.py`)."""

from .admission import (AdmissionController, CircuitBreaker,  # noqa: F401
                        CircuitOpenError, DeadlineExceededError,
                        ExecutorFailureError, QueueFullError,
                        ServingClosedError, ServingError)
from .decode import (DecodeBucketMissError, DecodeConfig,  # noqa: F401
                     DecodeEngine, DecodeReplicaFailedError, PagePool)
from .speculate import (Drafter, ModelDrafter,  # noqa: F401
                        NGramDrafter, ngram_propose)
from .stats import DecodeStats  # noqa: F401
