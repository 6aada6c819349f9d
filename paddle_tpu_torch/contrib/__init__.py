"""High-level contrib APIs (reference: python/paddle/fluid/contrib/):
the Trainer, the Inferencer, `serve()` and `slim` (pruning and
distillation)."""

from . import slim  # noqa: F401
from .serving import serve  # noqa: F401
from .trainer import (BeginEpochEvent, BeginStepEvent,  # noqa: F401
                      CheckpointConfig, EndEpochEvent, EndStepEvent,
                      Inferencer, Trainer)
