"""High-level contrib APIs (reference: python/paddle/fluid/contrib/):
the Trainer, the Inferencer and `serve()`.  `contrib.slim` waits for
ROADMAP queue A step 12."""

from .serving import serve  # noqa: F401
from .trainer import (BeginEpochEvent, BeginStepEvent,  # noqa: F401
                      CheckpointConfig, EndEpochEvent, EndStepEvent,
                      Inferencer, Trainer)
