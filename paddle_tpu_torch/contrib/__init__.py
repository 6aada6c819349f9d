"""High-level contrib APIs (reference: python/paddle/fluid/contrib/):
the Trainer and Inferencer.  `contrib.serving` waits for ROADMAP queue A
step 9 and `contrib.slim` for step 12."""

from .trainer import (BeginEpochEvent, BeginStepEvent,  # noqa: F401
                      CheckpointConfig, EndEpochEvent, EndStepEvent,
                      Inferencer, Trainer)
