"""paddle_tpu_torch.resilience — fault tolerance for training: the port
of the part of paddle_tpu/resilience that one training process on one
card needs.

- `guard`: the in-step non-finite update guard + dynamic loss scaling —
  a NaN step is skipped ON THE CARD inside the step
  (`enable_update_guard`, or `amp.decorate(...,
  use_dynamic_loss_scaling=True)`),
- checkpoint integrity (io.py): per-shard CRC32 verified on load and a
  structured `CheckpointError` hierarchy (`errors`),
- `chaos`: deterministic in-process fault injectors (failpoints,
  delaypoints, NaN batches, shard corruption, torn checkpoints) that
  the tests and `chip_smoke.py` use to prove the above.

Not ported yet, each under its ROADMAP queue A step: `preempt`
(`SnapshotWriter`, async checkpoint writes, the drain controller),
`watchdog` and the chaos `hang`, with the Trainer (step 6c); the chaos
replica injectors (`kill_replica`, `delay_replica`, `FlakyPredictor`;
step 9); `health`,
`supervisor`, `autopilot` and the chaos rank injectors (`kill_rank`,
`hang_rank`, `FakeKv`; step 11).
"""

from . import chaos  # noqa: F401
from .chaos import (ChaosKilled, corrupt_file,  # noqa: F401
                    corrupt_shard, nan_reader, poison_feed,
                    tear_checkpoint)
from .errors import (CheckpointBarrierPoisonedError,  # noqa: F401
                     CheckpointBarrierTimeoutError,
                     CheckpointCorruptError, CheckpointError,
                     CheckpointFormatError, CheckpointIncompleteError,
                     CheckpointNotFoundError, CheckpointStateMismatchError,
                     CheckpointWriteError, GangError, GangFailedError,
                     GangPoisonedError, PeerLostError, PeerStalledError,
                     ResilienceError, RetriesExhaustedError,
                     StepHangError, TrainingDivergedError,
                     TrainingPreempted, WatchdogTimeout)
from .guard import (LossScaleConfig, UpdateGuardConfig,  # noqa: F401
                    enable_update_guard, guard_config)
