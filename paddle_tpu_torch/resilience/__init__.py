"""paddle_tpu_torch.resilience — fault tolerance for training: the port
of the part of paddle_tpu/resilience that one training process on one
card needs.

- `guard`: the in-step non-finite update guard + dynamic loss scaling —
  a NaN step is skipped ON THE CARD inside the step
  (`enable_update_guard`, or `amp.decorate(...,
  use_dynamic_loss_scaling=True)`),
- checkpoint integrity (io.py): per-shard CRC32 verified on load, a
  structured `CheckpointError` hierarchy (`errors`), and
  contrib.Trainer falling back to the newest *valid* serial,
- `watchdog`: `Deadline` (SIGALRM guard around a step),
  `DispatchWatchdog` (first-step grace vs hung-step budget),
  `probe_backend` (subprocess CUDA init probe), `retry_call` (bounded
  exponential backoff),
- `preempt`: preemption tolerance — `SnapshotWriter` (async checkpoint
  writes: blocking device→host snapshot, background CRC+manifest-last
  write, failures surfaced as structured `CheckpointWriteError`s) and
  the SIGTERM/SIGINT drain controller contrib.Trainer uses to finish
  the in-flight step, write an emergency checkpoint, and exit with
  `PREEMPT_EXIT_CODE`,
- `chaos`: deterministic in-process fault injectors (failpoints,
  delaypoints, NaN batches, shard corruption, torn checkpoints, the
  host-side `hang`, the `FlakyPredictor` executor proxy and the serving
  replica injectors `kill_replica`/`delay_replica`) that the tests and
  `chip_smoke.py` use to prove the above.

Not ported yet, under ROADMAP queue A step 11: `health`, `supervisor`,
`autopilot` and the chaos rank injectors (`kill_rank`, `hang_rank`,
`FakeKv`).
"""

from . import chaos  # noqa: F401
from . import preempt  # noqa: F401
from . import watchdog  # noqa: F401
from .chaos import (ChaosKilled, FlakyPredictor,  # noqa: F401
                    InjectedExecutorError, corrupt_file, corrupt_shard,
                    delay_replica, hang, kill_replica, nan_reader,
                    poison_feed, tear_checkpoint)
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
from .preempt import (PREEMPT_EXIT_CODE, PendingSave,  # noqa: F401
                      SnapshotWriter, clear_drain, drain_requested,
                      install_preempt_handler, request_drain,
                      uninstall_preempt_handler)
from .watchdog import (Deadline, DispatchWatchdog,  # noqa: F401
                       backoff_schedule, probe_backend, retry_call)
