"""paddle_tpu_torch.resilience — fault tolerance for training: the port
of paddle_tpu/resilience, for one training process on one card and for
a gang of them.

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
- `health`: the distributed health plane — per-rank heartbeats on the
  `torch.distributed.TCPStore` `parallel.init_distributed` opens, a
  monitor raising structured `PeerLostError`/`PeerStalledError` within
  a configured miss budget, the gang **poison key** every rank (and
  `io._barrier`) checks so one failure becomes a bounded-time gang-wide
  abort, and per-rank step-rate skew telemetry (`gang_skew`/`rank_slow`
  events),
- `supervisor`: the self-healing gang supervisor — spawns N worker
  processes, translates the exit-code registry (77 preempt-drain /
  43 peer-lost), kills the remainder of a broken gang within a grace
  period, and relaunches with a restart budget + deterministic backoff,
  resuming from the newest valid checkpoint (`python -m
  paddle_tpu_torch.resilience.supervisor` is the command line),
- `autopilot`: the divergence autopilot — `RecoveryController` drives
  contrib.Trainer through a bounded escalation ladder (absorb via the
  guard → in-process rollback to the newest verified-good checkpoint →
  quarantine of the poisoned data window → structured
  `TrainingDivergedError` halt with a FlightRecorder bundle once the
  rollback budget is spent),
- `chaos`: deterministic fault injectors (failpoints, delaypoints, NaN
  batches, shard corruption, torn checkpoints, the host-side `hang`,
  the `FlakyPredictor` executor proxy, the serving replica injectors
  `kill_replica`/`delay_replica`, the env-armed gang rank injectors
  `kill_rank`/`hang_rank`, and `FakeKv`, the store stand-in) that the
  tests and `chip_smoke.py` use to prove the above.
"""

from . import autopilot  # noqa: F401
from . import chaos  # noqa: F401
from . import health  # noqa: F401
from . import preempt  # noqa: F401
from . import supervisor  # noqa: F401
from . import watchdog  # noqa: F401
from .autopilot import (AutopilotConfig,  # noqa: F401
                        RecoveryController)
from .chaos import (ChaosKilled, FakeKv, FlakyPredictor,  # noqa: F401
                    InjectedExecutorError, corrupt_file, corrupt_shard,
                    delay_replica, hang, hang_rank, kill_rank,
                    kill_replica, nan_reader, poison_feed,
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
from .health import (PEER_LOST_EXIT_CODE, HealthConfig,  # noqa: F401
                     HealthPlane, get_health_plane, poison_gang,
                     start_health_plane, stop_health_plane)
from .preempt import (PREEMPT_EXIT_CODE, PendingSave,  # noqa: F401
                      SnapshotWriter, clear_drain, drain_requested,
                      install_preempt_handler, request_drain,
                      uninstall_preempt_handler)
from .supervisor import (GangResult, Supervisor,  # noqa: F401
                         classify_exit, launch_gang)
from .watchdog import (Deadline, DispatchWatchdog,  # noqa: F401
                       backoff_schedule, probe_backend, retry_call)
