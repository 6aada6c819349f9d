"""Structured error hierarchy for the resilience subsystem: a copy of
paddle_tpu/resilience/errors.py (it imports nothing of jax), so both
packages raise the same types with the same `kind` and `details`.

Every failure the subsystem handles — a corrupt checkpoint shard, a
torn save, a hung compile, exhausted retries — surfaces as a typed
exception carrying a machine-readable `details` dict (`as_dict()`),
mirroring the serving-side `ServingError` contract: a recovery layer
(Trainer fallback, CI chaos smoke, an alerting dashboard) dispatches
on `kind`, never by parsing message strings.
"""

from __future__ import annotations

from typing import Any, Dict


class ResilienceError(RuntimeError):
    """Base for structured resilience failures."""

    kind = "resilience_error"

    def __init__(self, message: str, **details: Any):
        super().__init__(message)
        self.details = details

    def as_dict(self) -> Dict[str, Any]:
        out = {"error": self.kind, "message": str(self)}
        out.update(self.details)
        return out


# ---------------------------------------------------------------------------
# Checkpoint integrity (io.py save_sharded/load_sharded, contrib.Trainer)
# ---------------------------------------------------------------------------

class CheckpointError(ResilienceError):
    """Base for checkpoint load/save failures.  `details` always carries
    the checkpoint `dirname`; Trainer attaches the `serial` it was
    attempting so a `ckpt_fallback` event names what it skipped."""

    kind = "checkpoint_error"


class CheckpointNotFoundError(CheckpointError):
    """No manifest at the expected path: the directory is not a
    (complete) checkpoint.  A save that died between shard write and
    manifest write lands here — the manifest is written LAST, so a torn
    checkpoint is indistinguishable from no checkpoint (by design)."""

    kind = "checkpoint_not_found"


class CheckpointCorruptError(CheckpointError):
    """The checkpoint exists but its content fails verification: a
    shard CRC32 mismatch, an unreadable/truncated shard container, a
    manifest or trainer-state file that is not valid JSON."""

    kind = "checkpoint_corrupt"


class CheckpointIncompleteError(CheckpointError):
    """The manifest references shard files/keys that are missing, or
    the present shards do not cover a requested slice."""

    kind = "checkpoint_incomplete"


class CheckpointFormatError(CheckpointError):
    """The checkpoint was written by an incompatible (newer) program
    format version."""

    kind = "checkpoint_format"


class CheckpointWriteError(CheckpointError):
    """An asynchronous checkpoint write failed in the background writer
    thread.  Raised on the NEXT save/close/wait — never swallowed: a
    training run whose checkpoints silently stopped landing has no
    recovery story the day it is preempted.  `details` carries the
    original error and the dirname of the save that failed."""

    kind = "checkpoint_write_failed"


class CheckpointBarrierTimeoutError(CheckpointError):
    """A cross-process checkpoint barrier did not complete within its
    timeout — some peer died (or wedged) inside a sharded save.
    `details` names the barrier `tag`, the `timeout_s`, and
    `missing_ranks`: the process indices that never arrived (empty when
    the runtime cannot attribute ranks — see io._barrier fallback)."""

    kind = "checkpoint_barrier_timeout"


class CheckpointBarrierPoisonedError(CheckpointBarrierTimeoutError):
    """A checkpoint barrier aborted EARLY because the gang's poison key
    was set — some peer (or its health monitor) already declared the
    gang broken, so waiting out the full barrier timeout would only
    delay the restart.  `details` carries everything the parent class
    does plus `poison`: the structured poison payload (origin rank,
    reason, kind) and `elapsed_s`, the bounded time actually spent."""

    kind = "checkpoint_barrier_poisoned"


class CheckpointStateMismatchError(CheckpointError):
    """The checkpoint's recorded build state (generated-name counters,
    train_state schema) does not match the resuming process's build —
    loading would silently bind saved arrays to the WRONG variables.
    Raised loudly instead; `details` names the first divergence.  The
    classic cause: the resuming program was built outside
    `unique_name.guard()`."""

    kind = "checkpoint_state_mismatch"


# ---------------------------------------------------------------------------
# Preemption (resilience/preempt.py, contrib.Trainer drain path)
# ---------------------------------------------------------------------------

class TrainingPreempted(ResilienceError):
    """The training loop drained after a preemption signal (SIGTERM/
    SIGINT, or an injected `request_drain`): the in-flight step
    finished, an emergency checkpoint was written, and the run must now
    exit with `exit_code` (resilience.preempt.PREEMPT_EXIT_CODE) so the
    scheduler can tell a drained exit from a crash.  `details` carries
    the drain reason and the emergency checkpoint serial (None when no
    checkpoint_config was active)."""

    kind = "training_preempted"

    @property
    def exit_code(self) -> int:
        return int(self.details.get("exit_code", 1))


# ---------------------------------------------------------------------------
# Divergence autopilot (resilience/autopilot.py, contrib.Trainer)
# ---------------------------------------------------------------------------

class TrainingDivergedError(ResilienceError):
    """The divergence autopilot halted training deliberately: its
    rollback budget is exhausted (or no verified-good checkpoint
    existed to roll back to), so continuing would only skip updates
    forever.  `details` carries the full provenance a post-mortem
    needs without re-running anything: the `trigger` (signal name,
    skip streak / z-score, the latched first_nonfinite_op), the
    rollback count vs `budget`, every quarantined data window, and
    `flight_bundle` — the FlightRecorder bundle path when a recorder
    was attached (None otherwise)."""

    kind = "training_diverged"


# ---------------------------------------------------------------------------
# Watchdog / retry (resilience/watchdog.py)
# ---------------------------------------------------------------------------

class WatchdogTimeout(ResilienceError):
    """A deadline-guarded region (compile, dispatch, warmup) exceeded
    its wall-clock budget.  `message` has a default because the
    timer-thread Deadline fallback raises this via
    PyThreadState_SetAsyncExc, which instantiates the CLASS with no
    arguments (CPython rejects pre-built instances there)."""

    kind = "watchdog_timeout"

    def __init__(self, message: str = "watchdog deadline exceeded",
                 **details: Any):
        super().__init__(message, **details)


class StepHangError(WatchdogTimeout):
    """The dispatch watchdog's verdict on a timed-out training step:
    a `step_hang` event was emitted first, then this.  `details.kind`
    distinguishes `first_compile` (no dispatch had ever completed —
    the long compile-grace budget applied and STILL ran out) from
    `hung_step` (a previously-working step stopped returning: the
    hung-collective signature), plus the runtime_stats deltas observed
    inside the region (compiles/dispatches/retraces)."""

    kind = "step_hang"


class RetriesExhaustedError(ResilienceError):
    """A retried operation failed on every attempt; `details` carries
    the attempt count and the final error."""

    kind = "retries_exhausted"


# ---------------------------------------------------------------------------
# Gang fault tolerance (resilience/health.py, resilience/supervisor.py)
# ---------------------------------------------------------------------------

class GangError(ResilienceError):
    """Base for distributed-gang failures: a peer died or wedged, the
    gang was poisoned, or the supervisor exhausted its restart budget.
    Workers translate any GangError into PEER_LOST_EXIT_CODE so the
    supervisor can tell a coordinated abort from a plain crash."""

    kind = "gang_error"


class PeerLostError(GangError):
    """A peer rank stopped heartbeating (process death, SIGKILL, host
    loss) — or the KV store itself became unreachable, which on this
    runtime means the coordinator process (rank 0) died.  `details`
    carries `missing_ranks`, the staleness `age_s` at detection, and
    the configured `budget_s` window."""

    kind = "peer_lost"


class PeerStalledError(GangError):
    """A peer is still heartbeating (process alive) but its step
    counter has not advanced within the stall timeout — the
    hung-inside-a-collective signature.  `details` names the
    `stalled_ranks`, their last `step`, and the `stall_timeout_s`."""

    kind = "peer_stalled"


class GangPoisonedError(GangError):
    """This rank read the gang poison key: some OTHER rank (or its
    health monitor / dispatch watchdog) declared the gang broken.
    Every rank checking the key between steps is what turns one
    failure into a bounded-time gang-wide abort instead of a hang in
    the next all-reduce.  `details.poison` is the origin's payload
    (origin rank, reason, kind, missing_ranks)."""

    kind = "gang_poisoned"


class GangFailedError(GangError):
    """The supervisor exhausted its restart budget: every attempt's
    per-rank exit codes (and their classification) are in
    `details.attempts` — the post-mortem artifact."""

    kind = "gang_failed"
