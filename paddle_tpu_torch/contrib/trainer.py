"""High-level Trainer / Inferencer with checkpoint-based recovery: the
port of paddle_tpu/contrib/trainer.py (reference: python/paddle/fluid/
contrib/trainer.py — Trainer:100 event loop over epochs with
BeginEpoch/BeginStep/EndStep/EndEpoch events, CheckpointConfig:100
epoch/step cadence, _save_checkpoint/_load_checkpoint recovery at
:580/:1047; Inferencer).

Recovery = periodic checkpoints + restart-and-resume.  The Trainer
checkpoints persistables plus its own (epoch, step) cursor and the
non-array training state at the configured cadence, and a restarted
Trainer resumes from the newest valid checkpoint automatically; with
async saves the step loop waits only for the snapshot, a SIGTERM drains
to an emergency checkpoint (`preempt_drain=True`), a wedged host-side
step raises `StepHangError` (`step_deadline_s`), and every second of
`train()` lands in one category of a `GoodputLedger`.  The semantics are
the reference's, line for line; the port's differences:

- **The RNG state** is the executor's run counter, a Python int
  (`core/executor.py` RNG_STATE_VAR), where the reference holds a
  threefry key (uint32 words).  A port checkpoint stores the counter
  as `{"kind": "run_counter", "dtype": "int64", "data": n}` and
  resumes it exactly.  A reference checkpoint's key cannot continue the
  port's stream (ROADMAP C2); the rule: the counter becomes the key's
  uint32 words read as one unsigned big-endian integer
  (`rng_counter_from_state`), so the same checkpoint always resumes to
  the same counter and two different keys to two different streams.
  The key array itself never reaches the counter's `run + 1`.  A port
  checkpoint is not meant to resume in the reference: its run counter
  is no threefry key.
- **Device tensors in host code**: the training state is captured on
  the training thread through `.cpu()` (each save synchronises
  anyway); a restored telemetry accumulator is rebuilt with
  `init_telemetry_for(program, device=)` on the trainer's device.  The
  async writer thread writes numpy copies and JSON only — it touches no
  tensor.
- **Metrics and alerts**: `metrics_registry()` (telemetry, goodput,
  checkpoint gauges, the recovery family, and the gang's heartbeat skew
  when a health plane runs), `start_metrics_server()` and
  `enable_alerts()` (observe.trainer_rule_pack; with `flight_dir`, a
  FlightRecorder that also bundles on the step watchdog's hang
  verdict).  All host-side.
- **Data parallel**: `mesh=` compiles the train program over a
  parallel.Mesh with `build_strategy=` (ROADMAP A step 10a); a resume
  loads the sharded checkpoint onto that mesh.  On a mesh rank 0 alone
  clears a torn checkpoint directory, marks a save complete and
  rotates; every rank writes its shards.  Without a mesh each process
  keeps a checkpoint of its own (`prepare_sharded_save(
  process_local=True)`): the ranks of a gang that each train their own
  model save and resume independently.
- **The gang health plane** (resilience/health.py, started by
  `parallel.init_distributed`): between steps the loop bumps the
  plane's heartbeat counter and raises its alarm or an unconsumed
  poison (in the `barrier_wait` category); `goodput()` reports the
  heartbeat skew; a step watchdog's hang verdict poisons the gang after
  the flight recorder's capture.
- **The divergence autopilot** (`autopilot=`, resilience/autopilot.py):
  rollback to the newest verified-good serial in process, quarantine
  of the poisoned data window, halt with TrainingDivergedError.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import io as fluid_io
from ..core import unique_name
from ..core.executor import RNG_STATE_VAR, Executor, Scope, scope_guard
from ..core.program import Program, program_guard
from ..observe.goodput import GoodputLedger
from ..observe.metrics import TELEMETRY_VAR, init_telemetry_for
from ..resilience import preempt
from ..resilience.errors import (CheckpointCorruptError, CheckpointError,
                                 CheckpointFormatError,
                                 CheckpointNotFoundError,
                                 CheckpointStateMismatchError,
                                 TrainingPreempted)

# versioned schema of the `train_state` payload inside
# __trainer_state__.json, the reference's (v1: rng_key, telemetry
# (loss-scale/guard counters), data_cursor, unique_name_ids, optional
# reader_state).  A NEWER version on disk is rejected loudly
# (CheckpointFormatError); older/absent payloads load with whatever
# they carry.
TRAIN_STATE_VERSION = 1

# the `kind` of a port checkpoint's rng_key entry (module docstring)
RNG_RUN_COUNTER = "run_counter"


def rng_counter_from_state(rng: dict) -> int:
    """The executor run counter a checkpoint's `rng_key` entry resumes
    to: a port checkpoint's counter exactly; a reference checkpoint's
    threefry key as its uint32 words read as one unsigned big-endian
    integer (the module docstring's rule)."""
    if rng.get("kind") == RNG_RUN_COUNTER:
        return int(rng["data"])
    counter = 0
    for word in np.asarray(rng["data"], dtype=np.int64).reshape(-1):
        counter = (counter << 32) | (int(word) & 0xFFFFFFFF)
    return counter


def _host_value(t: torch.Tensor):
    """A 0-dim tensor as a Python scalar, a vector as a list."""
    a = t.detach().cpu().numpy()
    return a.item() if a.ndim == 0 else a.tolist()


def _like(value, tmpl: torch.Tensor) -> Optional[torch.Tensor]:
    """A saved telemetry value in the dtype, shape and device of this
    build's template field; None when the shape drifted.  int32 fields
    take their low 32 bits, so the reference's uint32 numerics words
    become the port's int32 ones bit for bit."""
    if tmpl.dtype == torch.int32:
        arr = np.asarray(value, dtype=np.int64).astype(np.uint32) \
            .view(np.int32)
    else:
        arr = np.asarray(value, dtype=np.float64)
    if tuple(arr.shape) != tuple(tmpl.shape):
        return None
    return torch.as_tensor(arr).to(device=tmpl.device, dtype=tmpl.dtype)


class _RollbackSignal(Exception):
    """Internal control flow: unwind the epoch loop to the restored
    cursor after an autopilot rollback (never escapes train())."""

    def __init__(self, epoch: int, step: int):
        super().__init__(f"rollback to epoch {epoch} step {step}")
        self.epoch = epoch
        self.step = step


class BeginEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id: int, step_id: int):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id: int, step_id: int, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    """reference contrib/trainer.py CheckpointConfig:100.

    async_save: take only the device→host snapshot on the training
    thread and run the serialization/manifest phase on a background
    SnapshotWriter (resilience.preempt) — a save then stalls the step
    loop for `snapshot_ms`, not the full write time.  Write failures
    surface as structured CheckpointWriteErrors on the next save or at
    train end, never silently."""

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 max_num_checkpoints: int = 3,
                 epoch_interval: int = 1, step_interval: int = 10,
                 async_save: bool = False):
        self.checkpoint_dir = checkpoint_dir or "checkpoints"
        self.max_num_checkpoints = max(1, int(max_num_checkpoints))
        self.epoch_interval = max(1, int(epoch_interval))
        self.step_interval = max(1, int(step_interval))
        self.async_save = bool(async_save)


class Trainer:
    """Event-driven training loop with checkpoint/resume.

        def train_func():
            loss = build_network()
            return loss                      # or [loss, metric, ...]

        trainer = Trainer(train_func=train_func,
                          optimizer_func=lambda: fluid.optimizer.SGD(0.1),
                          checkpoint_config=CheckpointConfig("ckpts"))
        trainer.train(num_epochs=3, event_handler=handler,
                      reader=batch_dict_reader, feed_order=[...])

    place: CUDAPlace(id) or CPUPlace(); None means CUDAPlace(0), as for
    the Executor (raising when CUDA is not available).
    """

    def __init__(self, train_func: Callable, optimizer_func: Callable,
                 place=None, checkpoint_config: Optional[CheckpointConfig]
                 = None, scope: Optional[Scope] = None, telemetry=None,
                 step_deadline_s: Optional[float] = None,
                 preempt_drain: bool = False, mesh=None,
                 build_strategy=None, autopilot=None,
                 validate_feed: bool = False):
        """telemetry: an observe.TelemetryConfig — enables the
        device-side StepTelemetry accumulator on the train program and
        publishes a window (telemetry means + compile/dispatch runtime
        stats) every `interval` steps, to the configured JSONL event
        log when one is given.  The accumulator lives on the device;
        the only added host traffic is ONE fetch per window.

        step_deadline_s: wall-clock watchdog around each training step
        (resilience.DispatchWatchdog) — a hung step raises a structured
        StepHangError instead of stalling forever, after emitting a
        `step_hang` event.  The FIRST step (no completed dispatch yet:
        the CUDA kernels may still build) gets the longer compile-grace
        budget; steady-state steps get step_deadline_s.  Best-effort on
        a card: see resilience/watchdog.py.

        preempt_drain: install the SIGTERM/SIGINT drain handler at
        train() start (resilience.preempt; main-thread-only, degrades
        to a no-op elsewhere).  On a signal the in-flight step
        finishes, any in-flight async save is awaited, an EMERGENCY
        checkpoint is written, `preempt_drain`/`ckpt_emergency` events
        are emitted, and train() raises TrainingPreempted carrying
        PREEMPT_EXIT_CODE.  The drain-flag check itself always runs —
        tests can call resilience.preempt.request_drain() directly.

        validate_feed: host-side admission check on every batch
        (data.pipeline.validate_feed_batch) BEFORE it reaches the
        device — a non-finite or signature-drifted batch is dropped
        with a `feed_quarantined` event + counter (feed_stats).

        mesh: a parallel.Mesh (parallel.make_mesh) — the train program is
        compiled over it (CompiledProgram.with_data_parallel; each rank
        runs its slice of every batch, see parallel/data_parallel.py)
        and a resume loads the sharded checkpoint onto it.
        build_strategy: a parallel.BuildStrategy for that compile
        (grad_sync, Reduce/ZeRO, accumulation); without a mesh it is
        ignored, as in the reference.

        autopilot: a resilience.AutopilotConfig (or True for defaults)
        — the divergence autopilot: on a guard-skip streak or
        loss/grad-norm z-trip the trainer rolls back IN PROCESS to the
        newest verified-good checkpoint, quarantines the poisoned data
        window on replay, and — once the rollback budget is spent —
        halts with a structured TrainingDivergedError plus a
        flight-recorder bundle.  Requires telemetry= (the trigger
        signals ride the telemetry windows) and checkpoint_config=
        (rollback needs serials); the update guard
        (resilience.enable_update_guard) supplies the skip-streak
        signal.  Pure host: the step launches the same kernels with the
        autopilot on or off."""
        self.checkpoint_cfg = checkpoint_config
        self.telemetry_cfg = telemetry
        self.step_deadline_s = step_deadline_s
        self.preempt_drain = bool(preempt_drain)
        self.scope = scope or Scope()
        self.startup_program = Program()
        self.train_program = Program()
        self.place = place
        # fresh unique_name counters so generated var names (optimizer
        # lr/accumulators, tmp params) are deterministic across process
        # restarts — required for checkpoint resume
        with unique_name.guard(), \
                program_guard(self.train_program, self.startup_program):
            outs = train_func()
            if isinstance(outs, (list, tuple)):
                self.train_outputs = list(outs)
            else:
                self.train_outputs = [outs]
            optimizer = optimizer_func()
            optimizer.minimize(self.train_outputs[0])
            # generated-name counters at the end of the build: saved in
            # every checkpoint's train_state and compared at resume — a
            # build whose counters drifted would silently bind saved
            # arrays to the wrong variables; the comparison makes it loud
            self._uname_ids = dict(unique_name.generator.ids)
        self.mesh = mesh
        if mesh is not None:
            # data-parallel training: every exe.run of the train program
            # routes through the compiled program (Executor.run consults
            # _compiled_wrapper); a resume loads onto its mesh
            from ..parallel.compiler import CompiledProgram

            CompiledProgram(self.train_program).with_data_parallel(
                loss_name=self.train_outputs[0].name,
                build_strategy=build_strategy, mesh=mesh)
        self._ckpt_writer = None       # lazy SnapshotWriter (async_save)
        self._pending_save = None      # in-flight resilience.PendingSave
        self._step_watchdog = None     # DispatchWatchdog (step_deadline_s)
        self._gang_steps = 0           # heartbeat step counter (beat())
        self.autopilot = None          # the divergence autopilot
        self._in_recovery = False      # between rollback and re-entry
        if autopilot:
            from ..resilience.autopilot import (AutopilotConfig,
                                                RecoveryController)

            if telemetry is None:
                raise ValueError(
                    "autopilot= requires telemetry= — the recovery "
                    "controller consumes the periodic telemetry "
                    "windows (observe.TelemetryConfig)")
            if checkpoint_config is None:
                raise ValueError(
                    "autopilot= requires checkpoint_config= — "
                    "rollback needs verified-good serials to restore")
            cfg = (autopilot if isinstance(autopilot, AutopilotConfig)
                   else AutopilotConfig())
            self.autopilot = RecoveryController(cfg)
        self._metrics_registry = None
        self._metrics_server = None
        self.alert_engine = None       # opt-in (enable_alerts)
        self.flight_recorder = None
        self._active_reader = None
        self._resume_reader_state = None
        # every second of train() wall clock lands in exactly one ledger
        # category — pure host bookkeeping, no launch and no sync
        self.goodput_ledger = GoodputLedger()
        # blocking_ms/write_ms are READS of the goodput ledger's
        # checkpoint category / ckpt_write background channel
        self.ckpt_stats = {"saves": 0, "blocking_ms": 0.0,
                           "write_ms": 0.0, "bytes": 0}
        self.validate_feed = bool(validate_feed)
        self.feed_stats = {"quarantined": 0}
        self._feed_signature = None
        self._window_dirty = False   # last published window poisoned?
        self.last_telemetry = None   # newest StepTelemetry window
        self._event_log = None
        if self.telemetry_cfg is not None:
            from .. import observe

            observe.enable_telemetry(self.train_program)
            if getattr(self.telemetry_cfg, "numerics", False):
                observe.enable_numerics(self.train_program)
            self._event_log = self.telemetry_cfg.event_log
            if self._event_log is None and self.telemetry_cfg.log_path:
                self._event_log = observe.RunEventLog(
                    self.telemetry_cfg.log_path,
                    meta={"source": "contrib.Trainer"},
                    max_bytes=getattr(self.telemetry_cfg,
                                      "max_log_bytes", None))
        self.exe = Executor(place)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
        # resume point restored from the newest checkpoint: the epoch to
        # continue in, plus how many of its batches were already consumed
        self._resume_epoch = 0
        self._resume_step_in_epoch = 0
        if self.checkpoint_cfg:
            self._try_resume()

    # -- checkpointing ---------------------------------------------------
    def _ckpt_root(self) -> str:
        return self.checkpoint_cfg.checkpoint_dir

    def _list_checkpoints(self) -> List[int]:
        root = self._ckpt_root()
        if not os.path.isdir(root):
            return []
        ids = []
        for d in os.listdir(root):
            if d.startswith("ckpt_") and os.path.exists(
                    os.path.join(root, d, "__trainer_state__.json")):
                try:
                    ids.append(int(d.split("_")[1]))
                except ValueError:
                    continue
        return sorted(ids)

    def _emit(self, kind: str, **fields):
        """Checkpoint/resume lifecycle events go to the event log when
        one is configured AND to stderr — a resume that silently
        skipped a corrupt checkpoint is an incident nobody can debug."""
        if self._event_log:
            self._event_log.event(kind, **fields)
        print(f"Trainer {kind}: "
              + " ".join(f"{k}={v}" for k, v in fields.items()),
              file=sys.stderr)

    # -- full-state capture (bit-exact resume) ---------------------------
    def _capture_train_state(self, epoch: int, step: int) -> dict:
        """Everything a bit-exact resume needs BEYOND the persistable
        arrays: the RNG run counter (dropout), the telemetry accumulator
        (dynamic loss-scale value + good/bad counters, guard skip
        counter), the data cursor, optional reader state, and the
        generated-name counters of the build (drift detector).  Runs on
        the training thread: the telemetry fields come to the host
        here, never on the writer thread."""
        st = {
            "version": TRAIN_STATE_VERSION,
            "data_cursor": {"epoch": epoch, "step_in_epoch": step},
            "unique_name_ids": dict(self._uname_ids),
        }
        rng = self.scope.find_var(RNG_STATE_VAR)
        if rng is not None:
            st["rng_key"] = {"kind": RNG_RUN_COUNTER, "dtype": "int64",
                             "data": int(rng)}
        tel = self.scope.find_var(TELEMETRY_VAR)
        if tel is not None:
            st["telemetry"] = {k: _host_value(v) for k, v in tel.items()}
        reader = self._active_reader
        if reader is not None and hasattr(reader, "state_dict"):
            st["reader_state"] = reader.state_dict()
        return st

    def _validate_train_state(self, st: dict) -> None:
        """Version + build-identity gate, BEFORE any array loads."""
        version = int(st.get("version", 0))
        if version > TRAIN_STATE_VERSION:
            raise CheckpointFormatError(
                f"checkpoint train_state version {version} is newer "
                f"than this build reads (<= {TRAIN_STATE_VERSION})",
                version=version, supported=TRAIN_STATE_VERSION)
        saved = st.get("unique_name_ids")
        if saved is not None and dict(saved) != dict(self._uname_ids):
            drift = sorted(
                k for k in set(saved) | set(self._uname_ids)
                if saved.get(k) != self._uname_ids.get(k))
            raise CheckpointStateMismatchError(
                "generated-name counters of this build do not match "
                "the checkpoint's — the training program was built "
                "with different unique_name state (was it built "
                "outside unique_name.guard()?).  Loading would bind "
                f"saved arrays to the wrong variables.  Drifted keys: "
                f"{drift[:8]}", drifted_keys=drift[:32],
                saved_count=len(saved), built_count=len(self._uname_ids))

    def _restore_train_state(self, st: dict) -> None:
        """Write the captured non-array state back into the scope (the
        arrays were already loaded): the run counter by
        `rng_counter_from_state`, the telemetry accumulator rebuilt on
        the trainer's device from this build's template."""
        rng = st.get("rng_key")
        if rng is not None:
            self.scope.set_var(RNG_STATE_VAR, rng_counter_from_state(rng))
        tel = st.get("telemetry")
        if tel is not None:
            # dtype/shape template per field (init_telemetry_for sizes
            # the numerics vectors for THIS build's program); fields
            # the checkpoint lacks — or whose shape drifted with the
            # program — stay zeroed
            fresh = init_telemetry_for(self.train_program,
                                       device=self.exe.device)
            for k, v in tel.items():
                if k in fresh:
                    value = _like(v, fresh[k])
                    if value is not None:
                        fresh[k] = value
            self.scope.set_var(TELEMETRY_VAR, fresh)
        self._resume_reader_state = st.get("reader_state")

    # -- save ------------------------------------------------------------
    def _save_checkpoint(self, serial: int, epoch: int, step: int,
                         emergency: bool = False,
                         force_sync: bool = False):
        root = self._ckpt_root()
        path = os.path.join(root, f"ckpt_{serial}")
        led = self.goodput_ledger
        use_async = (self.checkpoint_cfg.async_save and not force_sync)
        # the whole blocking portion of a save — snapshot, any
        # wait-for-previous, and (sync path) the write itself — is one
        # ledger "checkpoint" phase; blocking_ms below READS it back
        with led.phase("checkpoint", label=f"save:{serial}"):
            if use_async:
                # surface a PREVIOUS background write's failure before
                # starting a new save (async errors are deferred, not
                # lost)
                self._writer().check()
                # bounded queue: a save requested while one is in
                # flight waits for it — two saves never interleave
                # their files
                self._await_pending(surface=True)
            # without a mesh this process's checkpoint is its own: it acts
            # as the one process of its save
            rank, ranks = (fluid_io._process() if self.mesh is not None
                           else (0, 1))
            if rank == 0 and os.path.isdir(path) and not os.path.exists(
                    os.path.join(path, "__trainer_state__.json")):
                # leftover of a save that died mid-write (torn): clear
                # it so stale shard files cannot mix with the fresh save
                # (rank 0 alone: on a mesh every rank writes here)
                shutil.rmtree(path, ignore_errors=True)
            if rank == 0:
                os.makedirs(path, exist_ok=True)
            if ranks > 1:
                # every rank writes its shards into the directory rank 0
                # cleared and made
                fluid_io._barrier("trainer:ckpt_dir")
                os.makedirs(path, exist_ok=True)
            # verified-good marking (the _rotate pin): computed on the
            # training thread at snapshot time, so the verdict
            # describes exactly the state being saved
            verified = self._checkpoint_verified()
            trainer_state = {"epoch": epoch, "step": step,
                             "serial": serial,
                             "verified_good": verified,
                             "train_state":
                             self._capture_train_state(epoch, step)}
            with scope_guard(self.scope):
                job = fluid_io.prepare_sharded_save(
                    self.exe, path, main_program=self.train_program,
                    process_local=self.mesh is None)

            def _finalize():
                # ordering: shards → manifest (io.py, written LAST
                # there) → trainer state.  The trainer-state file marks
                # the serial visible to _list_checkpoints, so a death
                # anywhere earlier leaves a torn — never a
                # half-resumable — directory.  Host data only: on the
                # async path this runs on the writer thread.
                if rank == 0:
                    # on a mesh rank 0 alone marks the serial and rotates
                    # (job.write's barriers saw every rank's shards)
                    tmp = os.path.join(path, "__trainer_state__.json.tmp")
                    with open(tmp, "w") as f:
                        json.dump(trainer_state, f)
                    os.replace(tmp,
                               os.path.join(path, "__trainer_state__.json"))
                    if self.autopilot is not None:
                        # the serial becomes a rollback anchor only after
                        # its state file landed — never before
                        self.autopilot.note_checkpoint(serial, epoch, step,
                                                       verified)
                    self._rotate()
                led.note_background("ckpt_write",
                                    (job.write_ms or 0.0) / 1000.0)
                self.ckpt_stats["saves"] += 1
                self.ckpt_stats["write_ms"] = round(
                    led.background_ms("ckpt_write"), 3)
                self.ckpt_stats["bytes"] = job.bytes_total
                self._emit("ckpt_save", serial=serial, epoch=epoch,
                           step=step,
                           snapshot_ms=round(job.snapshot_ms, 3),
                           write_ms=round(job.write_ms or 0.0, 3),
                           bytes=job.bytes_total, asynchronous=use_async,
                           emergency=emergency)

            if use_async:
                self._pending_save = self._writer().submit(
                    job, finalize=_finalize)
            else:
                job.write()
                _finalize()
        # blocking cost = everything inside the phase above, i.e.
        # exactly the time the step loop lost to saves so far
        self.ckpt_stats["blocking_ms"] = round(
            led.category_ms("checkpoint"), 3)

    def _writer(self):
        if self._ckpt_writer is None:
            self._ckpt_writer = preempt.SnapshotWriter()
        return self._ckpt_writer

    def _await_pending(self, surface: bool, timeout: float = 600.0):
        """Wait out an in-flight async save.  surface=True re-raises a
        write failure (the per-save contract); surface=False logs it
        as a loud ckpt_async_error and continues — the drain path must
        still write its emergency checkpoint after a failed save."""
        pending, self._pending_save = self._pending_save, None
        if pending is None and self._ckpt_writer is None:
            return
        try:
            if pending is not None:
                pending.result(timeout)
            if self._ckpt_writer is not None:
                self._ckpt_writer.wait_idle(timeout)
        except (CheckpointError, TimeoutError) as e:
            fields = (e.as_dict() if isinstance(e, CheckpointError)
                      else {"error": "timeout", "message": str(e)})
            self._emit("ckpt_async_error", error=fields)
            if surface:
                raise

    def _checkpoint_verified(self) -> bool:
        """The verified-good verdict for the state being saved RIGHT
        NOW: the trailing telemetry window is clean — the accumulator's
        current (since-last-fetch) nonfinite/skip counters are zero and
        the last PUBLISHED window was clean (the accumulator resets at
        each fetch), and the autopilot (when attached) holds no
        unresolved anomaly.  A trainer without telemetry marks every
        save verified: it has no evidence of poison."""
        if self._window_dirty:
            return False
        if self.autopilot is not None and not self.autopilot.healthy:
            return False
        tel = self.scope.find_var(TELEMETRY_VAR)
        if tel is not None:
            for k in ("nonfinite_grad_steps", "nonfinite_loss_steps",
                      "skipped_update_steps"):
                v = tel.get(k)
                if v is not None and float(v.detach().cpu()) > 0:
                    return False
        return True

    def _serial_verified(self, serial: int) -> bool:
        """Read a serial's on-disk verified-good marking (False for
        pre-marking checkpoints and unreadable state files)."""
        path = os.path.join(self._ckpt_root(), f"ckpt_{serial}",
                            "__trainer_state__.json")
        try:
            with open(path) as f:
                return bool(json.load(f).get("verified_good"))
        except (OSError, ValueError):
            return False

    def _rotate(self):
        # keep max_num_checkpoints, deleting the oldest — EXCEPT the
        # newest verified-good serial, which is pinned: blind
        # oldest-first deletion could evict the last known-good
        # checkpoint while keeping N newer poisoned ones
        root = self._ckpt_root()
        ids = self._list_checkpoints()
        verified = [s for s in ids if self._serial_verified(s)]
        pinned = verified[-1] if verified else None
        victims = [s for s in ids if s != pinned]
        while len(ids) > self.checkpoint_cfg.max_num_checkpoints \
                and victims:
            victim = victims.pop(0)
            ids.remove(victim)
            shutil.rmtree(os.path.join(root, f"ckpt_{victim}"),
                          ignore_errors=True)

    def _load_checkpoint(self, path: str) -> dict:
        """Load one checkpoint dir (trainer cursor + train_state +
        arrays) or raise a structured CheckpointError.  The trainer
        state is read and validated FIRST: a version/name-drift
        mismatch fails loudly before any array touches the scope."""
        st = self._read_trainer_state(path)
        train_state = st.get("train_state") or {}
        self._validate_train_state(train_state)
        with scope_guard(self.scope):
            if os.path.exists(os.path.join(path,
                                           fluid_io.SHARD_MANIFEST)):
                # onto the mesh the program was compiled over, when it was
                wrapper = getattr(self.train_program,
                                  "_compiled_wrapper", None)
                fluid_io.load_sharded(
                    self.exe, path, main_program=self.train_program,
                    mesh=wrapper._mesh if wrapper is not None else None)
            else:
                # checkpoint from the pre-sharded combined format
                fluid_io.load_persistables(self.exe, path,
                                           main_program=self.train_program)
        self._restore_train_state(train_state)
        return st

    def _read_trainer_state(self, path: str) -> dict:
        state_path = os.path.join(path, "__trainer_state__.json")
        try:
            with open(state_path) as f:
                return json.load(f)
        except FileNotFoundError as e:
            raise CheckpointNotFoundError(
                f"checkpoint {path!r} has no trainer state (torn save)",
                dirname=path) from e
        except (json.JSONDecodeError, OSError) as e:
            raise CheckpointCorruptError(
                f"unreadable trainer state {state_path!r}: {e}",
                dirname=path, cause=f"{type(e).__name__}: {e}") from e

    def _try_resume(self):
        """Resume from the NEWEST VALID checkpoint: serials are tried
        newest-first, and a torn/corrupt/incomplete one is skipped with
        a loud `ckpt_fallback` record — never a raw numpy/JSON error,
        never a silent fresh start when an older valid serial exists."""
        ids = self._list_checkpoints()
        for serial in reversed(ids):
            path = os.path.join(self._ckpt_root(), f"ckpt_{serial}")
            try:
                st = self._load_checkpoint(path)
            except CheckpointStateMismatchError:
                # NOT a fallback case: every serial was written by the
                # same (drifted-relative-to-us) build — walking to an
                # older one would mis-bind identically.  Fail loudly.
                raise
            except CheckpointError as e:
                self._emit("ckpt_fallback", serial=serial,
                           error=e.as_dict())
                continue
            self._resume_epoch = int(st.get("epoch", 0))
            self._resume_step_in_epoch = int(st.get("step", 0))
            if serial != ids[-1] or self._event_log:
                self._emit("ckpt_resume", serial=serial,
                           epoch=self._resume_epoch,
                           step=self._resume_step_in_epoch,
                           fallback=serial != ids[-1])
            return
        if ids:
            self._emit("ckpt_resume_failed", tried=list(reversed(ids)))

    # -- the loop --------------------------------------------------------
    def train(self, num_epochs: int, event_handler: Optional[Callable]
              = None, reader: Optional[Callable] = None,
              feed_order: Optional[Sequence[str]] = None):
        """reader: callable -> iterable of feed dicts (or tuples aligned
        with feed_order) of host arrays.  Bit-exact resume additionally
        requires the reader to be DETERMINISTIC (same stream every run
        — e.g. data.decorator.shuffle(seed=...)); a reader exposing
        state_dict()/load_state_dict() gets its state checkpointed and
        restored too."""
        # the ledger window bounds this call's wall clock — every
        # second in here lands in exactly one goodput category
        self.goodput_ledger.open_window()
        try:
            return self._train_impl(num_epochs, event_handler, reader,
                                    feed_order)
        finally:
            self.goodput_ledger.close_window()

    def _train_impl(self, num_epochs: int,
                    event_handler: Optional[Callable],
                    reader: Optional[Callable],
                    feed_order: Optional[Sequence[str]]):
        from ..resilience import health as gang_health

        handler = event_handler or (lambda e: None)
        if self.preempt_drain:
            preempt.install_preempt_handler()
        # gang fault tolerance: when init_distributed registered the
        # health plane, every rank bumps its heartbeat step counter and
        # consults the LOCAL alarm/poison cache between steps (the
        # monitor thread does the store calls — nothing here touches the
        # step)
        plane = gang_health.get_health_plane()
        if plane is not None:
            if self._event_log:
                plane.attach_event_log(self._event_log)
            # the done-rendezvous outside train() (wait_gang_done) feeds
            # the same ledger, as barrier_wait
            plane.attach_ledger(self.goodput_ledger)
            plane.check()  # a poisoned gang must not start stepping
        if self.step_deadline_s and self._step_watchdog is None:
            from ..resilience.watchdog import DispatchWatchdog

            def _on_hang(fields):
                # a hang detected HERE is gang-fatal: poison so peers
                # abort their barriers/steps instead of waiting out
                # their own timeouts on this wedged rank
                if plane is not None:
                    plane.poison(
                        f"step hang on rank {plane.rank}: "
                        f"{fields.get('what')}", kind="step_hang",
                        hang=fields)

            on_hang = _on_hang
            if self.flight_recorder is not None:
                # capture the diagnostic bundle BEFORE the gang poison:
                # the abort path may end the process
                on_hang = self.flight_recorder.watchdog_hook(_on_hang)
            self._step_watchdog = DispatchWatchdog(
                self.step_deadline_s, event_log=self._event_log,
                on_hang=on_hang)
        if self.flight_recorder is not None:
            self.flight_recorder.watchdog = self._step_watchdog
        self._active_reader = reader
        if (self._resume_reader_state is not None and reader is not None
                and hasattr(reader, "load_state_dict")):
            reader.load_state_dict(self._resume_reader_state)
        serial = ((self._list_checkpoints() or [-1])[-1] + 1
                  if self.checkpoint_cfg else 0)
        fetch = [o.name for o in self.train_outputs]
        skip = self._resume_step_in_epoch  # mid-epoch fast-forward
        # restart-replay badput: the per-step progress cursor the DEAD
        # process left behind marks how far it actually got; every step
        # we execute before that point is work done twice (the resume
        # checkpoint is older than the crash), accounted as "replay"
        crash_cursor = self._read_progress()
        if (crash_cursor is not None
                and crash_cursor > (self._resume_epoch,
                                    self._resume_step_in_epoch)):
            self.goodput_ledger.note_replay(
                (self._resume_epoch, self._resume_step_in_epoch),
                crash_cursor)
        else:
            crash_cursor = None
        tel_snap = None
        if self.telemetry_cfg is not None:
            from ..observe import runtime_stats

            tel_snap = runtime_stats.snapshot()
            if self._event_log:
                self._event_log.event(
                    "train_begin", num_epochs=num_epochs,
                    resume_epoch=self._resume_epoch,
                    resume_step=self._resume_step_in_epoch)
        # the loop's cursor state, carried across a rollback's unwind
        loop = {"serial": serial, "tel_snap": tel_snap}
        epoch = self._resume_epoch
        while epoch < num_epochs:
            try:  # the rollback unwind point for the whole epoch
                self._train_epoch(epoch, skip, loop, handler, reader,
                                  feed_order, fetch, crash_cursor, plane)
            except _RollbackSignal as rb:
                # autopilot rung 2 landed: the scope now holds the
                # verified-good checkpoint — restart its epoch with the
                # fast-forward cursor (batches before rb.step were
                # trained pre-rollback and are skipped; batches in
                # [rb.step, fail) hit the quarantine check)
                epoch = rb.epoch
                skip = rb.step
                if (self._resume_reader_state is not None
                        and reader is not None
                        and hasattr(reader, "load_state_dict")):
                    reader.load_state_dict(self._resume_reader_state)
                continue
            skip = 0  # fast-forward applies to the resume epoch only
            epoch += 1
        # a background write still in flight must land (and a failed
        # one must surface) before train() returns green
        self._await_pending(surface=True)
        if self.telemetry_cfg is not None:
            # flush the partial final window so no steps go unreported
            self._publish_telemetry(num_epochs - 1, -1, loop["tel_snap"])
            if self._event_log:
                rep = self.goodput()
                self._event_log.event(
                    "train_end", num_epochs=num_epochs,
                    ckpt_saves=self.ckpt_stats["saves"],
                    # how long the step loop actually stalled vs how
                    # long writes took — both reads of the ledger
                    ckpt_blocking_ms=round(
                        self.ckpt_stats["blocking_ms"], 3),
                    ckpt_write_ms=round(
                        self.ckpt_stats["write_ms"], 3),
                    goodput=rep["goodput"],
                    replay_steps=rep["replay_steps"],
                    wall_s=rep["wall_s"])
                self._event_log.event("goodput_report", **rep)

    def _train_epoch(self, epoch, skip, loop, handler, reader, feed_order,
                     fetch, crash_cursor, plane):
        """One epoch of the loop (the reference's loop body).  `loop`
        holds the next checkpoint serial and the runtime-stats snapshot
        of the open telemetry window; it outlives a rollback's
        unwind."""
        handler(BeginEpochEvent(epoch))
        step = 0
        done = 0
        for batch in self._goodput_batches(
                iter(reader()) if reader else iter(())):
            # resume semantics: a mid-epoch checkpoint records how many
            # batches of its epoch were consumed; with a deterministic
            # reader, skipping them continues exactly where the dead
            # process stopped (already-trained batches are not replayed
            # onto updated params)
            if skip > 0:
                skip -= 1
                step += 1
                continue
            if self._quarantined(epoch, step):
                # autopilot rung 3: a batch inside a quarantined window
                # is consumed (cursor parity with the run that trained
                # on it) but never trained — the poison does not get a
                # second chance
                with self.goodput_ledger.phase("recovery",
                                               label="quarantine"):
                    step += 1
                    self.autopilot.quarantined_batches += 1
                continue
            if self._in_recovery:
                # first live batch past the quarantine: caught up —
                # reader waits are data_stall again, not recovery
                self._in_recovery = False
            if not isinstance(batch, dict):
                if feed_order is None:
                    raise ValueError("tuple batches need feed_order")
                batch = dict(zip(feed_order, batch))
            if self.validate_feed and self._reject_feed(batch, epoch,
                                                        step):
                step += 1
                continue
            begin = BeginStepEvent(epoch, step)
            handler(begin)
            if self._step_watchdog is not None:
                guard = self._step_watchdog.guard(
                    what=f"train step {epoch}/{step}")
            else:
                guard = contextlib.nullcontext()
            is_replay = (crash_cursor is not None
                         and (epoch, step) < crash_cursor)
            with scope_guard(self.scope), guard, \
                    self.goodput_ledger.phase(
                        "replay" if is_replay else "step", steps=1):
                metrics = self.exe.run(
                    self.train_program, feed=batch,
                    fetch_list=fetch if begin.fetch_metrics else [])
            handler(EndStepEvent(epoch, step, metrics))
            step += 1
            done += 1
            if self.checkpoint_cfg:
                self._write_progress(epoch, step)
            if plane is not None:
                self._gang_steps += 1
                with self.goodput_ledger.phase("barrier_wait"):
                    plane.beat(self._gang_steps)
                    plane.check()  # raises PeerLost/Stalled/Poisoned
            if (self.telemetry_cfg is not None and
                    done % self.telemetry_cfg.interval == 0):
                loop["tel_snap"] = self._publish_telemetry(
                    epoch, step, loop["tel_snap"])
                if self.autopilot is not None:
                    # may raise _RollbackSignal (rung 2) or
                    # TrainingDivergedError (rung 4)
                    self._autopilot_check(epoch, step)
            if (self.checkpoint_cfg and
                    done % self.checkpoint_cfg.step_interval == 0):
                self._save_checkpoint(loop["serial"], epoch, step)
                loop["serial"] += 1
                if self._event_log:
                    self._event_log.event("checkpoint",
                                          serial=loop["serial"] - 1,
                                          epoch=epoch, step=step)
            if preempt.drain_requested():
                # the in-flight step already finished (we are at a step
                # boundary); checkpoint and get out
                self._drain(loop["serial"], epoch, step)
        if skip > 0:
            raise RuntimeError(
                f"resume cursor expected at least {skip} more batches "
                f"in epoch {epoch} than the reader produced — the "
                f"dataset/reader changed since the checkpoint")
        if (self.checkpoint_cfg and
                (epoch + 1) % self.checkpoint_cfg.epoch_interval == 0):
            self._save_checkpoint(loop["serial"], epoch + 1, 0)
            loop["serial"] += 1
        handler(EndEpochEvent(epoch))
        if preempt.drain_requested():
            self._drain(loop["serial"], epoch + 1, 0)

    def _goodput_batches(self, it):
        """Wrap reader `next()` in the ledger's data_stall phase — the
        input pipeline's blocking time, attributed without touching the
        reader or the step.  While replaying past a rollback the same
        waits are autopilot fallout, not pipeline slowness, and land in
        the `recovery` category instead."""
        led = self.goodput_ledger
        while True:
            with led.phase("recovery" if self._in_recovery
                           else "data_stall"):
                try:
                    batch = next(it)
                except StopIteration:
                    return
            yield batch

    # -- divergence autopilot (resilience/autopilot.py) ------------------
    def _quarantined(self, epoch: int, pos: int) -> bool:
        """Is reader position (epoch, pos) inside a quarantined data
        window?  Windows are half-open [(e_r, s_r), (e_f, s_f)) in tuple
        order — the batches the diverged timeline consumed after the
        rollback anchor and before detection."""
        if self.autopilot is None:
            return False
        for w in self.autopilot.quarantine_windows:
            if ((w["from_epoch"], w["from_step"]) <= (epoch, pos)
                    < (w["to_epoch"], w["to_step"])):
                return True
        return False

    def _autopilot_check(self, epoch: int, step: int) -> None:
        """Feed the freshly published telemetry window to the
        RecoveryController; escalate when it returns a trigger."""
        ap = self.autopilot
        if ap.halted or self.last_telemetry is None:
            return
        trigger = ap.observe_window(self.last_telemetry, epoch, step)
        if trigger is None:
            return
        if ap.rollbacks >= ap.cfg.max_rollbacks:
            self._recovery_halt(trigger, epoch, step,
                                reason="rollback_budget_exhausted")
        self._rollback(trigger, epoch, step)

    def _rollback(self, trigger: dict, epoch: int, step: int) -> None:
        """Rung 2+3: restore the newest loadable verified-good serial
        in process, quarantine the data window the diverged timeline
        consumed, and unwind the epoch loop to the restored cursor."""
        ap = self.autopilot
        target = None
        with self.goodput_ledger.phase("recovery", label="rollback"):
            # a background save may still reference the live state —
            # and a save of the POISONED state must not land after the
            # restore and become the newest serial
            self._await_pending(surface=False)
            for serial, e_r, s_r in reversed(ap.verified_serials()):
                path = os.path.join(self._ckpt_root(), f"ckpt_{serial}")
                try:
                    self._load_checkpoint(path)
                except CheckpointError as e:
                    self._emit("ckpt_fallback", serial=serial,
                               error=e.as_dict())
                    ap.forget_serial(serial)
                    continue
                target = (serial, e_r, s_r)
                break
        if target is None:
            self._recovery_halt(trigger, epoch, step,
                                reason="no_verified_checkpoint")
        serial, e_r, s_r = target
        window = {"from_epoch": e_r, "from_step": s_r,
                  "to_epoch": epoch, "to_step": step}
        ap.on_rollback(window)
        self._window_dirty = False  # the restored state is clean
        self._in_recovery = True
        backoff = self._apply_lr_backoff()
        self._emit("recovery_rollback", serial=serial, trigger=trigger,
                   rollbacks=ap.rollbacks, budget=ap.cfg.max_rollbacks,
                   lr_backoff=backoff, **window)
        self._emit("data_quarantine",
                   batches=(window["to_step"] - window["from_step"]
                            if window["from_epoch"] == window["to_epoch"]
                            else None), **window)
        raise _RollbackSignal(e_r, s_r)

    def _recovery_halt(self, trigger: dict, epoch: int, step: int,
                       reason: str) -> None:
        """Rung 4: stop deliberately with full provenance (plus a
        FlightRecorder bundle when alerts are enabled with a flight
        directory) instead of guard-skipping updates forever."""
        from ..resilience.errors import TrainingDivergedError

        ap = self.autopilot
        ap.halted = True
        ap.last_trigger = dict(trigger)
        bundle = None
        if self.flight_recorder is not None:
            bundle = self.flight_recorder.record(
                "training_diverged", force=True,
                context={"trigger": trigger, "reason": reason,
                         "epoch": epoch, "step": step,
                         "rollbacks": ap.rollbacks,
                         "budget": ap.cfg.max_rollbacks,
                         "quarantine_windows": ap.quarantine_windows})
        self._emit("recovery_halt", reason=reason, epoch=epoch,
                   step=step, trigger=trigger, rollbacks=ap.rollbacks,
                   budget=ap.cfg.max_rollbacks, flight_bundle=bundle)
        raise TrainingDivergedError(
            f"training diverged at epoch {epoch} step {step} "
            f"(signal: {trigger.get('signal')}); halting: {reason} "
            f"after {ap.rollbacks}/{ap.cfg.max_rollbacks} rollbacks",
            reason=reason, trigger=trigger, epoch=epoch, step=step,
            rollbacks=ap.rollbacks, budget=ap.cfg.max_rollbacks,
            quarantine_windows=list(ap.quarantine_windows),
            first_nonfinite_op=trigger.get("first_nonfinite_op"),
            flight_bundle=bundle)

    def _apply_lr_backoff(self):
        """Optional rung-3 extra: scale every `.learning_rate` variable
        (optimizer.py names them `<op>.learning_rate`) after a restore,
        on its device in its dtype.  Off by default — the parity proof
        requires re-entry bit-identical to a run that never diverged."""
        factor = self.autopilot.cfg.lr_backoff
        if factor is None or factor == 1.0:
            return None
        scaled = []
        for name in list(self.train_program.global_block().vars):
            if not name.endswith(".learning_rate"):
                continue
            value = self.scope.find_var(name)
            if value is None:
                continue
            self.scope.set_var(name, value * torch.tensor(
                factor, dtype=value.dtype, device=value.device))
            scaled.append(name)
        return ({"factor": factor, "vars": scaled} if scaled else None)

    def _reject_feed(self, batch: dict, epoch: int, step: int) -> bool:
        """Opt-in admission check (validate_feed=True): non-finite
        values, unknown feed names, or dtype/rank drift vs the first
        accepted batch quarantine the batch BEFORE it reaches the
        device — poison stopped at the door costs one skipped batch,
        not a guard trip."""
        from ..data.pipeline import feed_signature, validate_feed_batch

        problems = validate_feed_batch(batch, self._feed_signature)
        if not problems:
            if self._feed_signature is None:
                self._feed_signature = feed_signature(batch)
            return False
        self.feed_stats["quarantined"] += 1
        if self.autopilot is not None:
            self.autopilot.note_quarantined_feed()
        self._emit("feed_quarantined", epoch=epoch, step=step,
                   quarantined_total=self.feed_stats["quarantined"],
                   problems=problems)
        return True

    # -- goodput ---------------------------------------------------------
    def _progress_path(self) -> str:
        return os.path.join(self._ckpt_root(), "__progress__.json")

    def _write_progress(self, epoch: int, step: int) -> None:
        """Atomically record how many steps actually EXECUTED (the
        crash cursor a relaunch reads to count replay badput — steps
        between the resumed checkpoint and this high-water mark run
        twice).  Accounting only: best-effort, never fails a step."""
        try:
            os.makedirs(self._ckpt_root(), exist_ok=True)
            tmp = self._progress_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"epoch": epoch, "step": step}, f)
            os.replace(tmp, self._progress_path())
        except OSError:
            pass

    def _read_progress(self):
        if not self.checkpoint_cfg:
            return None
        try:
            with open(self._progress_path()) as f:
                d = json.load(f)
            return (int(d["epoch"]), int(d["step"]))
        except (OSError, ValueError, KeyError):
            return None

    def goodput(self, mfu: Optional[float] = None):
        """The wall-clock decomposition of this trainer's train() time:
        GoodputLedger.report() — categories summing to the wall, the
        goodput fraction, replay badput, `effective_mfu` when a headline
        MFU is passed, and the heartbeat-skew straggler estimate when a
        health plane is active."""
        from ..resilience import health as gang_health

        plane = gang_health.get_health_plane()
        skew = plane.skew() if plane is not None else None
        return self.goodput_ledger.report(mfu=mfu, skew=skew)

    def _drain(self, serial: int, epoch: int, step: int):
        """Preemption drain: called at a step boundary once the drain
        flag is up.  Awaits any in-flight async save (its failure is
        logged, not fatal — the emergency save below is the one that
        must land), writes a SYNCHRONOUS emergency checkpoint, emits
        the drain events, and raises TrainingPreempted carrying the
        distinct exit code."""
        reason = preempt.drain_reason() or "requested"
        self._emit("preempt_drain", reason=reason, epoch=epoch,
                   step=step)
        em_serial = None
        if self.checkpoint_cfg:
            self._await_pending(surface=False)
            self._save_checkpoint(serial, epoch, step, emergency=True,
                                  force_sync=True)
            em_serial = serial
            self._emit("ckpt_emergency", serial=serial, epoch=epoch,
                       step=step)
        # the drain request is CONSUMED by this drain: the flag is
        # process-global, so leaving it set would instantly re-drain a
        # train() call that resumes in-process after catching
        # TrainingPreempted
        preempt.clear_drain()
        raise TrainingPreempted(
            f"training drained after preemption ({reason}) at epoch "
            f"{epoch} step {step}; emergency checkpoint serial: "
            f"{em_serial}", reason=reason, epoch=epoch, step=step,
            serial=em_serial, exit_code=preempt.PREEMPT_EXIT_CODE)

    # -- telemetry -------------------------------------------------------
    def _publish_telemetry(self, epoch: int, step: int, since):
        """Fetch the device accumulator (ONE host sync), attach the
        window's host runtime stats, and emit a `telemetry` event.
        With numerics enabled the fetch joins the latched bitmap to the
        fluid op desc, and a window that latched a poisoned step emits
        a LOUD `nonfinite_provenance` event."""
        from .. import observe

        tel = observe.fetch_telemetry(self.scope, reset=True,
                                      program=self.train_program)
        now = observe.runtime_stats.snapshot()
        if tel is None or tel.steps == 0:
            return now
        self.last_telemetry = tel
        # verified-good bookkeeping: the accumulator resets on fetch,
        # so the save path needs this window's verdict remembered
        self._window_dirty = bool(
            tel.skipped_update_steps or tel.nonfinite_grad_steps
            or tel.nonfinite_loss_steps
            or tel.first_nonfinite_op is not None)
        if self._event_log:
            delta = observe.runtime_stats.delta(since or {})
            self._event_log.telemetry_window(
                tel, epoch=epoch, step=step,
                compiles=delta["compiles"],
                compile_time_s=round(delta["compile_time_s"], 3),
                retraces=delta["retraces"],
                dispatches=delta["dispatches"],
                dispatch_time_s=round(delta["dispatch_time_s"], 4),
                peak_mem_bytes=observe.peak_memory_bytes())
            if tel.first_nonfinite_op is not None:
                wg, wr = observe.worst_update_ratio(tel.groups)
                self._event_log.event(
                    "nonfinite_provenance", epoch=epoch, step=step,
                    first_nonfinite_op=tel.first_nonfinite_op,
                    nonfinite_grad_steps=tel.nonfinite_grad_steps,
                    nonfinite_loss_steps=tel.nonfinite_loss_steps,
                    skipped_update_steps=tel.skipped_update_steps,
                    loss_scale=tel.loss_scale,
                    worst_update_ratio_group=wg,
                    worst_update_ratio=wr)
        return now

    # -- unified metrics export and alerts ------------------------
    def metrics_registry(self):
        """One MetricsRegistry over this trainer's surfaces: the
        latest telemetry window (incl. per-group numerics when pillar
        6 is on), checkpoint-cost gauges, the recovery family (the
        autopilot's snapshot), the process-wide runtime/process/memory
        collectors, and — when a health plane runs — the gang's
        heartbeat skew (the families `trainer_rule_pack`'s gang_skew
        rule reads).  Built once, cached."""
        if self._metrics_registry is None:
            from ..observe.registry import (MetricsRegistry, gang_collector,
                                            gauge, goodput_collector,
                                            recovery_collector,
                                            standard_collectors,
                                            telemetry_collector)

            reg = standard_collectors(MetricsRegistry())
            reg.register("training",
                         telemetry_collector(
                             lambda: self.last_telemetry))
            reg.register("goodput",
                         goodput_collector(lambda: self.goodput()))
            reg.register("recovery",
                         recovery_collector(
                             lambda: (self.autopilot.snapshot()
                                      if self.autopilot is not None
                                      else None)))

            def ckpt_collect():
                s = self.ckpt_stats
                return [
                    gauge("ckpt_saves_total", "checkpoints saved",
                          s["saves"]),
                    gauge("ckpt_blocking_ms",
                          "last blocking snapshot time",
                          s["blocking_ms"]),
                    gauge("ckpt_write_ms",
                          "last background write time",
                          s["write_ms"]),
                    gauge("ckpt_bytes", "last checkpoint bytes",
                          s["bytes"]),
                ]

            reg.register("checkpoint", ckpt_collect)
            from ..resilience import health as gang_health

            plane = gang_health.get_health_plane()
            if plane is not None:
                reg.register("gang", gang_collector(plane.skew))
            self._metrics_registry = reg
        return self._metrics_registry

    def start_metrics_server(self, host: str = "127.0.0.1",
                             port: int = 0):
        """Opt-in /metrics + /healthz endpoint for a training run
        (binds localhost by default; port=0 = ephemeral).  Stopped by
        stop()."""
        if self._metrics_server is not None:
            return self._metrics_server
        from ..observe.registry import MetricsServer

        def health():
            return {"state": "training",
                    "last_window_steps":
                        (self.last_telemetry.steps
                         if self.last_telemetry is not None else 0),
                    "ckpt": dict(self.ckpt_stats)}

        self._metrics_server = MetricsServer(
            self.metrics_registry(), health_fn=health,
            host=host, port=port,
            alerts_fn=(self.alert_engine.state
                       if self.alert_engine is not None
                       else None)).start()
        return self._metrics_server

    def enable_alerts(self, rules=None, interval_s: float = 5.0,
                      flight_dir: Optional[str] = None,
                      recorder_config: Optional[dict] = None,
                      start: bool = True, **pack_kw):
        """Opt into alerting on this trainer: an AlertEngine
        evaluating the training-health pack
        (`observe.trainer_rule_pack` — goodput drop, throughput
        regression, loss-spike/grad-norm z-scores, nonfinite steps,
        compile storm, gang skew; or explicit `rules`) over
        `metrics_registry()` every `interval_s` on a background
        thread.  With `flight_dir`, a FlightRecorder bundles
        diagnostics (event tail, metrics, goodput table, latched
        nonfinite provenance, watchdog state, thread stacks) on every
        firing alert AND on the step watchdog's hang verdict (when
        enabled before train()).  Pure host: the alert thread launches
        nothing on the device and the step runs the same program on or
        off.  Stopped by stop()."""
        if self.alert_engine is not None:
            return self.alert_engine
        from ..observe.alerts import AlertEngine, trainer_rule_pack
        from ..observe.flightrec import FlightRecorder

        if rules is None:
            rules = trainer_rule_pack(**pack_kw)
        elif pack_kw:
            raise ValueError("pack_kw only applies to the default "
                             "rule pack")
        engine = AlertEngine(self.metrics_registry(), rules=rules,
                             interval_s=interval_s,
                             event_log=self._event_log)
        self.metrics_registry().register("alerts", engine.collector())
        if flight_dir is not None:
            self.flight_recorder = FlightRecorder(
                flight_dir, registry=self.metrics_registry(),
                event_log=self._event_log,
                goodput=self.goodput_ledger,
                telemetry_fetch=lambda: self.last_telemetry,
                watchdog=self._step_watchdog,
                **(recorder_config or {}))
            self.flight_recorder.attach_engine(engine)
        self.alert_engine = engine
        if self._metrics_server is not None:
            self._metrics_server.alerts_fn = engine.state
        if start:
            engine.start()
        return engine

    def save_params(self, dirname: str):
        with scope_guard(self.scope):
            fluid_io.save_params(self.exe, dirname,
                                 main_program=self.train_program)

    def save_inference_model(self, dirname: str,
                             feeded_var_names: Sequence[str],
                             target_vars: Sequence):
        with scope_guard(self.scope):
            fluid_io.save_inference_model(
                dirname, feeded_var_names, list(target_vars), self.exe,
                main_program=self.train_program)

    def stop(self):
        if self.alert_engine is not None:
            self.alert_engine.close()
        if self.flight_recorder is not None:
            self.flight_recorder.close()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        if self._ckpt_writer is not None:
            # flush the writer; a silently-dropped last checkpoint must
            # surface here, not on the next preemption
            self._ckpt_writer.close()
        if self.checkpoint_cfg and self.mesh is not None:
            # on a mesh rank 0 alone makes a checkpoint visible (its
            # trainer state, after every rank's shards): no rank leaves
            # before it has, so a Trainer made next resumes from it
            # (ROADMAP C23).  The barrier fails fast on a poisoned gang;
            # without a mesh every checkpoint is the process's own
            fluid_io._barrier("trainer:stop")
        self.exe.close()


class Inferencer:
    """reference contrib/trainer.py Inferencer: load params produced by a
    Trainer and run a forward network.  place: as for the Trainer (None
    means CUDAPlace(0))."""

    def __init__(self, infer_func: Callable, param_path: str, place=None,
                 shared_scope: Optional[Scope] = None):
        self.scope = shared_scope or Scope()
        self.program = Program()
        startup = Program()
        with unique_name.guard(), program_guard(self.program, startup):
            outs = infer_func()
            self.outputs = (list(outs) if isinstance(outs, (list, tuple))
                            else [outs])
        self.exe = Executor(place)
        with scope_guard(self.scope):
            self.exe.run(startup)
            fluid_io.load_params(self.exe, param_path,
                                 main_program=self.program)

    def infer(self, inputs: Dict[str, np.ndarray]):
        with scope_guard(self.scope):
            return self.exe.run(self.program, feed=inputs,
                                fetch_list=[o.name for o in self.outputs])
