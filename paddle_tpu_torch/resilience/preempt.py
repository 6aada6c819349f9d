"""Preemption tolerance: async checkpoint writing + SIGTERM drain — the
port of paddle_tpu/resilience/preempt.py (it imports nothing of jax, so
the port keeps its own copy, with the same names and contracts).

Machines are reclaimed and hosts are SIGTERMed mid-step, and the two
halves of surviving that live here:

1. **SnapshotWriter** — the async half of checkpointing.  A sharded
   save splits into a BLOCKING snapshot phase (device→host copy of the
   state into host memory the save owns; the only part the step loop
   must wait for) and a WRITE phase (CRC, zip serialization,
   manifest-last rename) that runs on a single background writer
   thread with a bounded queue.  The writer thread touches no tensor:
   it writes numpy arrays the snapshot already copied.  Ordering
   guarantees:

   - one write in flight per writer: a save submitted while another is
     writing WAITS for it (never interleaves two saves' files),
   - the write phase preserves manifest-last, so a writer killed
     mid-flush leaves a torn — and therefore unloadable — directory,
     exactly like a synchronous save killed at the same spot,
   - a writer-thread failure is latched and re-raised as a structured
     `CheckpointWriteError` on the NEXT submit/wait/close — async
     saves may be deferred, never silent.

2. **Drain controller** — a SIGTERM/SIGINT handler (main-thread-only,
   same degradation contract as watchdog.Deadline) that only sets a
   flag; the training loop (contrib.Trainer) checks `drain_requested()`
   at step boundaries, finishes the in-flight step, awaits any
   in-flight async save, writes an emergency checkpoint, and raises
   `TrainingPreempted` carrying `PREEMPT_EXIT_CODE` so the wrapper
   script can exit with a code schedulers can tell from a crash.
   `request_drain()` is the injectable test/programmatic path.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .errors import CheckpointWriteError

# Distinct exit code for a drained (preempted-but-checkpointed) exit:
# outside the shell's 1/2, pytest's 1-5, and the 128+signum band a
# raw SIGTERM/SIGKILL death produces — a supervisor seeing 77 knows an
# emergency checkpoint landed and a plain relaunch resumes.
PREEMPT_EXIT_CODE = 77


class PendingSave:
    """Handle for one in-flight (or completed) async checkpoint save.

    `snapshot_ms` (the blocking device→host portion) is known at
    submit; `write_ms`/`bytes_written` fill in when the background
    write completes.  `result()` re-raises the write-phase failure as
    a structured CheckpointWriteError."""

    def __init__(self, dirname: str, snapshot_ms: float,
                 bytes_total: int):
        self.dirname = dirname
        self.snapshot_ms = snapshot_ms
        self.bytes_total = bytes_total
        self.write_ms: Optional[float] = None
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> "PendingSave":
        """Block until the write phase finishes; raise its failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"async checkpoint write to {self.dirname!r} did not "
                f"complete within {timeout}s")
        if self._error is not None:
            raise _as_write_error(self._error, self.dirname)
        return self

    def stats(self) -> Dict[str, Any]:
        return {"dirname": self.dirname,
                "snapshot_ms": round(self.snapshot_ms, 3),
                "write_ms": (round(self.write_ms, 3)
                             if self.write_ms is not None else None),
                "bytes": self.bytes_total}


def _as_write_error(exc: BaseException, dirname: str) -> CheckpointWriteError:
    if isinstance(exc, CheckpointWriteError):
        return exc
    return CheckpointWriteError(
        f"async checkpoint write to {dirname!r} failed: "
        f"{type(exc).__name__}: {exc}", dirname=dirname,
        cause=f"{type(exc).__name__}: {exc}")


class SnapshotWriter:
    """One background writer thread + bounded queue for async
    checkpoint saves.

    `submit(job, finalize=)` enqueues a prepared save (io.py
    `prepare_sharded_save`) whose blocking snapshot phase ALREADY ran
    on the caller's thread.  The queue is bounded: submitting while a
    write is in flight waits for it first (coalescing by completion —
    two saves never interleave, and the step loop is back to training
    the moment the new snapshot is taken).  A latched writer failure
    is raised on the next submit/wait_idle/close as
    CheckpointWriteError — use `check()` to poll it explicitly.

    `ledger`: an observe GoodputLedger — each completed write phase is
    recorded on its `ckpt_write` BACKGROUND channel (overlapped work,
    deliberately not a wall category; the blocking snapshot the step
    loop waited out is the caller's "checkpoint" phase)."""

    def __init__(self, name: str = "ckpt-writer", ledger=None):
        self._name = name
        self._ledger = ledger
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._inflight: Optional[PendingSave] = None
        self._pending_error: Optional[CheckpointWriteError] = None
        self._closed = False

    # -- failure surfacing ------------------------------------------------
    def check(self) -> None:
        """Raise (once) the failure of a previously submitted write."""
        with self._lock:
            err, self._pending_error = self._pending_error, None
        if err is not None:
            raise err

    # -- submission -------------------------------------------------------
    def submit(self, job, finalize: Optional[Callable[[], None]] = None
               ) -> PendingSave:
        """Run `job.write()` (then `finalize()`) on the writer thread.

        Blocks only until any previous write finishes (bounded queue of
        one) — the caller's snapshot is already taken, so this wait is
        the no-two-saves-interleave guarantee, not a serialization
        stall of the new save's snapshot."""
        if self._closed:
            raise RuntimeError(f"{self._name} is closed")
        self.check()
        prev = self._inflight
        if prev is not None:
            prev._done.wait()
            self._latch(prev)
            self.check()
        pending = PendingSave(job.dirname, job.snapshot_ms, job.bytes_total)

        def _run():
            t0 = time.perf_counter()
            try:
                job.write()
                if finalize is not None:
                    finalize()
            except BaseException as e:  # noqa: BLE001 — latched, re-raised
                pending._error = e
            finally:
                pending.write_ms = (time.perf_counter() - t0) * 1000.0
                if self._ledger is not None:
                    self._ledger.note_background(
                        "ckpt_write", pending.write_ms / 1000.0)
                pending._done.set()

        self._inflight = pending
        self._thread = threading.Thread(target=_run, name=self._name,
                                        daemon=True)
        self._thread.start()
        return pending

    def _latch(self, pending: PendingSave) -> None:
        if pending._error is not None and self._pending_error is None:
            with self._lock:
                self._pending_error = _as_write_error(
                    pending._error, pending.dirname)
            pending._error = None  # surfaced exactly once

    # -- completion -------------------------------------------------------
    def wait_idle(self, timeout: Optional[float] = None) -> None:
        """Block until no write is in flight; raise any latched/new
        failure.  The drain path calls this before the emergency save."""
        prev = self._inflight
        if prev is not None:
            if not prev._done.wait(timeout):
                raise TimeoutError(
                    f"async checkpoint write to {prev.dirname!r} did "
                    f"not complete within {timeout}s")
            self._latch(prev)
            self._inflight = None
        self.check()

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Flush and shut down; raises a pending failure (a run must
        not exit green with its last checkpoint silently missing)."""
        if self._closed:
            return
        self._closed = True
        self.wait_idle(timeout)


_default_writer: Optional[SnapshotWriter] = None
_default_writer_lock = threading.Lock()


def default_writer() -> SnapshotWriter:
    """Process-wide writer shared by io.save_sharded(async_=True)
    callers that do not manage their own."""
    global _default_writer
    with _default_writer_lock:
        if _default_writer is None or _default_writer._closed:
            _default_writer = SnapshotWriter()
        return _default_writer


# ---------------------------------------------------------------------------
# Drain controller (SIGTERM/SIGINT → finish step → emergency checkpoint)
# ---------------------------------------------------------------------------

_drain_event = threading.Event()
_drain_reason: List[str] = []
_installed: Dict[int, Any] = {}  # signum -> previous handler


def drain_requested() -> bool:
    return _drain_event.is_set()


def drain_reason() -> Optional[str]:
    return _drain_reason[-1] if _drain_reason else None


def request_drain(reason: str = "requested") -> None:
    """Programmatic/injectable drain trigger (what the signal handler
    calls; tests call it directly — signals are process-global)."""
    _drain_reason.append(reason)
    _drain_event.set()


def clear_drain() -> None:
    _drain_event.clear()
    _drain_reason.clear()


def install_preempt_handler(signals=None) -> bool:
    """Install the drain-flag handler for SIGTERM/SIGINT.  Returns True
    when installed; off the main thread it degrades to a recorded no-op
    (signal.signal is main-thread-only — same contract as
    watchdog.Deadline) so a worker-thread Trainer never crashes trying.
    Idempotent; `uninstall_preempt_handler` restores the previous
    handlers."""
    import signal as _signal

    if threading.current_thread() is not threading.main_thread():
        return False
    if signals is None:
        signals = (_signal.SIGTERM, _signal.SIGINT)

    def _fire(signum, frame):  # noqa: ARG001 — signal handler shape
        request_drain(reason=f"signal:{_signal.Signals(signum).name}")

    for s in signals:
        if s not in _installed:
            _installed[s] = _signal.signal(s, _fire)
    return True


def uninstall_preempt_handler() -> None:
    import signal as _signal

    if threading.current_thread() is not threading.main_thread():
        return
    for s, old in list(_installed.items()):
        _signal.signal(s, old)
        _installed.pop(s, None)
