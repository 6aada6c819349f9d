"""Watchdog + retry: deadline-guarded steps and bounded
exponential-backoff retries — the port of
paddle_tpu/resilience/watchdog.py.

- a backend can HANG on init, not just error — so `probe_backend`
  brings CUDA up and runs one tiny `torch.matmul` in a SUBPROCESS with
  a hard timeout; an in-process try/except never fires on a hang,
- a hung step must become a recorded error, not eat the caller's
  whole budget — `Deadline` is the SIGALRM watchdog contrib.Trainer
  (`step_deadline_s`) wraps each step in.

`Deadline` uses SIGALRM on the main thread and a TIMER-THREAD
fallback elsewhere (`PyThreadState_SetAsyncExc` into the guarded
thread — CPython accepts only a CLASS there, so the fallback raises a
dynamically derived WatchdogTimeout subclass carrying the region name
in its no-arg constructor).  Both modes are best-effort: a signal
handler and an async exception run only once the guarded thread is
back in the interpreter.  On a card that bounds what they can
interrupt: a kernel that never finishes blocks the thread inside a
CUDA synchronisation (a `.cpu()`, `.item()` or
`torch.cuda.synchronize()`), and the watchdog fires only when that call
returns.  What it interrupts is a host-side hang: a step loop stuck in
Python (a reader, a handler, `chaos.hang`), not a wedged kernel.  Like
the reference, the port has no device-side watchdog.

`DispatchWatchdog` is the training-step layer on top: per-step
budgets that distinguish a FIRST STEP (no dispatch has completed since
the watchdog was created — the port builds its CUDA kernels with `nvcc`
at first use; the long `compile_grace_s` budget applies) from a HUNG
STEP (a previously-working step stopped returning; the tight
`step_deadline_s` applies), using the host-side `runtime_stats`
compile/dispatch counters (`Executor.run` records one dispatch as it
returns).  On timeout it emits a `step_hang` event (and fires `on_hang`)
BEFORE raising the structured `StepHangError`, so the abort is
observable even if the raise itself gets swallowed by a dying process.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

from .errors import RetriesExhaustedError, StepHangError, WatchdogTimeout


def _timer_exc_class(what: str, seconds: float):
    """A WatchdogTimeout subclass whose no-arg constructor carries the
    region context — PyThreadState_SetAsyncExc instantiates the class
    itself and rejects pre-built instances."""

    class _TimerDeadline(WatchdogTimeout):
        def __init__(self):
            super().__init__(
                f"{what} exceeded {seconds:.0f}s deadline "
                f"(timer-thread watchdog)", what=what,
                deadline_s=seconds, mode="timer")

    _TimerDeadline.__name__ = "WatchdogTimeout"
    return _TimerDeadline


class Deadline:
    """Wall-clock watchdog around a region: raises `WatchdogTimeout`
    (with the region name in `details`) when the body exceeds
    `seconds`.  Main thread: SIGALRM.  Other threads: a timer thread
    injects the exception via PyThreadState_SetAsyncExc (`mode`
    records which).  Best-effort — a C call that never re-enters the
    interpreter cannot be interrupted; `seconds <= 0` disables."""

    def __init__(self, seconds: float, what: str = "guarded region"):
        self.seconds = float(seconds)
        self.what = what
        self.armed = False
        self.mode: Optional[str] = None
        self._old = None
        self._timer: Optional[threading.Timer] = None
        self._done = False
        self._lock = threading.Lock()

    def __enter__(self):
        import signal

        if self.seconds <= 0:
            return self
        if threading.current_thread() is threading.main_thread():
            def _fire(signum, frame):
                raise WatchdogTimeout(
                    f"{self.what} exceeded {self.seconds:.0f}s deadline",
                    what=self.what, deadline_s=self.seconds,
                    mode="sigalrm")

            self._old = signal.signal(signal.SIGALRM, _fire)
            # SIGALRM takes whole seconds; round up so Deadline(0.5) fires
            signal.alarm(max(1, int(-(-self.seconds // 1))))
            self.armed = True
            self.mode = "sigalrm"
            return self

        # off the main thread: timer-thread fallback (the pre-gang
        # behavior was a silent no-op — a watchdog that only works on
        # one thread cannot guard supervisor/serving workers)
        import ctypes

        tid = threading.get_ident()
        exc_cls = _timer_exc_class(self.what, self.seconds)

        def _expire():
            with self._lock:
                if self._done:
                    return
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid), ctypes.py_object(exc_cls))

        self._timer = threading.Timer(self.seconds, _expire)
        self._timer.daemon = True
        self._timer.start()
        self.armed = True
        self.mode = "timer"
        return self

    def __exit__(self, *exc):
        import signal

        if not self.armed:
            return False
        if self.mode == "sigalrm":
            signal.alarm(0)
            signal.signal(signal.SIGALRM, self._old)
        else:
            with self._lock:
                self._done = True
            if self._timer is not None:
                self._timer.cancel()
        self.armed = False
        return False


class DispatchWatchdog:
    """Per-step host deadline that knows the difference between "the
    first step is still building its kernels" and "a working step
    hung".

    The host cannot see inside a blocked dispatch, so the proxy is the
    runtime_stats counters: until this process has COMPLETED at least
    one dispatch since the watchdog was created, a guarded region is
    classified `first_compile` and gets `compile_grace_s`; afterwards
    every region is a steady-state step and gets `step_deadline_s`.
    Each timeout emits a `step_hang` event (runtime_stats deltas
    attached), calls `on_hang(fields)`, then raises
    `StepHangError`.  `regions` records every guarded region's budget
    and verdict — the test-observable surface."""

    def __init__(self, step_deadline_s: float,
                 compile_grace_s: Optional[float] = None,
                 event_log=None,
                 on_hang: Optional[Callable[[Dict[str, Any]], None]]
                 = None):
        self.step_deadline_s = float(step_deadline_s)
        self.compile_grace_s = (
            float(compile_grace_s) if compile_grace_s is not None
            else max(self.step_deadline_s * 10.0, 60.0))
        self.event_log = event_log
        self.on_hang = on_hang
        self.regions: List[Dict[str, Any]] = []
        self._snap0: Optional[Dict[str, Any]] = None

    @contextmanager
    def guard(self, what: str = "train step"):
        from ..observe import runtime_stats

        snap = runtime_stats.snapshot()
        if self._snap0 is None:
            self._snap0 = snap
        seen_dispatch = snap["dispatches"] > self._snap0["dispatches"]
        kind = "step" if seen_dispatch else "first_compile"
        budget = (self.step_deadline_s if seen_dispatch
                  else self.compile_grace_s)
        rec: Dict[str, Any] = {"what": what, "kind": kind,
                               "budget_s": budget, "hang": None}
        self.regions.append(rec)
        try:
            with Deadline(budget, what=what):
                yield rec
        except WatchdogTimeout as e:
            delta = runtime_stats.delta(snap)
            hang_kind = ("first_compile" if kind == "first_compile"
                         else "hung_step")
            rec["hang"] = hang_kind
            fields = {"what": what, "kind": hang_kind,
                      "budget_s": budget,
                      "compiles_delta": delta["compiles"],
                      "dispatches_delta": delta["dispatches"],
                      "retraces_delta": delta["retraces"]}
            if self.event_log is not None:
                try:
                    # the verdict field is `hang_kind` in the event
                    # record ("kind" is the event method's own
                    # positional and cannot ride **fields)
                    self.event_log.event(
                        "step_hang",
                        **{("hang_kind" if k == "kind" else k): v
                           for k, v in fields.items()})
                except Exception:  # noqa: BLE001
                    pass
            if self.on_hang is not None:
                try:
                    self.on_hang(dict(fields))
                except Exception:  # noqa: BLE001 — abort must proceed
                    pass
            raise StepHangError(
                f"{what} exceeded its {budget:.0f}s "
                f"{'compile-grace' if hang_kind == 'first_compile' else 'step'}"
                f" budget ({hang_kind}); compiles+{delta['compiles']} "
                f"dispatches+{delta['dispatches']} inside the region",
                **fields) from e


def probe_backend(timeout_s: float,
                  platform_env: str = "BENCH_PLATFORM") -> Optional[str]:
    """Fail-fast backend health check: bring CUDA up and run one tiny
    bf16 `torch.matmul` on `cuda:0` in a SUBPROCESS with a hard timeout.
    Returns None when healthy, else a short failure description (hang
    vs error is distinguished; no CUDA device is an error).  When the
    env var named by `platform_env` is set to "cpu", the probe runs on
    the CPU instead — only when asked, as every entry point of the port
    runs on the CPU only when asked."""
    import os
    import subprocess
    import sys

    code = "\n".join((
        "import os, torch",
        f"cpu = os.environ.get({platform_env!r}) == 'cpu'",
        "if not cpu and not torch.cuda.is_available():",
        "    raise SystemExit('CUDA is not available')",
        "dev = torch.device('cpu') if cpu else torch.device('cuda', 0)",
        "x = torch.ones((128, 128), dtype=torch.bfloat16, device=dev)",
        "(x @ x).float().sum().item()",
        "print('BACKEND_OK',",
        "      'cpu' if cpu else torch.cuda.get_device_name(dev))"))
    try:
        r = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True,
                           timeout=timeout_s, env=dict(os.environ))
    except subprocess.TimeoutExpired:
        return (f"backend init did not complete within {timeout_s:.0f}s "
                f"(hang, not error)")
    if r.returncode != 0 or "BACKEND_OK" not in r.stdout:
        tail = (r.stderr or r.stdout).strip().splitlines()[-3:]
        return "backend init failed: " + " | ".join(tail)
    return None


def retry_call(fn: Callable, *, retries: int = 3,
               base_delay_s: float = 0.5, max_delay_s: float = 30.0,
               retry_on: Tuple[Type[BaseException], ...]
               = (Exception,),
               on_retry: Optional[Callable[[int, BaseException, float],
                                           None]] = None,
               sleep: Callable[[float], None] = time.sleep):
    """Call `fn()` with up to `retries` re-attempts on transient
    failure, sleeping base_delay_s * 2**attempt (capped) between
    attempts — deterministic backoff so tests can assert the schedule
    via an injected `sleep`.  `on_retry(attempt, exc, delay_s)` is the
    observation hook.  Raises `RetriesExhaustedError` (chaining the
    final error) when every attempt fails; non-retryable exceptions
    propagate immediately."""
    if retries < 0:
        raise ValueError("retries must be >= 0")
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on as exc:  # noqa: PERF203 — retry loop
            last = exc
            if attempt == retries:
                break
            delay = min(base_delay_s * (2.0 ** attempt), max_delay_s)
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
    raise RetriesExhaustedError(
        f"{retries + 1} attempt(s) failed; last error: {last}",
        attempts=retries + 1, last_error=f"{type(last).__name__}: {last}"
    ) from last


def backoff_schedule(retries: int, base_delay_s: float,
                     max_delay_s: float) -> Sequence[float]:
    """The deterministic delay sequence retry_call (and the gang
    supervisor) sleep between attempts — exposed so callers/tests can
    assert the schedule instead of re-deriving it."""
    return [min(base_delay_s * (2.0 ** a), max_delay_s)
            for a in range(retries)]
