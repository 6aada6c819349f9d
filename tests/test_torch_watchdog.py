"""The port's step watchdog and retry machinery on the CPU
(paddle_tpu_torch/resilience/watchdog.py), held to the reference's
contracts (tests/test_gang.py, tests/test_resilience.py):

- `Deadline` fires by SIGALRM on the main thread and by the timer
  thread's async exception elsewhere, on a host-side `chaos.hang`;
  `seconds <= 0` disables it;
- `DispatchWatchdog`: the first region rides the compile grace, a real
  port `Executor` dispatch moves it to the step budget, and a hang then
  raises `StepHangError` after a `step_hang` event and `on_hang`;
- the Trainer's step budgets, and a hung Trainer step;
- `retry_call`'s deterministic backoff, its exhaustion, and
  non-retryable errors; `backoff_schedule`;
- `probe_backend` on the CPU: without CUDA it reports the failure,
  asked for the CPU it passes, and a timeout reads as a hang.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import torch_preempt_worker as W
from paddle_tpu_torch import layers, observe
from paddle_tpu_torch.contrib import Trainer
from paddle_tpu_torch.resilience import (Deadline, DispatchWatchdog,
                                         RetriesExhaustedError,
                                         StepHangError, WatchdogTimeout,
                                         backoff_schedule, chaos,
                                         probe_backend, retry_call)

torch.set_num_threads(2)


def test_deadline_sigalrm_on_main_thread():
    with pytest.raises(WatchdogTimeout) as ei:
        with Deadline(1, what="main hang") as d:
            assert d.mode == "sigalrm"
            chaos.hang(10)
    d = ei.value.as_dict()
    assert (d["error"], d["mode"], d["what"]) == \
        ("watchdog_timeout", "sigalrm", "main hang")


def test_deadline_timer_thread_off_the_main_thread():
    result = {}

    def worker():
        try:
            with Deadline(0.4, what="thread region") as d:
                assert d.mode == "timer"
                chaos.hang(10)
            result["r"] = "no-fire"
        except WatchdogTimeout as e:
            result["r"] = e.details

    t = threading.Thread(target=worker)
    t.start()
    t.join(15)
    assert not t.is_alive()
    assert result["r"]["mode"] == "timer"
    assert result["r"]["what"] == "thread region"


def test_deadline_disabled_and_clean_exit():
    with Deadline(0, what="disabled") as d:
        chaos.hang(0.1)
    assert d.mode is None
    with Deadline(60, what="fast"):
        x = 1 + 1
    assert x == 2


def test_dispatch_watchdog_grace_then_hung_step(tmp_path):
    log = observe.RunEventLog(str(tmp_path / "ev.jsonl"))
    hangs = []
    wd = DispatchWatchdog(step_deadline_s=1.0, compile_grace_s=3.0,
                          event_log=log, on_hang=hangs.append)
    with wd.guard("step 0"):            # over the step budget, in grace
        chaos.hang(1.3)
    assert wd.regions[0]["kind"] == "first_compile"
    assert wd.regions[0]["budget_s"] == 3.0 and wd.regions[0]["hang"] is None
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data("x", shape=[2, 2], append_batch_size=False)
        y = layers.mean(x)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    with wd.guard("step 1"):            # a real dispatch completes
        exe.run(main, feed={"x": np.zeros((2, 2), "f4")}, fetch_list=[y],
                scope=scope)
    assert wd.regions[1]["kind"] == "step"
    with pytest.raises(StepHangError) as ei:
        with wd.guard("step 2"):
            chaos.hang(10)
    d = ei.value.as_dict()
    assert (d["kind"], d["budget_s"]) == ("hung_step", 1.0)
    assert d["dispatches_delta"] == 0 and d["retraces_delta"] == 0
    assert hangs and hangs[0]["kind"] == "hung_step"
    log.close()
    ev = [e for e in observe.read_events(log.path)
          if e["event"] == "step_hang"]
    assert ev and ev[0]["hang_kind"] == "hung_step"


def test_dispatch_watchdog_first_compile_timeout_kind():
    wd = DispatchWatchdog(step_deadline_s=0.5, compile_grace_s=1.0)
    with pytest.raises(StepHangError) as ei:
        with wd.guard("step 0"):
            chaos.hang(10)
    assert ei.value.details["kind"] == "first_compile"
    assert ei.value.details["budget_s"] == 1.0


def test_trainer_step_budgets():
    t = Trainer(W.train_func, W.opt_func, place=pt.CPUPlace(),
                step_deadline_s=30.0)
    t.train(num_epochs=1, reader=W.make_reader(3))
    regions = t._step_watchdog.regions
    assert len(regions) == 3
    assert regions[0]["kind"] == "first_compile"
    assert regions[0]["budget_s"] == 300.0  # 10x the step budget
    assert all(r["kind"] == "step" and r["budget_s"] == 30.0
               for r in regions[1:])
    assert all(r["hang"] is None for r in regions)


def test_trainer_hung_step_raises(tmp_path):
    """A step that stops returning after steps were flowing: the
    Trainer's watchdog raises StepHangError with a step_hang event."""
    log = str(tmp_path / "ev.jsonl")
    t = Trainer(W.train_func, W.opt_func, place=pt.CPUPlace(),
                step_deadline_s=1.0,
                telemetry=observe.TelemetryConfig(log_path=log))
    run = t.exe.run
    calls = []

    def wedged(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            chaos.hang(10)
        return run(*a, **k)

    t.exe.run = wedged
    with pytest.raises(StepHangError) as ei:
        t.train(num_epochs=1, reader=W.make_reader(6))
    assert ei.value.details["what"] == "train step 0/2"
    ev = [e for e in observe.read_events(log) if e["event"] == "step_hang"]
    assert ev[0]["hang_kind"] == "hung_step" and ev[0]["budget_s"] == 1.0


def test_retry_backoff_is_deterministic():
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("transient")
        return "ok"

    seen = []
    out = retry_call(flaky, retries=3, base_delay_s=0.1,
                     retry_on=(ConnectionError,), sleep=sleeps.append,
                     on_retry=lambda a, e, s: seen.append((a, s)))
    assert out == "ok"
    assert sleeps == [0.1, 0.2] == backoff_schedule(2, 0.1, 30.0)
    assert seen == [(0, 0.1), (1, 0.2)]
    assert backoff_schedule(5, 1.0, 4.0) == [1.0, 2.0, 4.0, 4.0, 4.0]


def test_retry_exhaustion_is_structured():
    sleeps = []
    with pytest.raises(RetriesExhaustedError) as ei:
        retry_call(lambda: (_ for _ in ()).throw(ConnectionError("down")),
                   retries=2, base_delay_s=0.1,
                   retry_on=(ConnectionError,), sleep=sleeps.append)
    d = ei.value.as_dict()
    assert d["attempts"] == 3 and "ConnectionError" in d["last_error"]
    assert sleeps == [0.1, 0.2]
    with pytest.raises(ValueError):
        retry_call(lambda: (_ for _ in ()).throw(ValueError("bug")),
                   retries=5, retry_on=(ConnectionError,),
                   sleep=lambda _s: None)
    with pytest.raises(ValueError, match="retries"):
        retry_call(lambda: None, retries=-1)


def test_probe_backend_on_the_cpu(monkeypatch):
    monkeypatch.delenv("TORCH_PROBE_PLATFORM", raising=False)
    failed = probe_backend(120, platform_env="TORCH_PROBE_PLATFORM")
    if torch.cuda.is_available():     # a machine with a card: healthy
        assert failed is None
    else:
        assert "CUDA is not available" in failed
    monkeypatch.setenv("TORCH_PROBE_PLATFORM", "cpu")
    assert probe_backend(120, platform_env="TORCH_PROBE_PLATFORM") is None
    hung = probe_backend(0.01, platform_env="TORCH_PROBE_PLATFORM")
    assert "hang, not error" in hung
