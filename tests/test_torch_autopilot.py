"""The port's divergence autopilot (paddle_tpu_torch/resilience/
autopilot.py behind contrib.Trainer(autopilot=)) on the CPU: the
counterparts of tests/test_autopilot.py's Trainer and controller cases,
and the port against the reference itself.

- THE gate: 12 batches, a NaN batch at index 5, checkpoints every 2
  steps, skip_streak=1: the Trainer rolls back to serial 1, quarantines
  [4, 6), replays the rest, and ends with every parameter BIT-IDENTICAL
  to a control whose reader never yields batches 4 and 5.
- The same run in both packages from the reference's startup values:
  the port's final parameters within 1e-6 of the reference's (float32,
  the same ops; 5.96e-8 measured on the CPU), its quarantine windows,
  rollback serials, recovery snapshot and recovery event sequence equal
  — with and without `lr_backoff`.
- The ladder's other rungs and guards: absorb below the streak, a zero
  budget halting with TrainingDivergedError and a flight bundle, the
  z-rule on a finite divergence, the rotation pin, a torn newer serial,
  config validation, telemetry/checkpoint requirements, and the same
  kernel calls, dispatches and host reads with the autopilot on or off.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
from paddle_tpu_torch import observe, resilience
from paddle_tpu_torch.contrib import CheckpointConfig, Trainer
from paddle_tpu_torch.convert import params_from_arrays
from paddle_tpu_torch.resilience import chaos

torch.set_num_threads(2)

RECOVERY_KINDS = ("recovery_rollback", "data_quarantine", "recovery_halt",
                  "ckpt_fallback")


@pytest.fixture(autouse=True)
def _clear_failpoints():
    yield
    chaos.clear()


def _funcs(fluid):
    def train_func():
        layers = fluid.layers
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(x, size=1)
        return layers.mean(layers.square_error_cost(pred, y))

    return train_func, lambda: fluid.optimizer.SGDOptimizer(
        learning_rate=0.1)


def _reader(n, seed=11):
    def read():
        r = np.random.RandomState(seed)
        for _ in range(n):
            yield {"x": r.rand(8, 4).astype(np.float32),
                   "y": r.rand(8, 1).astype(np.float32)}
    return read


def _params(t):
    out = {}
    for v in t.train_program.list_vars():
        if v.persistable and "__" not in v.name:
            val = t.scope.find_var(v.name)
            out[v.name] = (val.detach().cpu().numpy()
                           if isinstance(val, torch.Tensor)
                           else np.asarray(val))
    return out


def _trainer(tmp_path, tag, autopilot=None, interval=1, step_interval=2,
             fluid=pt, **kw):
    log = str(tmp_path / f"ev_{tag}.jsonl")
    train_func, opt_func = _funcs(fluid)
    contrib = fluid.contrib
    extra = {"place": pt.CPUPlace()} if fluid is pt else {}
    t = contrib.Trainer(
        train_func, opt_func,
        checkpoint_config=contrib.CheckpointConfig(
            str(tmp_path / f"ck_{tag}"), step_interval=step_interval),
        telemetry=fluid.observe.TelemetryConfig(interval=interval,
                                                log_path=log),
        autopilot=autopilot, **extra, **kw)
    fluid.resilience.enable_update_guard(t.train_program)
    return t, log


def _poisoned(n=12, at=5, fluid=pt):
    return fluid.resilience.chaos.nan_reader(_reader(n), at_step=at,
                                             names=["y"])


def _ap(fluid=pt, **kw):
    kw.setdefault("skip_streak", 1)
    return fluid.resilience.AutopilotConfig(loss_spike_z=None,
                                            grad_norm_z=None, **kw)


# ---------------------------------------------------------------------------
# The gate: rollback + quarantine == never saw the poison
# ---------------------------------------------------------------------------

def test_rollback_and_quarantine_bit_identical_params(tmp_path):
    t, log = _trainer(tmp_path, "auto", autopilot=_ap())
    t.train(num_epochs=1, reader=_poisoned())
    got = _params(t)

    def control_read():
        for i, b in enumerate(_reader(12)()):
            if i not in (4, 5):
                yield b

    ctl, _ = _trainer(tmp_path, "ctl")
    ctl.train(num_epochs=1, reader=control_read)
    want = _params(ctl)
    assert got and set(got) == set(want)
    for name in got:
        assert np.isfinite(got[name]).all(), name
        assert got[name].tobytes() == want[name].tobytes(), name

    snap = t.autopilot.snapshot()
    assert (snap["rollbacks"], snap["halted"], snap["quarantine_windows"],
            snap["quarantined_batches"]) == (1, 0, 1, 2)
    assert t.autopilot.quarantine_windows == [
        {"from_epoch": 0, "from_step": 4, "to_epoch": 0, "to_step": 6}]

    events = observe.read_events(log)
    kinds = [e["event"] for e in events]
    rb, dq = kinds.index("recovery_rollback"), kinds.index("data_quarantine")
    assert rb < dq and "telemetry" in kinds[:rb]
    assert events[rb]["serial"] == 1
    assert events[rb]["trigger"]["signal"] == "skip_streak"
    assert (events[rb]["from_step"], events[rb]["to_step"]) == (4, 6)
    assert events[dq]["batches"] == 2 and "recovery_halt" not in kinds

    rep = t.goodput()
    assert rep["categories_s"]["recovery"] > 0
    assert rep["fractions"]["recovery"] > 0
    fams = {f.name: f for f in t.metrics_registry().collect()}
    assert fams["recovery_rollbacks_total"].samples[0][1] == 1
    assert fams["recovery_autopilot_enabled"].samples[0][1] == 1
    assert fams["recovery_quarantined_batches_total"].samples[0][1] == 2
    # the alert pack's rollback rule reads that family and fires
    engine = t.enable_alerts(start=False)
    engine.evaluate()
    rule = [r for r in engine.state()["rules"]
            if r["id"] == "train_recovery_rollbacks"][0]
    assert rule["state"] in ("pending", "firing") and rule["value"] == 1
    t.stop()
    ctl.stop()


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

def _recovery_view(log):
    out = []
    for e in observe.read_events(log):
        if e["event"] in RECOVERY_KINDS:
            out.append({k: e.get(k) for k in (
                "event", "serial", "from_epoch", "from_step", "to_epoch",
                "to_step", "batches", "rollbacks", "budget")}
                | {"signal": (e.get("trigger") or {}).get("signal")})
    return out


@pytest.mark.parametrize("lr_backoff", [None, 0.5])
def test_matches_the_reference_run(tmp_path, lr_backoff):
    """Both packages' Trainers, the reference's startup values in both:
    final parameters within 1e-6 (float32, the same ops), equal
    quarantine windows, snapshots and recovery event sequences."""
    ref, ref_log = _trainer(tmp_path, "ref", fluid=jf,
                            autopilot=_ap(jf, lr_backoff=lr_backoff))
    port, port_log = _trainer(tmp_path, "port",
                              autopilot=_ap(lr_backoff=lr_backoff))
    start = {n: np.asarray(v) for n, v in ref.scope.vars.items()
             if v is not None and n in _params(port)}
    for n, tensor in params_from_arrays(start, "cpu").items():
        port.scope.set_var(n, tensor)
    ref.train(num_epochs=1, reader=_poisoned(fluid=jf))
    port.train(num_epochs=1, reader=_poisoned())
    want, got = _params(ref), _params(port)
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=1e-6, err_msg=name)
    assert port.autopilot.quarantine_windows == \
        ref.autopilot.quarantine_windows
    assert port.autopilot.snapshot() == ref.autopilot.snapshot()
    assert _recovery_view(port_log) == _recovery_view(ref_log)
    if lr_backoff is not None:
        lr = [n for n in got if n.endswith(".learning_rate")]
        assert lr and all(float(got[n][0]) == np.float32(0.1) * np.float32(
            lr_backoff) for n in lr)
    ref.stop()
    port.stop()


# ---------------------------------------------------------------------------
# The other rungs
# ---------------------------------------------------------------------------

def test_absorb_below_streak_zero_rollbacks(tmp_path):
    t, log = _trainer(tmp_path, "absorb", autopilot=_ap(skip_streak=2))
    t.train(num_epochs=1, reader=_poisoned(6, 2))
    assert t.autopilot.rollbacks == 0
    assert t.autopilot.quarantine_windows == []
    assert t.autopilot.skip_streak == 0
    kinds = [e["event"] for e in observe.read_events(log)]
    assert "recovery_rollback" not in kinds and "recovery_halt" not in kinds
    assert all(np.isfinite(v).all() for v in _params(t).values())
    t.stop()


def test_budget_zero_halts_with_structured_error_and_bundle(tmp_path):
    t, log = _trainer(tmp_path, "halt", autopilot=_ap(max_rollbacks=0))
    t.enable_alerts(rules=[], start=False,
                    flight_dir=str(tmp_path / "flight"))
    with pytest.raises(resilience.TrainingDivergedError) as ei:
        t.train(num_epochs=1, reader=_poisoned(6, 1))
    d = ei.value.as_dict()
    assert ei.value.kind == "training_diverged"
    assert d["reason"] == "rollback_budget_exhausted"
    assert d["rollbacks"] == 0 and d["budget"] == 0
    assert d["trigger"]["signal"] == "skip_streak"
    assert d["flight_bundle"] and os.path.isdir(d["flight_bundle"])
    with open(os.path.join(d["flight_bundle"], "MANIFEST.json")) as f:
        assert json.load(f)["reason"] == "training_diverged"
    assert json.dumps(d)
    assert "recovery_halt" in [e["event"] for e in observe.read_events(log)]
    assert t.autopilot.halted
    t.stop()


def test_no_verified_serial_halts(tmp_path):
    """A trigger before any verified-good save: nothing to roll back to,
    the run halts (reason no_verified_checkpoint)."""
    t, _ = _trainer(tmp_path, "nover", autopilot=_ap())
    with pytest.raises(resilience.TrainingDivergedError) as ei:
        t.train(num_epochs=1, reader=_poisoned(6, 0))
    assert ei.value.details["reason"] == "no_verified_checkpoint"
    t.stop()


def test_z_rule_trigger_on_finite_divergence():
    from paddle_tpu_torch.observe.metrics import StepTelemetry

    ctl = resilience.RecoveryController(resilience.AutopilotConfig(
        skip_streak=100, loss_spike_z=4.0, grad_norm_z=None,
        min_baseline_windows=4))

    def window(loss):
        return StepTelemetry(steps=2, loss_last=loss, loss_mean=loss,
                             grad_norm_last=1.0, grad_norm_mean=1.0,
                             update_norm_last=0.1, update_norm_mean=0.1,
                             nonfinite_grad_steps=0,
                             nonfinite_loss_steps=0)

    trig = None
    for i, loss in enumerate([1.0, 1.01, 0.99, 1.02, 1.0, 500.0]):
        trig = ctl.observe_window(window(loss), epoch=0, step=i)
        if loss < 100:
            assert trig is None, (i, trig)
    assert trig is not None and trig["signal"] == "autopilot_loss_spike"
    assert not ctl.healthy
    ctl.on_rollback({"from_epoch": 0, "from_step": 0,
                     "to_epoch": 0, "to_step": 5})
    assert ctl.healthy


def test_rotation_pins_newest_verified_good_serial(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    log = str(tmp_path / "ev.jsonl")
    train_func, opt_func = _funcs(pt)

    def make():
        return Trainer(train_func, opt_func, place=pt.CPUPlace(),
                       checkpoint_config=CheckpointConfig(
                           ckpt_dir, max_num_checkpoints=2,
                           step_interval=100),
                       telemetry=observe.TelemetryConfig(interval=1,
                                                         log_path=log))

    t = make()
    t.train(num_epochs=1, reader=_reader(3))
    assert t._list_checkpoints() == [0] and t._serial_verified(0)
    t._window_dirty = True
    for serial in (1, 2, 3):
        t._save_checkpoint(serial, 0, 99)
        assert not t._serial_verified(serial)
    assert t._list_checkpoints() == [0, 3]
    chaos.corrupt_shard(os.path.join(ckpt_dir, "ckpt_3"))
    t2 = make()
    falls = [e for e in observe.read_events(log)
             if e["event"] == "ckpt_fallback"]
    assert falls and falls[-1]["serial"] == 3
    with open(os.path.join(ckpt_dir, "ckpt_0",
                           "__trainer_state__.json")) as f:
        st = json.load(f)
    assert st["verified_good"] is True
    assert (t2._resume_epoch, t2._resume_step_in_epoch) == \
        (st["epoch"], st["step"])
    t.stop()
    t2.stop()


def test_torn_newer_serial_is_invisible_and_pin_survives(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    train_func, opt_func = _funcs(pt)

    def make(**kw):
        return Trainer(train_func, opt_func, place=pt.CPUPlace(),
                       checkpoint_config=CheckpointConfig(ckpt_dir, **kw),
                       telemetry=observe.TelemetryConfig(interval=1))

    t = make(max_num_checkpoints=2, step_interval=100)
    t.train(num_epochs=1, reader=_reader(3))
    t._window_dirty = True
    t._save_checkpoint(1, 0, 99)
    assert t._list_checkpoints() == [0, 1]
    chaos.tear_checkpoint(os.path.join(ckpt_dir, "ckpt_1"))
    assert t._list_checkpoints() == [0]
    t2 = make()
    assert (t2._resume_epoch, t2._resume_step_in_epoch) == (1, 0)
    t.stop()
    t2.stop()


def test_autopilot_on_off_same_kernel_calls_and_host_reads(tmp_path,
                                                           monkeypatch):
    """The controller is pure host: on a clean reader the same kernel
    calls, dispatches, host reads and final parameters with the
    autopilot attached or absent."""
    from paddle_tpu_torch.observe import runtime_stats
    from paddle_tpu_torch.ops import kernels

    def run(tag, autopilot):
        t, _ = _trainer(tmp_path, tag, autopilot=autopilot)
        reads = {"n": 0}
        for name in ("cpu", "item", "tolist", "numpy"):
            orig = getattr(torch.Tensor, name)

            def counted(self, *a, _orig=orig, **kw):
                reads["n"] += 1
                return _orig(self, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, counted)
        kernels.reset_counts()
        snap = runtime_stats.snapshot()
        t.train(num_epochs=1, reader=_reader(6))
        out = (reads["n"], kernels.counts(),
               runtime_stats.delta(snap)["dispatches"])
        monkeypatch.undo()
        params = _params(t)
        t.stop()
        return out, params

    on, p_on = run("on", _ap())
    off, p_off = run("off", None)
    assert on == off and off[2] == 6
    assert all(p_on[n].tobytes() == p_off[n].tobytes() for n in p_on)


def test_autopilot_requires_telemetry_and_checkpoints(tmp_path):
    train_func, opt_func = _funcs(pt)
    with pytest.raises(ValueError, match="telemetry"):
        Trainer(train_func, opt_func, place=pt.CPUPlace(),
                autopilot=resilience.AutopilotConfig())
    with pytest.raises(ValueError, match="checkpoint_config"):
        Trainer(train_func, opt_func, place=pt.CPUPlace(),
                telemetry=observe.TelemetryConfig(interval=1),
                autopilot=resilience.AutopilotConfig())


def test_autopilot_config_validation():
    with pytest.raises(ValueError):
        resilience.AutopilotConfig(skip_streak=0)
    with pytest.raises(ValueError):
        resilience.AutopilotConfig(max_rollbacks=-1)
    with pytest.raises(ValueError):
        resilience.AutopilotConfig(lr_backoff=1.5)


def test_validate_feed_counts_into_the_quarantine(tmp_path):
    """An admission-rejected batch joins the autopilot's quarantine
    count without a rollback."""
    t, _ = _trainer(tmp_path, "vf", autopilot=_ap(), validate_feed=True)
    t.train(num_epochs=1, reader=_poisoned(6, 3))
    assert t.feed_stats["quarantined"] == 1
    assert t.autopilot.quarantined_batches == 1
    assert t.autopilot.rollbacks == 0
    t.stop()
