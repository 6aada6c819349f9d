"""The port's contrib.Trainer and Inferencer on the CPU, against the
reference's contracts (paddle_tpu/contrib/trainer.py) and, where the two
packages meet, against the reference itself.

The job is tests/torch_preempt_worker.py's (fc, dropout 0.3, Adam,
`amp.decorate(use_dynamic_loss_scaling=True)`, a NaN batch at step 4, a
seeded shuffle): the event order, training without a checkpoint
config, the mid-epoch resume, the fallback over a corrupt newest
serial, keep-last-k with the newest verified-good serial pinned, torn
saves never listed, a newer train_state version and drifted generated
names rejected, the in-process resume bit for bit, the RNG rule of the
module docstring, host reads only through `.cpu()`, telemetry windows
with their `nonfinite_provenance`, feed admission, the inference
export, and the options left out.

Across packages, the same model at dropout 0:

- the reference's Trainer checkpoints after 6 steps (the NaN batch
  among them) and both Trainers resume that checkpoint and run the
  epoch to its 12th step: the port's losses stay within 1e-4 of the
  reference's and its parameters within 1e-3 (bf16 products under AMP,
  summed in another order: 1.1e-5 and 3.7e-5 measured), and the guard's
  counters and the loss scale equal the reference's exactly;
- the port's and the reference's Inferencers, on the parameters the
  reference's Trainer saved, agree within 1e-5.
"""

from __future__ import annotations

import json
import os
import shutil
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pt
import torch_preempt_worker as W
from paddle_tpu_torch import observe
from paddle_tpu_torch.contrib import (CheckpointConfig, EndStepEvent,
                                      Inferencer, Trainer)
from paddle_tpu_torch.contrib.trainer import (TRAIN_STATE_VERSION,
                                              rng_counter_from_state)
from paddle_tpu_torch.core.executor import RNG_STATE_VAR
from paddle_tpu_torch.observe.metrics import TELEMETRY_VAR
from paddle_tpu_torch.resilience import chaos, errors, preempt

from torch_amp_parity import keep_reference_roundings

torch.set_num_threads(2)

LR = 0.01


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    chaos.clear()
    preempt.clear_drain()


def _trainer(ckpt=None, log=None, step_interval=3, keep=3, interval=100,
             async_save=False, **kw):
    cfg = (CheckpointConfig(ckpt, step_interval=step_interval,
                            epoch_interval=10 ** 6, async_save=async_save,
                            max_num_checkpoints=keep)
           if ckpt else None)
    tel = (observe.TelemetryConfig(interval=interval, log_path=log,
                                   numerics=kw.pop("numerics", False))
           if log else None)
    return Trainer(W.train_func, W.opt_func, place=pt.CPUPlace(),
                   checkpoint_config=cfg, telemetry=tel, **kw)


def _state(t):
    """Persistables, the run counter and the telemetry accumulator."""
    out = {v.name: t.scope.find_var(v.name).numpy()
           for v in t.train_program.list_vars() if v.persistable}
    out[RNG_STATE_VAR] = t.scope.find_var(RNG_STATE_VAR)
    for k, v in t.scope.find_var(TELEMETRY_VAR).items():
        out[f"tel/{k}"] = v.numpy()
    return out


def _assert_equal_states(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k


def _losses(events):
    """The loss of each EndStepEvent (either package's)."""
    return [float(np.asarray(e.metrics[0]).reshape(-1)[0])
            for e in events if type(e).__name__ == "EndStepEvent"]


# ---------------------------------------------------------------------------
# The loop and its events
# ---------------------------------------------------------------------------

def test_events_and_their_order(tmp_path):
    log = str(tmp_path / "ev.jsonl")
    t = _trainer(str(tmp_path / "ck"), log=log, step_interval=2,
                 interval=2)
    seen = []
    t.train(num_epochs=2, reader=W.make_reader(3, nan_at=-1),
            event_handler=lambda e: seen.append(
                (type(e).__name__, e.epoch, getattr(e, "step", None))))
    t.stop()
    want = []
    for ep in range(2):
        want.append(("BeginEpochEvent", ep, None))
        for s in range(3):
            want += [("BeginStepEvent", ep, s), ("EndStepEvent", ep, s)]
        want.append(("EndEpochEvent", ep, None))
    assert seen == want
    kinds = [e["event"] for e in observe.read_events(log)]
    assert kinds[:2] == ["run_begin", "train_begin"]
    assert kinds[-2:] == ["train_end", "goodput_report"]
    # a save every 2 steps within each epoch, the window after step 2
    assert kinds.count("ckpt_save") == 2 and kinds.count("checkpoint") == 2
    assert kinds.index("telemetry") < kinds.index("ckpt_save")
    tel = [e for e in observe.read_events(log) if e["event"] == "telemetry"]
    # a window after the 2nd step of each epoch, the rest at the end
    assert [e["steps"] for e in tel] == [2, 3, 1]
    assert all(e["dispatches"] == e["steps"] for e in tel)
    assert all(e["retraces"] == 0 and e["peak_mem_bytes"] is None
               for e in tel)


def test_without_checkpoint_config():
    seen = []
    t = _trainer()
    t.train(num_epochs=1, reader=W.make_reader(12, nan_at=-1),
            event_handler=seen.append)
    losses = _losses(seen)
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert t._read_progress() is None


def test_mid_epoch_resume_skips_consumed_batches(tmp_path):
    class Stop(Exception):
        pass

    def crash(e):
        if isinstance(e, EndStepEvent) and e.step == 6:
            raise Stop

    # a clean reader: with the NaN batch, keep-last-1 would pin the
    # verified serial 0 and drop the newest (see the keep-last-k test)

    with pytest.raises(Stop):
        _trainer(str(tmp_path / "ck"), keep=1).train(
            num_epochs=1, reader=W.make_reader(nan_at=-1), event_handler=crash)
    t2 = _trainer(str(tmp_path / "ck"), keep=1)
    assert (t2._resume_epoch, t2._resume_step_in_epoch) == (0, 6)
    steps = []
    t2.train(num_epochs=1, reader=W.make_reader(nan_at=-1),
             event_handler=lambda e: steps.append(e.step)
             if isinstance(e, EndStepEvent) else None)
    assert steps == list(range(6, 12))
    # the whole epoch already done: a relaunch runs nothing
    t3 = _trainer(str(tmp_path / "ck"), keep=1)
    t3.train(num_epochs=1, reader=W.make_reader(nan_at=-1), event_handler=crash)
    with pytest.raises(RuntimeError, match="more batches"):
        _trainer(str(tmp_path / "ck"), keep=1).train(
            num_epochs=2, reader=W.make_reader(3, nan_at=-1))


def test_fallback_over_corrupt_newest_serial(tmp_path):
    ck = str(tmp_path / "ck")
    t = _trainer(ck, keep=3)
    t.train(num_epochs=1, reader=W.make_reader(9))
    assert t._list_checkpoints() == [0, 1, 2]
    chaos.corrupt_shard(os.path.join(ck, "ckpt_2"))
    log = str(tmp_path / "ev.jsonl")
    t2 = _trainer(ck, log=log, keep=3)
    assert (t2._resume_epoch, t2._resume_step_in_epoch) == (0, 6)
    ev = observe.read_events(log)
    fb = [e for e in ev if e["event"] == "ckpt_fallback"]
    assert fb[0]["serial"] == 2
    assert fb[0]["error"]["error"] == "checkpoint_corrupt"
    rs = [e for e in ev if e["event"] == "ckpt_resume"][0]
    assert rs["serial"] == 1 and rs["fallback"] is True


def test_keep_last_k_pins_the_newest_verified_serial(tmp_path):
    """The NaN batch (step 4) leaves every later save unverified (the
    window is never published): rotation keeps serial 0, the newest
    verified-good one, beside the newest."""
    ck = str(tmp_path / "ck")
    t = _trainer(ck, keep=2)
    t.train(num_epochs=1, reader=W.make_reader(12))
    assert t._list_checkpoints() == [0, 3]
    assert t._serial_verified(0) and not t._serial_verified(3)
    clean = _trainer(str(tmp_path / "clean"), keep=2)
    clean.train(num_epochs=1, reader=W.make_reader(12, nan_at=-1))
    assert clean._list_checkpoints() == [2, 3]


def test_torn_saves_are_never_listed(tmp_path):
    ck = str(tmp_path / "ck")
    t = _trainer(ck)
    t.train(num_epochs=1, reader=W.make_reader(3))
    chaos.arm("ckpt:before_manifest")
    with pytest.raises(chaos.ChaosKilled):
        t._save_checkpoint(1, 0, 5)       # dies between shards and manifest
    torn = os.path.join(ck, "ckpt_1")
    assert os.path.exists(os.path.join(torn, "shards_p0.npz"))
    t2 = _trainer(ck)
    assert t2._list_checkpoints() == [0]
    assert (t2._resume_epoch, t2._resume_step_in_epoch) == (0, 3)
    chaos.tear_checkpoint(os.path.join(ck, "ckpt_0"))
    assert _trainer(ck)._list_checkpoints() == []
    t2._save_checkpoint(1, 0, 3)          # a fresh save clears the tear
    assert sorted(os.listdir(torn)) == ["__shards__.json",
                                        "__trainer_state__.json",
                                        "shards_p0.crc.json",
                                        "shards_p0.npz"]


def _state_file(ck, serial=0):
    return os.path.join(ck, f"ckpt_{serial}", "__trainer_state__.json")


def _edit_state(ck, fn, serial=0):
    with open(_state_file(ck, serial)) as f:
        st = json.load(f)
    fn(st)
    with open(_state_file(ck, serial), "w") as f:
        json.dump(st, f)


def test_newer_train_state_version_rejected(tmp_path):
    ck = str(tmp_path / "ck")
    _trainer(ck).train(num_epochs=1, reader=W.make_reader(3))
    _edit_state(ck, lambda st: st["train_state"].update(
        version=TRAIN_STATE_VERSION + 1))
    t2 = _trainer(ck)          # skipped with a fallback: a fresh start
    assert (t2._resume_epoch, t2._resume_step_in_epoch) == (0, 0)
    with pytest.raises(errors.CheckpointFormatError):
        t2._load_checkpoint(os.path.join(ck, "ckpt_0"))


def test_name_drift_rejected_loudly(tmp_path):
    ck = str(tmp_path / "ck")
    _trainer(ck).train(num_epochs=1, reader=W.make_reader(3))

    def drift(st):
        st["train_state"]["unique_name_ids"]["fc"] += 7

    _edit_state(ck, drift)
    with pytest.raises(errors.CheckpointStateMismatchError) as ei:
        _trainer(ck)
    d = ei.value.as_dict()
    assert d["error"] == "checkpoint_state_mismatch"
    assert "fc" in d["drifted_keys"]


# ---------------------------------------------------------------------------
# Bit-exact resume in process, and the RNG rule
# ---------------------------------------------------------------------------

def test_in_process_resume_is_bit_for_bit(tmp_path):
    """A 6-batch reader ends the run right after the step-6 save (the
    simulated kill); a new Trainer resumes it and finishes the epoch:
    dropout's run counter, Adam's moments, the loss scale and its
    counters and the guard's skip all carried, every bit equal to an
    uninterrupted epoch."""
    control = _trainer()
    ctl_seen = []
    control.train(num_epochs=1, reader=W.make_reader(),
                  event_handler=ctl_seen.append)
    ck = str(tmp_path / "ck")
    killed = _trainer(ck, async_save=True)
    seen = []
    killed.train(num_epochs=1, reader=W.make_reader(6),
                 event_handler=seen.append)
    killed.stop()
    at_kill = _state(killed)
    # 16 -> 32 after 3 good steps, halved on the NaN, 1 good step since
    assert int(at_kill["tel/skipped_update_steps"]) == 1
    assert (float(at_kill["tel/loss_scale"]),
            int(at_kill["tel/ls_good_steps"])) == (16.0, 1)
    resumed = _trainer(ck)
    got = _state(resumed)
    _assert_equal_states(got, at_kill)           # restored before a step
    resumed.train(num_epochs=1, reader=W.make_reader(),
                  event_handler=seen.append)
    np.testing.assert_array_equal(_losses(seen), _losses(ctl_seen))
    _assert_equal_states(_state(resumed), _state(control))


def test_rng_rule(tmp_path):
    """A port checkpoint resumes its run counter exactly; a reference
    threefry key (uint32 words) resumes to the words read as one
    big-endian integer — the same checkpoint the same counter each time,
    never the key array itself."""
    ck = str(tmp_path / "ck")
    t = _trainer(ck)
    t.train(num_epochs=1, reader=W.make_reader(3))
    with open(_state_file(ck)) as f:
        rng = json.load(f)["train_state"]["rng_key"]
    assert rng == {"kind": "run_counter", "dtype": "int64", "data": 4}
    assert _trainer(ck).scope.find_var(RNG_STATE_VAR) == 4
    key = {"dtype": "uint32", "data": [3735928559, 42]}
    _edit_state(ck, lambda st: st["train_state"].update(rng_key=key))
    counters = [_trainer(ck).scope.find_var(RNG_STATE_VAR)
                for _ in range(2)]
    assert counters == [(3735928559 << 32) | 42] * 2
    assert type(counters[0]) is int
    assert rng_counter_from_state({"dtype": "uint32",
                                   "data": [[0, 7]]}) == 7
    assert rng_counter_from_state({"dtype": "uint32", "data": [0, 8]}) \
        != counters[0]
    t2 = _trainer(ck)                  # the stream continues from it
    t2.train(num_epochs=1, reader=W.make_reader(6))
    assert t2.scope.find_var(RNG_STATE_VAR) == counters[0] + 3


def test_host_reads_go_through_cpu(tmp_path, monkeypatch):
    """On a card np.asarray(tensor) raises TypeError: the save's state
    capture and verified-good check, and the resume's restore, must go
    through .cpu().  The resumed accumulator lives on the trainer's
    device in this build's dtypes."""
    def refuse(self, *a, **k):
        raise TypeError("can't convert a device tensor to numpy")

    monkeypatch.setattr(torch.Tensor, "__array__", refuse)
    ck = str(tmp_path / "ck")
    t = _trainer(ck, async_save=True)
    t.train(num_epochs=1, reader=W.make_reader(6))
    t.stop()
    t2 = _trainer(ck)
    tel = t2.scope.find_var(TELEMETRY_VAR)
    assert all(v.device == t2.exe.device for v in tel.values())
    assert tel["steps"].dtype == torch.int32
    assert tel["loss_scale"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Telemetry, feed admission, export, what is left out
# ---------------------------------------------------------------------------

def test_telemetry_windows_carry_nonfinite_provenance(tmp_path):
    log = str(tmp_path / "ev.jsonl")
    t = _trainer(log=log, interval=2, numerics=True)
    t.train(num_epochs=1, reader=W.make_reader(6))
    ev = observe.read_events(log)
    windows = [e for e in ev if e["event"] == "telemetry"]
    assert [e["step"] for e in windows] == [2, 4, 6]
    prov = [e for e in ev if e["event"] == "nonfinite_provenance"]
    assert len(prov) == 1 and prov[0]["step"] == 6
    assert prov[0]["skipped_update_steps"] == 1
    assert prov[0]["first_nonfinite_op"]["op_type"] == "mul"
    assert t.last_telemetry is not None


def test_validate_feed_quarantines_the_nan_batch(tmp_path):
    log = str(tmp_path / "ev.jsonl")
    t = _trainer(log=log, validate_feed=True)
    steps = []
    t.train(num_epochs=1, reader=W.make_reader(6),
            event_handler=lambda e: steps.append(e.step)
            if isinstance(e, EndStepEvent) else None)
    assert steps == [0, 1, 2, 3, 5]
    assert t.feed_stats["quarantined"] == 1
    q = [e for e in observe.read_events(log)
         if e["event"] == "feed_quarantined"]
    assert q[0]["step"] == 4
    assert q[0]["problems"][0]["problem"] == "nonfinite"
    tel = observe.fetch_telemetry(t.scope, reset=False)
    assert tel.skipped_update_steps == 0      # stopped at the door


def test_save_params_and_inference_model(tmp_path):
    t = _trainer()
    t.train(num_epochs=1, reader=W.make_reader(3, nan_at=-1))
    t.save_params(str(tmp_path / "params"))
    t.save_inference_model(str(tmp_path / "export"), ["x", "y"],
                           t.train_outputs)
    t.stop()
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    with pt.scope_guard(scope):
        prog, feeds, targets = pt.io.load_inference_model(
            str(tmp_path / "export"), exe)
    batch = next(iter(W.make_reader(1, nan_at=-1)()))
    got = exe.run(prog, feed=batch, fetch_list=targets, scope=scope)[0]
    want = exe.run(t.train_program.clone(for_test=True), feed=batch,
                   fetch_list=t.train_outputs, scope=t.scope)[0]
    np.testing.assert_array_equal(got, want)
    assert sorted(feeds) == ["x", "y"]


@pytest.mark.parametrize("kw,step", [
    ({"mesh": pt.parallel.make_mesh({"dp": 1})}, "step 10"),
    ({"build_strategy": pt.BuildStrategy()}, "step 10"),
    ({"autopilot": True}, "step 11"),
])
def test_left_out_options_raise(kw, step, tmp_path):
    """`autopilot=` (ROADMAP A step 11, ported) needs telemetry= and
    checkpoint_config=, as in the reference, and with them attaches a
    RecoveryController with the default ladder that the recovery family
    reports; `mesh=` (step 10, ported) compiles the train program over
    the mesh."""
    if step == "step 11":
        from paddle_tpu_torch.resilience import RecoveryController

        with pytest.raises(ValueError, match="telemetry"):
            Trainer(W.train_func, W.opt_func, place=pt.CPUPlace(), **kw)
        t = _trainer(str(tmp_path / "ck"), log=str(tmp_path / "ev.jsonl"),
                     **kw)
        assert isinstance(t.autopilot, RecoveryController)
        assert (t.autopilot.cfg.skip_streak,
                t.autopilot.cfg.max_rollbacks) == (2, 2)
        snap = t.metrics_registry().snapshot()
        assert snap["recovery_autopilot_enabled"]["samples"][0]["value"] \
            == 1
        t.stop()
        return
    t = Trainer(W.train_func, W.opt_func, place=pt.CPUPlace(), **kw)
    wrapper = getattr(t.train_program, "_compiled_wrapper", None)
    if "mesh" in kw:
        assert wrapper is not None and wrapper._mesh.shape == {"dp": 1}
    else:
        # a build strategy without a mesh is ignored, as in the reference
        assert wrapper is None
    t.stop()


@pytest.mark.parametrize("method", ["metrics_registry",
                                    "start_metrics_server",
                                    "enable_alerts"])
def test_left_out_planes_raise(method, tmp_path):
    """The metrics and alerts plane (ROADMAP A step 11's host half, now
    ported): each hook returns its working object, cached, and stop()
    closes what it started."""
    t = _trainer()
    if method == "enable_alerts":
        obj = t.enable_alerts(start=False, flight_dir=str(tmp_path))
        assert sorted(r.id for r in obj.rules) == sorted(
            r.id for r in observe.trainer_rule_pack())
        obj.evaluate()
        assert obj.evaluations == 1 and t.flight_recorder is not None
    elif method == "start_metrics_server":
        obj = t.start_metrics_server()
        with urllib.request.urlopen(obj.url + "/healthz", timeout=5) as r:
            health = json.loads(r.read())
        assert health["state"] == "training" and "ckpt" in health
    else:
        obj = t.metrics_registry()
        snap = obj.snapshot()
        assert snap["training_telemetry_windows"]["samples"][0]["value"] \
            == 0
        assert snap["recovery_autopilot_enabled"]["samples"][0]["value"] \
            == 0
        assert snap["ckpt_saves_total"]["samples"][0]["value"] == 0
        assert snap["goodput_available"]["samples"][0]["value"] == 1
    assert getattr(t, method)() is obj
    t.stop()


def test_default_place_is_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(W.train_func, W.opt_func)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Inferencer(_infer_func(pt), str(tmp_path))


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def _train_func(fluid):
    """torch_preempt_worker's model in either package, dropout 0."""
    def fn():
        layers = fluid.layers
        x = layers.data(name="x", shape=[6], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        h = layers.fc(x, size=16, act="relu")
        h = layers.dropout(h, dropout_prob=0.0)
        pred = layers.fc(h, size=1)
        d = layers.elementwise_sub(pred, y)
        return layers.mean(layers.elementwise_mul(d, d))

    return fn


def _opt_func(fluid):
    return lambda: fluid.amp.decorate(
        fluid.optimizer.Adam(learning_rate=LR),
        use_dynamic_loss_scaling=True, init_loss_scaling=16.0,
        incr_every_n_steps=3)


def _infer_func(fluid):
    def fn():
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        return fluid.layers.fc(h, size=1)

    return fn


def _ref_trainer(ck):
    """The reference's Trainer of the same job (saves every 3 steps)."""
    return jf.contrib.Trainer(
        _train_func(jf), _opt_func(jf),
        checkpoint_config=jf.contrib.CheckpointConfig(
            ck, step_interval=3, epoch_interval=10 ** 6),
        telemetry=jf.observe.TelemetryConfig(interval=100))


def test_reference_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    keep_reference_roundings(monkeypatch)
    ref_ck, port_ck = str(tmp_path / "ref"), str(tmp_path / "port")
    _ref_trainer(ref_ck).train(num_epochs=1, reader=W.make_reader(6))
    shutil.copytree(ref_ck, port_ck)
    ref = _ref_trainer(ref_ck)
    port = Trainer(_train_func(pt), _opt_func(pt), place=pt.CPUPlace(),
                   checkpoint_config=CheckpointConfig(
                       port_ck, step_interval=3, epoch_interval=10 ** 6),
                   telemetry=observe.TelemetryConfig(interval=100))
    assert (port._resume_epoch, port._resume_step_in_epoch) == (0, 6)
    seen = {"ref": [], "port": []}
    last = {}

    def handler(side, fluid, t):
        def h(e):
            seen[side].append(e)
            if type(e).__name__ == "EndStepEvent" and e.step == 11:
                # the window before train()'s closing fetch resets it
                last[side] = fluid.observe.fetch_telemetry(t.scope,
                                                           reset=False)
        return h

    ref.train(num_epochs=1, reader=W.make_reader(),
              event_handler=handler("ref", jf, ref))
    port.train(num_epochs=1, reader=W.make_reader(),
               event_handler=handler("port", pt, port))
    got, want = _losses(seen["port"]), _losses(seen["ref"])
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for p in port.train_program.all_parameters():
        a = port.scope.find_var(p.name).numpy()
        b = np.asarray(ref.scope.find_var(p.name))
        assert np.max(np.abs(a - b)) <= 1e-3, p.name
    jraw = ref.scope.find_var(jf.observe.TELEMETRY_VAR)
    praw = port.scope.find_var(TELEMETRY_VAR)
    for k in ("loss_scale", "ls_good_steps", "ls_bad_steps"):
        assert float(np.asarray(jraw[k])) == float(praw[k]), k
    j, p = last["ref"], last["port"]
    assert (p.steps, p.skipped_update_steps, p.nonfinite_grad_steps,
            p.loss_scale) == (j.steps, j.skipped_update_steps,
                              j.nonfinite_grad_steps, j.loss_scale)
    # the checkpointed window carried the NaN step; the scale moved
    assert (j.steps, j.skipped_update_steps) == (12, 1)
    assert j.loss_scale != 16.0


def test_inferencer_matches_the_reference(tmp_path):
    ref = _ref_trainer(str(tmp_path / "ck"))
    ref.train(num_epochs=1, reader=W.make_reader(6, nan_at=-1))
    params = str(tmp_path / "params")
    ref.save_params(params)
    x = np.random.RandomState(3).rand(5, 6).astype(np.float32)
    want = jf.contrib.Inferencer(_infer_func(jf), params).infer({"x": x})
    got = Inferencer(_infer_func(pt), params,
                     place=pt.CPUPlace()).infer({"x": x})
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0,
                               atol=1e-5)
