"""Preemption tolerance of the port's Trainer on the CPU: async
checkpoints, the drain, and crash chaos in real subprocesses.

In process (the model, optimizer and reader of
tests/torch_preempt_worker.py: dropout, Adam, dynamic loss scaling, a
NaN batch, a seeded shuffle):

- an async save stalls the step loop only for its snapshot: a slowed
  write (chaos delaypoint) lands in `write_ms`, not in the blocking
  time;
- a second save submitted while one is writing waits, never
  interleaves, and every listed serial loads with intact CRCs;
- a writer failure (failpoint between shards and manifest) surfaces as
  a structured CheckpointWriteError on the next save, and at the end of
  train(); the torn directory stays invisible;
- request_drain() writes the emergency checkpoint and raises
  TrainingPreempted with PREEMPT_EXIT_CODE; the SIGTERM handler sets
  the drain flag;
- the snapshot owns its memory: tensors written in place after the
  snapshot do not reach the files; the writer thread reads no tensor.

In subprocesses (tests/torch_preempt_worker.py; 2 epochs of 12 steps,
a save every 3): SIGKILL at three fixed points — before the first save
exists, while an async write is in flight (the writes slowed by
`--slow-write-ms`), after a save landed — and a SIGTERM drain (exit
PREEMPT_EXIT_CODE after `ckpt_emergency`), each relaunched: the final
persistables, the run counter and the telemetry accumulator equal an
uninterrupted run's bit for bit, and no torn directory is listed.  The
four chains and the control run at the same time, one module fixture.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import torch_preempt_worker as W
from paddle_tpu_torch import observe
from paddle_tpu_torch.contrib import CheckpointConfig, EndStepEvent, Trainer
from paddle_tpu_torch.resilience import (PREEMPT_EXIT_CODE, chaos, errors,
                                         preempt)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_preempt_worker.py")
STEPS_PER_EPOCH = W.BATCHES_PER_EPOCH
EPOCHS = 2


@pytest.fixture(autouse=True)
def _clear_chaos_and_drain():
    yield
    chaos.clear()
    preempt.clear_drain()
    preempt.uninstall_preempt_handler()


def _trainer(ckpt_dir, log=None, async_save=True, step_interval=3):
    tel = (observe.TelemetryConfig(interval=100, log_path=log)
           if log else None)
    return Trainer(W.train_func, W.opt_func, place=pt.CPUPlace(),
                   checkpoint_config=CheckpointConfig(
                       ckpt_dir, step_interval=step_interval,
                       epoch_interval=10 ** 6, async_save=async_save),
                   telemetry=tel)


# ---------------------------------------------------------------------------
# Async checkpointing
# ---------------------------------------------------------------------------

def test_async_save_blocks_only_for_snapshot(tmp_path):
    log = str(tmp_path / "ev.jsonl")
    t = _trainer(str(tmp_path / "ck"), log=log)
    chaos.arm_delay("ckpt:write", 0.5, times=10 ** 6)
    t.train(num_epochs=1, reader=W.make_reader(6))  # 2 saves @ interval 3
    t.stop()
    saves = [e for e in observe.read_events(log)
             if e["event"] == "ckpt_save"]
    assert len(saves) == 2
    for e in saves:
        assert e["asynchronous"] is True
        assert e["write_ms"] >= 500, e    # the injected stall landed...
        assert e["snapshot_ms"] < 500, e  # ...in the write phase only
        assert e["bytes"] > 0
    # the loop paid the snapshots and one wait for the first write, not
    # the two 0.5 s writes back to back
    assert t.ckpt_stats["saves"] == 2
    assert t.ckpt_stats["blocking_ms"] < 1000.0, t.ckpt_stats
    assert t.ckpt_stats["write_ms"] >= 1000.0, t.ckpt_stats
    t2 = _trainer(str(tmp_path / "ck"))
    assert (t2._resume_epoch, t2._resume_step_in_epoch) == (0, 6)


def test_async_second_save_waits_never_corrupts(tmp_path):
    t = _trainer(str(tmp_path / "ck"))
    chaos.arm_delay("ckpt:write", 0.2, times=10 ** 6)
    t.train(num_epochs=1, reader=W.make_reader(12))  # 4 saves
    t.stop()
    ids = t._list_checkpoints()
    assert len(ids) >= 2
    t2 = _trainer(str(tmp_path / "ck"))
    for serial in ids:
        path = str(tmp_path / "ck" / f"ckpt_{serial}")
        assert os.path.exists(os.path.join(path, pt.io.SHARD_MANIFEST))
        assert t2._load_checkpoint(path)["serial"] == serial


def test_async_writer_failure_surfaces_on_next_save(tmp_path):
    t = _trainer(str(tmp_path / "ck"))
    t.train(num_epochs=1, reader=W.make_reader(3))  # serial 0 lands clean
    chaos.arm("ckpt:before_manifest")
    t._save_checkpoint(1, 0, 99)                    # background write dies
    t._pending_save._done.wait(30)
    with pytest.raises(errors.CheckpointWriteError) as ei:
        t._save_checkpoint(2, 0, 100)
    d = ei.value.as_dict()
    assert d["error"] == "checkpoint_write_failed"
    assert "ckpt:before_manifest" in str(d)
    torn = tmp_path / "ck" / "ckpt_1"
    assert torn.is_dir() and not (torn / pt.io.SHARD_MANIFEST).exists()
    assert 1 not in _trainer(str(tmp_path / "ck"))._list_checkpoints()


def test_trainer_train_end_surfaces_writer_failure(tmp_path):
    t = _trainer(str(tmp_path / "ck"))
    chaos.arm("ckpt:before_manifest")
    with pytest.raises(errors.CheckpointWriteError):
        t.train(num_epochs=1, reader=W.make_reader(3))


def test_snapshot_owns_its_memory(tmp_path):
    """On the CPU a tensor's numpy view aliases its storage: a
    parameter written in place after the snapshot must not reach the
    files of a save whose write is still in flight."""
    t = _trainer(str(tmp_path / "ck"))
    t.train(num_epochs=1, reader=W.make_reader(2))
    before = {n: t.scope.find_var(n).clone() for n in t.scope.vars
              if isinstance(t.scope.find_var(n), torch.Tensor)}
    chaos.arm_delay("ckpt:write", 0.3)
    t._save_checkpoint(0, 0, 2)                     # snapshot taken here
    for v in before:
        t.scope.find_var(v).add_(1.0)               # in place, mid-write
    t._await_pending(surface=True)
    with np.load(tmp_path / "ck" / "ckpt_0" / "shards_p0.npz") as z:
        for name, want in before.items():
            if f"{name}::0" in z.files:
                np.testing.assert_array_equal(z[f"{name}::0"],
                                              want.numpy(), err_msg=name)
    assert len(before) > 10


def test_writer_thread_reads_no_tensor(tmp_path, monkeypatch):
    """_finalize runs on the writer thread: it must read no tensor (on
    a card that would be a CUDA call off the training thread)."""
    reads = []
    for m in ("cpu", "numpy", "item", "tolist", "__array__"):
        orig = getattr(torch.Tensor, m)

        def spy(self, *a, _orig=orig, _m=m, **k):
            reads.append((threading.current_thread().name, _m))
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, m, spy)
    t = _trainer(str(tmp_path / "ck"), log=str(tmp_path / "ev.jsonl"))
    chaos.arm_delay("ckpt:write", 0.05, times=10 ** 6)
    t.train(num_epochs=1, reader=W.make_reader(6))
    t.stop()
    assert t.ckpt_stats["saves"] == 2
    assert reads and not [r for r in reads if r[0] == "ckpt-writer"]


# ---------------------------------------------------------------------------
# Drain (in process)
# ---------------------------------------------------------------------------

def test_request_drain_writes_emergency_ckpt_and_raises(tmp_path):
    log = str(tmp_path / "ev.jsonl")
    t = _trainer(str(tmp_path / "ck"), log=log)

    def handler(e):
        if isinstance(e, EndStepEvent) and e.step == 3:
            preempt.request_drain("test-preemption")

    with pytest.raises(errors.TrainingPreempted) as ei:
        t.train(num_epochs=1, reader=W.make_reader(12),
                event_handler=handler)
    assert ei.value.exit_code == PREEMPT_EXIT_CODE
    d = ei.value.as_dict()
    assert d["reason"] == "test-preemption"
    assert (d["epoch"], d["step"]) == (0, 4)  # the in-flight step finished
    events = observe.read_events(log)
    kinds = [e["event"] for e in events]
    assert kinds.index("preempt_drain") < kinds.index("ckpt_emergency")
    em = [e for e in events if e["event"] == "ckpt_emergency"][-1]
    assert em["serial"] == d["serial"]
    saves = [e for e in events if e["event"] == "ckpt_save"]
    assert saves[-1]["emergency"] is True
    assert saves[-1]["asynchronous"] is False
    assert not preempt.drain_requested()      # consumed by the drain
    t2 = _trainer(str(tmp_path / "ck"), log=log)
    assert (t2._resume_epoch, t2._resume_step_in_epoch) == (0, 4)
    t2.train(num_epochs=1, reader=W.make_reader(12))  # no re-drain
    t2.stop()


def test_sigterm_handler_sets_drain_flag():
    assert preempt.install_preempt_handler()   # pytest's main thread
    assert not preempt.drain_requested()
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.monotonic() + 5
    while not preempt.drain_requested():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert preempt.drain_reason() == "signal:SIGTERM"


# ---------------------------------------------------------------------------
# Crash chaos in subprocesses
# ---------------------------------------------------------------------------

def _cmd(d, tag, slow_write_ms=0.0, step_ms=0.0):
    return [sys.executable, WORKER, "--ckpt", os.path.join(d, "ck"),
            "--out", os.path.join(d, f"{tag}.npz"),
            "--log", os.path.join(d, "ev.jsonl"), "--epochs", str(EPOCHS),
            "--slow-write-ms", str(slow_write_ms), "--step-ms",
            str(step_ms)]


def _run_to_done(d, tag):
    with open(os.path.join(d, f"{tag}.stderr"), "w") as err:
        r = subprocess.run(_cmd(d, tag), stdout=subprocess.PIPE,
                           stderr=err, text=True, timeout=240)
    return {"rc": r.returncode, "stdout": r.stdout}


def _global(line):
    _, e, s = line.split()
    return int(e) * STEPS_PER_EPOCH + int(s) + 1   # steps done


def _victim(d, sig, at_step, wait_for=None, slow_write_ms=0.0):
    """Launch a paced worker, send `sig` once `at_step` steps are done
    and the path `wait_for` (relative to the checkpoint root) exists."""
    err = open(os.path.join(d, "victim.stderr"), "w")
    p = subprocess.Popen(_cmd(d, "victim", slow_write_ms, step_ms=40.0),
                         stdout=subprocess.PIPE, stderr=err, text=True)
    lines = []
    try:
        for line in p.stdout:
            lines.append(line)
            if line.startswith("STEP ") and _global(line) >= at_step:
                break
        if wait_for is not None:
            target = os.path.join(d, "ck", wait_for)
            deadline = time.monotonic() + 60
            while not os.path.exists(target):
                assert time.monotonic() < deadline, (wait_for, lines)
                time.sleep(0.005)
            time.sleep(0.2)   # the save's submit is done; its write not
        p.send_signal(sig)
        rest = p.stdout.read()
        rc = p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
        err.close()
    return {"rc": rc, "stdout": "".join(lines) + (rest or "")}


def _listed_torn(ckpt):
    """(listed serials, torn directories); a listed serial must carry
    its manifest (the trainer state is written strictly last)."""
    if not os.path.isdir(ckpt):
        return [], []
    listed, torn = [], []
    for name in sorted(os.listdir(ckpt)):
        path = os.path.join(ckpt, name)
        if not (name.startswith("ckpt_") and os.path.isdir(path)):
            continue
        if os.path.exists(os.path.join(path, "__trainer_state__.json")):
            assert os.path.exists(os.path.join(path, pt.io.SHARD_MANIFEST))
            listed.append(int(name.split("_")[1]))
        else:
            torn.append(name)
    return listed, torn


# (name, signal, steps done before the signal, path that must exist,
#  slowed writes): the fixed kill points
CHAINS = {
    "before_first_save": (signal.SIGKILL, 2, None, 0.0),
    "write_in_flight": (signal.SIGKILL, 6, "ckpt_1", 3000.0),
    "after_save_landed": (signal.SIGKILL, 7,
                          os.path.join("ckpt_1", "__trainer_state__.json"),
                          0.0),
    "sigterm_drain": (signal.SIGTERM, 8, None, 0.0),
}


def _chain(d, name):
    sig, at, wait_for, slow = CHAINS[name]
    os.makedirs(d)
    res = {"victim": _victim(d, sig, at, wait_for, slow)}
    res["after_victim"] = _listed_torn(os.path.join(d, "ck"))
    res["relaunch"] = _run_to_done(d, "relaunch")
    res["after_relaunch"] = _listed_torn(os.path.join(d, "ck"))
    res["events"] = observe.read_events(os.path.join(d, "ev.jsonl"))
    return res


@pytest.fixture(scope="module")
def chaos_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_chaos"))
    results, failures = {}, {}

    def run(name, fn):
        try:
            results[name] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failures[name] = e

    os.makedirs(os.path.join(root, "control"))
    jobs = {"control": lambda: _run_to_done(os.path.join(root, "control"),
                                            "control")}
    for name in CHAINS:
        jobs[name] = (lambda n=name: _chain(os.path.join(root, n), n))
    threads = [threading.Thread(target=run, args=(n, f))
               for n, f in jobs.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
        assert not th.is_alive()
    if failures:
        raise next(iter(failures.values()))
    results["root"] = root
    return results


def _assert_same_final_state(root, name):
    want = np.load(os.path.join(root, "control", "control.npz"))
    got = np.load(os.path.join(root, name, "relaunch.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), \
            f"{k} not bit-identical after {name}"
    # the run carried non-trivial state: a skipped step, a moved scale
    assert float(want["__telemetry__/loss_scale"]) != 16.0
    assert int(want["__rng_key__"]) == 1 + EPOCHS * STEPS_PER_EPOCH


@pytest.mark.parametrize("name", list(CHAINS))
def test_kill_and_resume_is_bit_identical(chaos_runs, name):
    root, res = chaos_runs["root"], chaos_runs[name]
    assert chaos_runs["control"]["rc"] == 0
    sig = CHAINS[name][0]
    victim = res["victim"]
    assert "DONE" not in victim["stdout"]          # it died mid-run
    listed, torn = res["after_victim"]
    if sig == signal.SIGKILL:
        assert victim["rc"] == -signal.SIGKILL, victim
    else:
        assert victim["rc"] == PREEMPT_EXIT_CODE, victim
        assert "PREEMPTED" in victim["stdout"]
        kinds = [e["event"] for e in res["events"]]
        assert kinds.index("preempt_drain") < kinds.index("ckpt_emergency")
        drain = [e for e in res["events"] if e["event"] == "preempt_drain"]
        assert drain[0]["reason"] == "signal:SIGTERM"
        emergency = [e for e in res["events"]
                     if e["event"] == "ckpt_emergency"][0]
        assert emergency["serial"] == max(listed)
    if name == "before_first_save":
        assert listed == []
    elif name == "write_in_flight":
        # serial 0 landed, serial 1 was being written: torn, unlisted,
        # and its shard file never got written
        assert listed == [0] and torn == ["ckpt_1"], (listed, torn)
        assert not os.path.exists(os.path.join(root, name, "ck", "ckpt_1",
                                               "shards_p0.npz"))
    else:
        assert 1 in listed
    assert res["relaunch"]["rc"] == 0 and "DONE" in res["relaunch"]["stdout"]
    resumes = [e for e in res["events"] if e["event"] == "ckpt_resume"]
    assert bool(resumes) == bool(listed)
    _assert_same_final_state(root, name)
    assert res["after_relaunch"][1] == []     # a resumed save clears torn


def test_relaunch_counts_replayed_steps(chaos_runs):
    """The relaunch after the in-flight kill resumes from serial 0 (3
    steps) while the dead process got further: those steps are replay
    badput in its goodput report."""
    events = chaos_runs["write_in_flight"]["events"]
    report = [e for e in events if e["event"] == "goodput_report"][-1]
    assert report["replay_steps"] >= 3
    assert report["replay"]["from"] == [0, 3]
    cats = report["categories_s"]
    assert abs(sum(cats.values()) - report["wall_s"]) < 1e-4
    print(json.dumps({k: chaos_runs[k]["victim"]["rc"] for k in CHAINS}))
