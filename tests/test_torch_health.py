"""The port's gang health plane (paddle_tpu_torch/resilience/health.py)
and the checkpoint barrier's poison path, on the CPU, against the
reference (paddle_tpu/resilience/health.py, tests/test_gang.py's unit
tests).

- The monitor scenarios run the reference's HealthMonitor on its FakeKv
  (jax's coordination-KV surface) and the port's on its own (the
  TCPStore surface), with the same injected clock script: at every poll
  the latched alarm's kind, its missing/stalled ranks, its ages and
  budget are equal — exactly: both compute them from the same floats —
  and so is the final `skew()` dict.  Only the messages and the store
  error text differ (C24).
- Heartbeat publish and beat, the poison round trip (one raise per
  payload), the peer_lost/gang_skew/rank_slow events, the barrier's
  poison fast path and its timeout naming the missing ranks.
- On a real TCPStore: a rank whose main thread sits in a long barrier
  wait keeps heartbeating (its plane talks over connections of its own)
  while a heartbeat sharing that client is declared lost, and a store
  whose host process died turns into the coordinator-loss alarm naming
  `DistNetworkError`.
- The Trainer's plane hooks: the same kernel calls and host reads with
  the plane on as off, a poisoned gang aborting train() once, the
  watchdog's hang verdict poisoning the gang, and goodput's skew.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

import paddle_tpu_torch as pt
from paddle_tpu.resilience import FakeKv as RefKv
from paddle_tpu.resilience import HealthConfig as RefConfig
from paddle_tpu.resilience import health as ref_health
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch import observe
from paddle_tpu_torch.contrib import Trainer
from paddle_tpu_torch.resilience import (CheckpointBarrierPoisonedError,
                                         FakeKv, GangPoisonedError,
                                         HealthConfig, HealthPlane,
                                         PeerLostError, PeerStalledError,
                                         StepHangError, chaos, health)

import torch_preempt_worker as W

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _teardown():
    yield
    chaos.clear()
    health.stop_health_plane()


def _beat(kv, rank, step, t):
    kv.set(health.HB_DIR + str(rank), json.dumps(
        {"rank": rank, "step": step, "wall_time": t, "pid": 1, "seq": t}))


def _ref_beat(kv, rank, step, t):
    kv.key_value_set(ref_health.HB_DIR + str(rank), json.dumps(
        {"rank": rank, "step": step, "wall_time": t, "pid": 1,
         "seq": t}), allow_overwrite=True)


# ---------------------------------------------------------------------------
# The monitor against the reference's, on one clock script
# ---------------------------------------------------------------------------

# (monitor rank, ranks, config, script); a script entry is
# (time, [actions]) and a poll follows each entry.  Actions: ("beat",
# rank, step), ("fail",) — every store call raises from then on —
# ("done", rank).
SCENARIOS = {
    "lost_within_budget": (0, 2, dict(interval_s=1.0, miss_budget=3,
                                      startup_grace_s=100.0), [
        (0.0, [("beat", 1, 0)]), (2.9, []), (3.1, [])]),
    "startup_grace": (0, 2, dict(interval_s=1.0, miss_budget=2,
                                 startup_grace_s=5.0), [
        (0.0, []), (4.9, []), (5.1, [])]),
    "stalled": (0, 2, dict(interval_s=1.0, miss_budget=100,
                           stall_timeout_s=3.0, startup_grace_s=100.0), [
        (0.0, [("beat", 1, 5)]), (1.0, [("beat", 1, 5)]),
        (2.0, [("beat", 1, 5)]), (3.5, [("beat", 1, 5)])]),
    "coordinator_loss": (1, 2, dict(interval_s=0.5, miss_budget=4), [
        (0.0, []), (0.5, [("fail",)]), (1.0, []), (2.6, [])]),
    "departed": (0, 2, dict(interval_s=1.0, miss_budget=2,
                            startup_grace_s=100.0), [
        (0.0, [("beat", 1, 9)]), (50.0, [("done", 1)])]),
    "skew": (0, 3, dict(interval_s=1.0, miss_budget=100,
                        startup_grace_s=100.0, skew_report_every=4,
                        slow_factor=2.0), [
        (float(t), [("beat", 0, 10 * t), ("beat", 1, 2 * t),
                    ("beat", 2, 9 * t)]) for t in range(5)]),
}


def _alarm_view(alarm):
    if alarm is None:
        return None
    d = alarm.as_dict()
    return {k: d.get(k) for k in ("error", "missing_ranks",
                                  "stalled_ranks", "steps", "age_s",
                                  "budget_s", "stall_timeout_s")}


def _run_scenario(name, port):
    rank, n, cfg_kw, script = SCENARIOS[name]
    clk = [0.0]
    if port:
        kv = FakeKv()
        mon = health.HealthMonitor(kv, rank, n, HealthConfig(**cfg_kw),
                                   clock=lambda: clk[0])
    else:
        kv = RefKv()
        mon = ref_health.HealthMonitor(kv, rank, n, RefConfig(**cfg_kw),
                                       clock=lambda: clk[0])
    seen = []
    for t, actions in script:
        clk[0] = t
        for a in actions:
            if a[0] == "beat":
                (_beat if port else _ref_beat)(kv, a[1], a[2], t)
            elif a[0] == "fail":
                kv.fail_with = (dist.DistNetworkError("Broken pipe")
                                if port else
                                RuntimeError("UNAVAILABLE: closed"))
            elif port:
                kv.set(health.DONE_DIR + str(a[1]), "{}")
            else:
                kv.key_value_set(ref_health.DONE_DIR + str(a[1]), "{}")
        seen.append((t, _alarm_view(mon.poll_once())))
    return seen, mon.skew(), sorted(mon.done_ranks), mon


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_monitor_matches_reference(name):
    """Same clock script, same verdicts: the alarm (kind, ranks, ages,
    budget) at every poll, the skew dict and the departed ranks equal
    the reference's (exact)."""
    got, got_skew, got_done, mon = _run_scenario(name, port=True)
    want, want_skew, want_done, _ = _run_scenario(name, port=False)
    assert got == want
    assert got_skew == want_skew and got_done == want_done
    kinds = {"lost_within_budget": "peer_lost", "startup_grace":
             "peer_lost", "stalled": "peer_stalled", "coordinator_loss":
             "peer_lost", "departed": None, "skew": None}
    final = got[-1][1]
    assert (final["error"] if final else None) == kinds[name]
    if name == "coordinator_loss":
        assert mon.alarm().details["missing_ranks"] == [0]
        assert mon.alarm().details["kv_error"].startswith(
            "DistNetworkError")
    if name == "skew":
        assert got_skew["slow_ranks"] == [1]
        assert got_skew["max_lag_steps"] == 32


def test_health_config_defaults_are_the_reference_flags():
    """The port's HealthConfig and Supervisor default to its FLAGS,
    whose defaults are the reference's."""
    from paddle_tpu.flags import FLAGS
    from paddle_tpu_torch.resilience import supervisor

    c = HealthConfig()
    assert (c.interval_s, c.miss_budget, c.stall_timeout_s,
            c.poll_interval_s, c.startup_grace_s) == (
        FLAGS.heartbeat_interval_s, FLAGS.heartbeat_miss_budget,
        FLAGS.gang_stall_timeout_s, 1.0, 5.0)
    sup = supervisor.Supervisor(["true"], 1)
    assert (sup.grace_s, sup.max_restarts, sup.backoff_base_s,
            sup.backoff_max_s) == (
        FLAGS.supervisor_grace_s, FLAGS.supervisor_max_restarts,
        FLAGS.supervisor_backoff_base_s, FLAGS.supervisor_backoff_max_s)
    with pytest.raises(ValueError):
        HealthConfig(interval_s=0)
    with pytest.raises(ValueError):
        HealthConfig(miss_budget=0)


# ---------------------------------------------------------------------------
# Heartbeat, poison, events
# ---------------------------------------------------------------------------

def test_heartbeat_publishes_and_beat_updates_step():
    kv = FakeKv()
    hb = health.Heartbeat(kv, rank=3, config=HealthConfig(
        interval_s=1.0, miss_budget=5), clock=lambda: 42.0)
    assert hb.publish_once()
    hb.beat(17)
    assert hb.publish_once()
    payload = json.loads(kv.get(health.HB_DIR + "3"))
    assert payload["rank"] == 3 and payload["step"] == 17
    assert payload["wall_time"] == 42.0 and payload["seq"] == 2
    kv.fail_with = dist.DistNetworkError("Broken pipe")
    assert not hb.publish_once() and hb.publish_failures == 1


def test_peer_lost_writes_poison_and_event(tmp_path):
    """The loss verdict poisons the gang first and emits peer_lost."""
    log = observe.RunEventLog(str(tmp_path / "ev.jsonl"))
    kv = FakeKv()
    clk = [0.0]
    m = health.HealthMonitor(kv, 0, 2, HealthConfig(
        interval_s=1.0, miss_budget=3, startup_grace_s=100.0),
        clock=lambda: clk[0], event_log=log)
    _beat(kv, 1, 0, 0.0)
    m.poll_once()
    clk[0] = 3.1
    assert isinstance(m.poll_once(), PeerLostError)
    assert m.alarm_wall_time is not None
    poison = health.read_poison(kv)
    assert poison["kind"] == "peer_lost" and poison["missing_ranks"] == [1]
    log.close()
    assert "peer_lost" in [e["event"] for e in observe.read_events(log.path)]


def test_poison_roundtrip_and_plane_consumption_idempotent():
    """write/read/clear poison; check() raises each poison id once and
    the plane's own poison is born consumed."""
    kv = FakeKv()
    assert health.read_poison(kv) is None
    plane = HealthPlane(kv, 0, 2, config=HealthConfig(
        interval_s=1000.0, miss_budget=5, startup_grace_s=10 ** 9))
    p = plane.poison("own abort", kind="step_hang")
    plane.monitor.poll_once()
    plane.check()
    p2 = health.write_poison(kv, rank=1, reason="peer abort")
    assert p2["id"] != p["id"]
    plane.monitor.poll_once()
    with pytest.raises(GangPoisonedError) as ei:
        plane.check()
    assert ei.value.details["poison"]["reason"] == "peer abort"
    plane.monitor.poll_once()
    plane.check()  # consumed: idempotent
    health.clear_poison(kv)
    assert health.read_poison(kv) is None
    kv.set(health.POISON_KEY, "not json")
    assert health.read_poison(kv)["id"] == "unparseable"


def test_skew_events_and_rank_slow(tmp_path):
    log = observe.RunEventLog(str(tmp_path / "ev.jsonl"))
    kv = FakeKv()
    clk = [0.0]
    m = health.HealthMonitor(kv, 0, 2, HealthConfig(
        interval_s=1.0, miss_budget=100, startup_grace_s=100.0,
        skew_report_every=4, slow_factor=2.0), clock=lambda: clk[0],
        event_log=log)
    for t, (s0, s1) in enumerate([(0, 0), (10, 2), (20, 4), (30, 6)]):
        clk[0] = float(t)
        _beat(kv, 0, s0, float(t))
        _beat(kv, 1, s1, float(t))
        m.poll_once()
    assert m.skew()["rates"] == {0: 10.0, 1: 2.0}
    log.close()
    events = observe.read_events(log.path)
    slow = [e for e in events if e["event"] == "rank_slow"][-1]
    assert slow["rank"] == 1 and slow["median_rate"] == 10.0
    assert "gang_skew" in [e["event"] for e in events]


def test_wait_gang_done_and_leave():
    kv = FakeKv()
    planes = [HealthPlane(kv, r, 2, config=HealthConfig(
        interval_s=1000.0, startup_grace_s=10 ** 9)) for r in range(2)]
    assert not planes[0].wait_gang_done(timeout_s=0.1, poll_s=0.02)
    for p in planes:
        p.leave()
    # trainer 0 (the store's default host) returns only once every rank
    # has seen all done markers
    assert not planes[0].wait_gang_done(timeout_s=0.2, poll_s=0.02)
    assert planes[1].wait_gang_done(timeout_s=1.0, poll_s=0.02)
    assert planes[0].wait_gang_done(timeout_s=1.0, poll_s=0.02)
    kv.fail_with = dist.DistNetworkError("Broken pipe")
    assert not planes[1].wait_gang_done(timeout_s=0.3, poll_s=0.02)
    planes[1].monitor._latch(PeerLostError("store gone",
                                           missing_ranks=[0]))
    t0 = time.monotonic()
    assert not planes[1].wait_gang_done(timeout_s=30.0, poll_s=0.02)
    assert time.monotonic() - t0 < 1.0


# ---------------------------------------------------------------------------
# The checkpoint barrier's poison path
# ---------------------------------------------------------------------------

def test_wait_barrier_peers_aborts_on_poison_fast():
    kv = FakeKv()
    t0 = time.monotonic()

    def poison_later():
        time.sleep(0.25)
        health.write_poison(kv, rank=1, reason="peer declared dead",
                            kind="peer_lost", missing_ranks=[1])

    threading.Thread(target=poison_later).start()
    with pytest.raises(CheckpointBarrierPoisonedError) as ei:
        pt_io._wait_barrier_peers(kv, "bar/t/0/", [1], "t",
                                  timeout_s=30.0, poison_poll_s=0.05)
    assert time.monotonic() - t0 < 5.0
    d = ei.value.as_dict()
    assert d["error"] == "checkpoint_barrier_poisoned"
    assert d["poison"]["reason"] == "peer declared dead"
    assert d["missing_ranks"] == [1]


def test_wait_barrier_peers_timeout_names_missing():
    kv = FakeKv()
    kv.set("bar/t/0/2", "ok")  # rank 2 arrived, 1 never
    assert pt_io._wait_barrier_peers(kv, "bar/t/0/", [1, 2], "t",
                                     timeout_s=0.3,
                                     poison_poll_s=0.05) == [1]


def test_barrier_aborts_on_the_local_alarm():
    """The local monitor's latched alarm aborts the wait even when the
    store (and so the poison key) is gone."""
    kv = FakeKv()
    plane = health.start_health_plane(rank=0, num_ranks=2, kv=kv,
                                      config=HealthConfig(
                                          interval_s=1000.0,
                                          startup_grace_s=10 ** 9))
    plane.monitor._latch(PeerLostError("rank 1 lost", missing_ranks=[1]))
    kv.fail_with = dist.DistNetworkError("Broken pipe")
    with pytest.raises(CheckpointBarrierPoisonedError) as ei:
        pt_io._wait_barrier_peers(kv, "bar/t/0/", [1], "t",
                                  timeout_s=30.0, poison_poll_s=0.05)
    assert ei.value.details["missing_ranks"] == [1]


# ---------------------------------------------------------------------------
# A real TCPStore
# ---------------------------------------------------------------------------

def _master():
    return dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                         wait_for_workers=False)


def _client(port, timeout_s=30.0):
    return dist.TCPStore("127.0.0.1", port, is_master=False,
                         timeout=timedelta(seconds=timeout_s))


def test_long_barrier_wait_is_no_false_loss():
    """Rank 0's main thread sits 3 s in a barrier wait on its store
    client while rank 1's monitor runs (a 0.6 s miss window): rank 0's
    plane publishes over its own connection and is never declared lost.
    A heartbeat that shares the waiting client is (the control)."""
    master = _master()
    cfg = HealthConfig(interval_s=0.1, miss_budget=6, poll_interval_s=0.05,
                       startup_grace_s=5.0)
    store0, store1 = _client(master.port), _client(master.port)
    plane0 = HealthPlane(store0, 0, 2, config=cfg).start()
    plane1 = HealthPlane(store1, 1, 2, config=cfg).start()
    shared = health.Heartbeat(store0, 2, cfg)  # on the waiting client
    shared_mon = health.HealthMonitor(health.connection(store1), 1, 3, cfg)
    shared_mon.written_poison_id = "control"  # it writes no poison
    shared.start()
    stop = threading.Event()

    def poll_shared():
        while not stop.is_set():
            shared_mon.poll_once()
            time.sleep(0.05)

    th = threading.Thread(target=poll_shared, daemon=True)
    try:
        time.sleep(0.3)
        th.start()
        t0 = time.monotonic()
        assert pt_io._wait_barrier_peers(store0, "bar/x/0/", [1], "x",
                                         timeout_s=3.0,
                                         poison_poll_s=3.0) == [1]
        assert time.monotonic() - t0 >= 2.9
        stop.set()
        th.join(timeout=5)
        plane1.check()  # no false loss of rank 0
        assert plane1.monitor.alarm() is None
        assert isinstance(shared_mon.alarm(), PeerLostError)
        assert shared_mon.alarm().details["missing_ranks"] == [2]
    finally:
        stop.set()
        shared.stop()
        plane0.stop()
        plane1.stop()


def test_dead_store_host_is_coordinator_loss():
    """The process serving the store dies: every call then raises
    DistNetworkError, and after a miss window the monitor latches the
    coordinator-loss alarm."""
    code = ("import sys, time, torch.distributed as d\n"
            "s = d.TCPStore('127.0.0.1', 0, 1, is_master=True, "
            "wait_for_workers=False)\n"
            "print(s.port, flush=True)\n"
            "time.sleep(60)\n")
    host = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    try:
        store = _client(int(host.stdout.readline()))
        cfg = HealthConfig(interval_s=0.1, miss_budget=3,
                           poll_interval_s=0.05, startup_grace_s=5.0)
        plane = HealthPlane(store, 1, 2, config=cfg).start()
        time.sleep(0.2)
        host.kill()
        host.wait()
        deadline = time.monotonic() + 5.0
        while plane.monitor.alarm() is None and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        with pytest.raises(PeerLostError) as ei:
            plane.check()
        assert ei.value.details["missing_ranks"] == [0]
        assert ei.value.details["kv_error"].startswith("DistNetworkError")
        plane.stop()
    finally:
        if host.poll() is None:
            host.kill()
            host.wait()


# ---------------------------------------------------------------------------
# The Trainer's plane hooks
# ---------------------------------------------------------------------------

def _quiet():
    return HealthConfig(interval_s=1000.0, miss_budget=5,
                        startup_grace_s=10 ** 9)


def _counted_run(monkeypatch, trainer, reader):
    """train() with every tensor read to the host counted, and the
    kernel calls and executor dispatches it made."""
    from paddle_tpu_torch.observe import runtime_stats
    from paddle_tpu_torch.ops import kernels

    reads = {"n": 0}
    for name in ("cpu", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **kw):
            reads["n"] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    kernels.reset_counts()
    snap = runtime_stats.snapshot()
    trainer.train(num_epochs=1, reader=reader)
    delta = runtime_stats.delta(snap)
    monkeypatch.undo()
    return reads["n"], kernels.counts(), delta["dispatches"]


def test_plane_adds_no_kernel_call_or_host_read(monkeypatch):
    """With the plane on, train() makes the same kernel calls, the same
    dispatches and the same tensor reads to the host as with it off,
    and the heartbeat counter advanced host-side."""
    off = _counted_run(monkeypatch, Trainer(
        W.train_func, W.opt_func, place=pt.CPUPlace()),
        W.make_reader(6, nan_at=-1))
    plane = health.start_health_plane(rank=0, num_ranks=2, kv=FakeKv(),
                                      config=_quiet())
    on = _counted_run(monkeypatch, Trainer(
        W.train_func, W.opt_func, place=pt.CPUPlace()),
        W.make_reader(6, nan_at=-1))
    assert on == off and off[0] > 0 and off[2] == 6
    assert plane.heartbeat._step == 6


def test_trainer_poison_aborts_and_retrain_is_idempotent(tmp_path):
    plane = health.start_health_plane(rank=0, num_ranks=2, kv=FakeKv(),
                                      config=_quiet())
    health.write_poison(plane.kv, rank=1, reason="peer watchdog fired",
                        kind="step_hang")
    plane.monitor.poll_once()
    t = Trainer(W.train_func, W.opt_func, place=pt.CPUPlace())
    with pytest.raises(GangPoisonedError) as ei:
        t.train(num_epochs=1, reader=W.make_reader(3, nan_at=-1))
    assert ei.value.details["poison"]["rank"] == 1
    plane.monitor.poll_once()
    t.train(num_epochs=1, reader=W.make_reader(3, nan_at=-1))
    rep = t.goodput()
    assert rep["categories_s"]["barrier_wait"] > 0
    assert "straggler_est_s" not in rep  # one rank heartbeating: no lag
    fams = {f.name for f in t.metrics_registry().collect()}
    assert "gang_max_lag_steps" in fams


def test_step_hang_poisons_the_gang_after_the_bundle(tmp_path):
    """A watchdog hang verdict records the flight bundle, then poisons
    the gang for the peers (the plane's own poison is consumed)."""
    kv = FakeKv()
    plane = health.start_health_plane(rank=0, num_ranks=2, kv=kv,
                                      config=_quiet())
    t = Trainer(W.train_func, W.opt_func, place=pt.CPUPlace(),
                step_deadline_s=1.0)
    t.enable_alerts(rules=[], start=False,
                    flight_dir=str(tmp_path / "flight"))
    run = t.exe.run
    calls = []

    def wedged(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            chaos.hang(10)
        return run(*a, **k)

    t.exe.run = wedged
    with pytest.raises(StepHangError):
        t.train(num_epochs=1, reader=W.make_reader(4, nan_at=-1))
    poison = health.read_poison(kv)
    assert poison["kind"] == "step_hang" and poison["rank"] == 0
    assert poison["hang"]["what"] == "train step 0/2"
    assert os.listdir(str(tmp_path / "flight"))
    plane.monitor.poll_once()
    plane.check()  # the writer's own poison: born consumed
    t.stop()
