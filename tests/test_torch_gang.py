"""Real multi-process gangs of the port on the CPU: the counterparts of
tests/test_gang.py's chaos scenarios, with tests/torch_gang_worker.py's
ranks under the port's Supervisor (each rank a Trainer on its own
reader, the health plane started by init_distributed on the gang's
TCPStore).

- SIGKILL of a random rank at a random step, the store served by rank 0
  (the default): the survivor detects the loss (a structured
  PeerLostError naming the dead rank — for rank 0, through the store
  that died with it — exit 43), the supervisor relaunches once, every
  rank resumes from its newest valid serial, and each rank's final
  persistables equal BIT FOR BIT that rank's Trainer run uninterrupted
  in this process (the control); no orphan process is left.
- A checkpoint barrier with a poisoned peer fails in seconds against
  its 120 s timeout.
- SIGKILL of rank 0 — the rank that would host the store — under
  host_coordinator=True: rank 1 names rank 0 lost (not the store), and
  the relaunch finishes bit-exact too.
"""

from __future__ import annotations

import glob
import json
import os
import random
import sys
import time

import numpy as np
import pytest
import torch

import torch_gang_worker as G
from paddle_tpu_torch.resilience import (PEER_LOST_EXIT_CODE,
                                         GangFailedError, Supervisor, chaos)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_gang_worker.py")
INTERVAL_S, MISS_BUDGET = 0.25, 4


def _worker_cmd(d, *extra):
    return [sys.executable, WORKER, "--ckpt-root", os.path.join(d, "ck"),
            "--out-root", os.path.join(d, "out"),
            "--log-root", os.path.join(d, "log"), "--pace-s", "0.1", *extra]


def _gang_env():
    return {"FLAGS_heartbeat_interval_s": str(INTERVAL_S),
            "FLAGS_heartbeat_miss_budget": str(MISS_BUDGET)}


def _assert_no_orphans(tag):
    for proc in glob.glob("/proc/[0-9]*/cmdline"):
        try:
            with open(proc, "rb") as f:
                cmd = f.read().decode(errors="replace").replace("\0", " ")
        except OSError:
            continue
        assert tag not in cmd, f"orphan process survived: {cmd}"


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    """Each rank's Trainer run uninterrupted in this process."""
    tmp = str(tmp_path_factory.mktemp("ctl"))
    out = {}
    for rank in (0, 1):
        t = G.make_trainer(rank, tmp)
        t.train(num_epochs=1, reader=G.make_reader(rank))
        out[rank] = G.final_params(t)
        t.stop()
    return out


def _sigkill_gang(tmp, victim, host_coordinator):
    kill_at = random.Random(os.urandom(8)).randrange(2, 9)
    d = os.path.join(tmp, f"chaos{victim}")
    env = _gang_env()
    chaos.arm_kill_rank_env(env, rank=victim, at_step=kill_at,
                            once_file=os.path.join(d, "killed.flag"))
    os.makedirs(d, exist_ok=True)
    sup = Supervisor(_worker_cmd(d), 2, max_restarts=2, grace_s=8.0,
                     backoff_base_s=0.2, env=env,
                     host_coordinator=host_coordinator,
                     log_dir=os.path.join(d, "sup"), poll_s=0.05)
    result = sup.run()
    survivor = 1 - victim
    assert result.ok and result.restarts == 1, result.as_dict()
    a0 = result.attempts[0]
    assert a0["classified"][victim] == "signal:SIGKILL", a0
    assert a0["exit_codes"][survivor] == PEER_LOST_EXIT_CODE, a0
    assert a0["reason"] == "peer_lost", a0
    assert sup.backoffs_slept == [0.2]
    out = open(os.path.join(d, "sup", f"attempt0_rank{survivor}.out")).read()
    lines = [ln for ln in out.splitlines() if ln.startswith("PEER_LOST ")]
    assert lines, out
    payload = json.loads(lines[0][len("PEER_LOST "):])
    assert payload["error"] == "peer_lost"
    assert payload["missing_ranks"] == [victim], payload
    age = payload["age_s"]
    age = age[str(victim)] if isinstance(age, dict) else age
    # the loss verdict lands once the silence exceeds the miss window;
    # a loaded host may add polls (the reference's slack)
    assert INTERVAL_S * MISS_BUDGET <= age <= INTERVAL_S * MISS_BUDGET + 10
    # every rank resumed from its newest serial in attempt 1
    for rank in (0, 1):
        out1 = open(os.path.join(d, "sup", f"attempt1_rank{rank}.out")).read()
        assert "DONE" in out1, out1
    return d, kill_at


def _assert_bit_exact(d, control):
    for rank in (0, 1):
        got = np.load(os.path.join(d, "out", f"rank{rank}.npz"))
        want = control[rank]
        assert sorted(got.files) == sorted(want)
        for k in got.files:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), \
                f"rank{rank} {k} not bit-identical after the gang restart"
        with open(os.path.join(d, "out", f"rank{rank}.goodput.json")) as f:
            rep = json.load(f)
        cats = rep["categories_s"]
        assert abs(sum(cats.values()) - rep["wall_s"]) < 1e-3, rep
        assert cats["barrier_wait"] > 0.0, rep


def test_gang_sigkill_random_rank_bit_exact_restart(tmp_path, control):
    tmp = str(tmp_path)
    victim = random.Random(os.urandom(8)).randrange(2)
    d, _ = _sigkill_gang(tmp, victim, host_coordinator=False)
    _assert_bit_exact(d, control)
    _assert_no_orphans(tmp)


def test_barrier_with_poisoned_peer_fails_bounded(tmp_path):
    d = str(tmp_path)
    sup = Supervisor(_worker_cmd(d, "--mode", "barrier_poison"), 2,
                     max_restarts=0, grace_s=8.0, env=_gang_env(),
                     log_dir=os.path.join(d, "sup"), poll_s=0.05)
    try:
        sup.run()
        raise AssertionError("rank 1's deliberate exit(7) not seen")
    except GangFailedError as e:
        codes = e.details["attempts"][0]["exit_codes"]
        assert codes[1] == 7 and codes[0] == 0, codes
    out = open(os.path.join(d, "sup", "attempt0_rank0.out")).read()
    lines = [ln for ln in out.splitlines()
             if ln.startswith("BARRIER_POISONED ")]
    assert lines, out
    payload = json.loads(lines[0][len("BARRIER_POISONED "):])
    assert payload["error"] == "checkpoint_barrier_poisoned"
    assert payload["timeout_s"] == 120.0
    assert payload["elapsed_wall_s"] < 5.0, payload
    assert payload["poison"]["reason"].startswith("chaos:"), payload
    _assert_no_orphans(d)


def test_kill_rank0_with_the_supervisor_hosting_the_store(tmp_path,
                                                         control):
    """Rank 0 dies; the store lives on in the supervisor, so rank 1
    names rank 0 itself (no store error), and the relaunch resumes
    bit-exact."""
    tmp = str(tmp_path)
    d, _ = _sigkill_gang(tmp, 0, host_coordinator=True)
    out = open(os.path.join(d, "sup", "attempt0_rank1.out")).read()
    payload = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("PEER_LOST ")][0][10:])
    assert "kv_error" not in payload, payload
    _assert_bit_exact(d, control)
    _assert_no_orphans(tmp)
